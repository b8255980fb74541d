// Flash attention for prefill chunks (sm_90a).
//
// Replaces prima_tpu/ops/attention_pallas.py:_attn_kernel (entry
// flash_attention, s_q > 8): causal GQA attention of S query rows per
// batch row against the KV cache. The GQA group is folded into rows
// (row = g * S + s, head h = kvh * G + g); row r of batch b sees KV cell c
// iff c <= positions[b, 0] + r % S. Masked cells score -1e30;
// out = acc / max(l, 1e-30) in q's dtype.
//
// Bound on the H100: at prefill the operations, 4 * G * S * cells * D per
// (batch row, KV head), against K/V bytes read once: at the 8B shape a
// 256-row chunk folds 1024 rows per KV head and does 1024 operations per
// byte of bf16 cache, above the card's ~295 per byte for bf16 tensor
// cores, so the bound is the tensor cores' rate.
//
// Design, bf16 tensors (the serving path), `prefill_mma`:
//  * Tensor cores. Q.K^T and P.V are mma.sync.m16n8k16 bf16 products with
//    f32 accumulators. A block has 4 warps and 64 folded rows; a warp owns
//    16 rows, keeps their Q fragments in registers for the whole walk, and
//    reads K through ldmatrix and V through ldmatrix.trans from shared
//    memory. (wgmma, with a warpgroup owning all 64 rows, would read each
//    K/V tile from shared memory once instead of once per warp; its
//    descriptors and swizzled layouts are the next step for this kernel.)
//  * The softmax stays f32 in registers, in base 2 (the scale carries
//    log2 e): the row max is a shuffle over the quad that holds a row, the
//    row sum is kept per thread and reduced once at the end. P is rounded
//    to bf16 for P.V (<= 2^-9 relative per term, inside the bf16
//    tolerance); the accumulator stays f32.
//  * Asynchronous copies. K/V tiles of 64 cells go from the cache's
//    natural (B, T, KVH, D) layout and strides straight into bf16 shared
//    memory with 16-byte cp.async, two stages deep, so the next tile loads
//    while this one multiplies. The 16-byte chunks of a cell's row are
//    XOR-swizzled with the cell index so that ldmatrix reads eight rows
//    without a bank conflict. Cells at or past the row tile's last visible
//    cell are zero-filled by the copy (nothing is read there).
//  * A split of the KV axis: grid (B * KVH, row tiles, n_split). Split j
//    takes tiles j, j + n_split, ... (interleaved, so the work is even
//    wherever the positions lie); a split with no tile below the row
//    tile's last visible cell exits before reading. With n_split > 1 the
//    partial (m, l, acc) go to f32 scratch ((B*KVH, n_split, R, D) and
//    (..., 2)) and `prefill_combine` merges them; with n_split = 1 the
//    kernel writes the output itself.
//  * The mask only where it matters: a tile wholly below every position of
//    the warp's rows takes no compare.
//
// f32 tensors (`prefill_f32`) keep exact f32 FMAs on the CUDA cores from
// f32 shared-memory tiles of 32 cells, with the same KV split.
//
// The TPU kernel scans every KV block; these stop at the row tile's last
// visible cell, pos0 + max(r % S) over its rows. That is exact: cell 0 is
// visible to every row (positions >= 0), so m is finite after the first
// tile, and every later fully masked cell would only add
// exp(-1e30 - m) = 0 to l and acc. A split whose cells are all masked for
// some row carries m = -1e30 there, and the merge gives it weight 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RT = 64;              // folded query rows per block, both kernels
constexpr float NEG_INF = -1e30f;   // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;

// One past the last cell any row of the row tile [r0, r0 + nr) may see.
__device__ __forceinline__ int tile_end(int pos0, int r0, int nr, int S, int T_len) {
  const int s_first = r0 % S;
  const int max_s = s_first + nr - 1 >= S ? S - 1 : s_first + nr - 1;
  return min(T_len, pos0 + max_s + 1);
}

// ---------------------------------------------------------------------------
// f32 tensors: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;
constexpr int F_WARPS = F_THREADS / 32;
constexpr int F_TILE = 32;            // KV cells per tile: one per lane
constexpr int F_RPW = RT / F_WARPS;   // rows per warp in the score phase

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A warp owns 8 whole rows in the score phase and a lane one cell, so each K
// value read from shared memory feeds 8 FMAs and the row max and sum are
// warp shuffles; in the P.V phase a thread owns one column of 32 (or 16)
// rows in registers.
template <int D>
__global__ void __launch_bounds__(F_THREADS)
prefill_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int* __restrict__ pos,
            float* __restrict__ out, float* __restrict__ part_acc,
            float* __restrict__ part_ml, int S, int H, int KVH, int T_len,
            long long k_sb, long long k_st, long long v_sb, long long v_st,
            int n_split, int ra, float scale) {
  extern __shared__ float smem[];
  constexpr int P = D + 1;               // padded row: lanes hit distinct banks
  constexpr int CPR = D / 4;             // 16-byte chunks per cell row
  constexpr int RSTEP = F_THREADS / D;   // rows between a thread's columns
  constexpr int NACC = RT / RSTEP;

  const int bh = blockIdx.x, b = bh / KVH, kvh = bh % KVH;
  const int split = blockIdx.z;
  const int G = H / KVH, R = G * S;
  const int r0 = blockIdx.y * RT;
  const int nr = min(RT, R - r0);
  const int pos0 = pos[b * S];
  const int end = tile_end(pos0, r0, nr, S, T_len);
  if (split * F_TILE >= end) return;  // no tile of this split is visible

  float* qs = smem;                 // ra x D
  float* ks = qs + ra * D;          // F_TILE x P
  float* vs = ks + F_TILE * P;      // F_TILE x P
  float* ps = vs + F_TILE * P;      // ra x F_TILE
  float* al = ps + ra * F_TILE;     // ra: alpha per tile, then l at the end

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < nr * D; e += F_THREADS) {
    const int r = e / D, d = e % D;
    const int row = r0 + r, g = row / S, s = row % S;
    qs[r * D + d] = q[((long long)(b * S + s) * H + kvh * G + g) * D + d];
  }

  float m_r[F_RPW], l_r[F_RPW];
#pragma unroll
  for (int i = 0; i < F_RPW; ++i) { m_r[i] = NEG_INF; l_r[i] = 0.f; }
  const int dcol = tid % D, rbase = tid / D;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  const float* kb = k + b * k_sb + (long long)kvh * D;
  const float* vb = v + b * v_sb + (long long)kvh * D;
  for (int c0 = split * F_TILE; c0 < end; c0 += n_split * F_TILE) {
    __syncthreads();  // the previous tile's readers are done
    for (int ch = tid; ch < F_TILE * CPR; ch += F_THREADS) {
      const int c = ch / CPR, j = ch % CPR, cell = c0 + c;
      float4 fk = make_float4(0.f, 0.f, 0.f, 0.f), fv = fk;
      if (cell < end) {
        fk = *reinterpret_cast<const float4*>(kb + cell * k_st + j * 4);
        fv = *reinterpret_cast<const float4*>(vb + cell * v_st + j * 4);
      }
      float* kd = ks + c * P + j * 4;
      float* vd = vs + c * P + j * 4;
      kd[0] = fk.x; kd[1] = fk.y; kd[2] = fk.z; kd[3] = fk.w;
      vd[0] = fv.x; vd[1] = fv.y; vd[2] = fv.z; vd[3] = fv.w;
    }
    __syncthreads();

    // scores and the online softmax: warp w owns rows w, w + F_WARPS, ...
    const int cell = c0 + lane;
    float dot[F_RPW];
#pragma unroll
    for (int i = 0; i < F_RPW; ++i) dot[i] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float k0 = ks[lane * P + d], k1 = ks[lane * P + d + 1];
      const float k2 = ks[lane * P + d + 2], k3 = ks[lane * P + d + 3];
#pragma unroll
      for (int i = 0; i < F_RPW; ++i) {
        const int r = warp + F_WARPS * i;
        if (r < nr) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + d);
          dot[i] = fmaf(qv.x, k0, dot[i]);
          dot[i] = fmaf(qv.y, k1, dot[i]);
          dot[i] = fmaf(qv.z, k2, dot[i]);
          dot[i] = fmaf(qv.w, k3, dot[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < F_RPW; ++i) {
      const int r = warp + F_WARPS * i;
      if (r < nr) {
        const int qpos = pos0 + (r0 + r) % S;
        const float s = cell < end ? (cell <= qpos ? dot[i] * scale : NEG_INF)
                                   : -INFINITY;
        const float m_new = fmaxf(m_r[i], warp_max(s));
        const float p = expf(s - m_new);
        const float alpha = expf(m_r[i] - m_new);
        l_r[i] = l_r[i] * alpha + warp_sum(p);
        m_r[i] = m_new;
        ps[r * F_TILE + lane] = p;
        if (lane == 0) al[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V: thread owns column dcol of rows rbase + i * RSTEP
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int r = rbase + i * RSTEP;
      if (r < nr) {
        float a = acc[i] * al[r];
#pragma unroll 4
        for (int c = 0; c < F_TILE; c += 4) {
          const float4 pv = *reinterpret_cast<const float4*>(ps + r * F_TILE + c);
          a = fmaf(pv.x, vs[c * P + dcol], a);
          a = fmaf(pv.y, vs[(c + 1) * P + dcol], a);
          a = fmaf(pv.z, vs[(c + 2) * P + dcol], a);
          a = fmaf(pv.w, vs[(c + 3) * P + dcol], a);
        }
        acc[i] = a;
      }
    }
  }

  if (n_split > 1) {
    const long long base = ((long long)bh * n_split + split) * R + r0;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int r = rbase + i * RSTEP;
      if (r < nr) part_acc[(base + r) * D + dcol] = acc[i];
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < F_RPW; ++i) {
        const int r = warp + F_WARPS * i;
        if (r < nr) {
          part_ml[(base + r) * 2] = m_r[i];
          part_ml[(base + r) * 2 + 1] = l_r[i];
        }
      }
    }
    return;
  }
  __syncthreads();  // every reader of al is done: it now carries l
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < F_RPW; ++i) {
      const int r = warp + F_WARPS * i;
      if (r < nr) al[r] = l_r[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int r = rbase + i * RSTEP;
    if (r < nr) {
      const int row = r0 + r, g = row / S, s = row % S;
      out[((long long)(b * S + s) * H + kvh * G + g) * D + dcol] =
          acc[i] / fmaxf(al[r], 1e-30f);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensors: tensor cores
// ---------------------------------------------------------------------------

constexpr int M_THREADS = 128;      // 4 warps of 16 rows
constexpr int M_TILE = 64;          // KV cells per tile
constexpr int M_STAGES = 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// In the mma fragments lane = 4 * g + t: a thread holds rows g and g + 8 of
// its warp's 16, and of every 8 columns the pair 2t, 2t + 1.
template <int D>
__global__ void __launch_bounds__(M_THREADS, 2)
prefill_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos,
            __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
            float* __restrict__ part_ml, int S, int H, int KVH, int T_len,
            long long k_sb, long long k_st, long long v_sb, long long v_st,
            int n_split, float scale_log2) {
  extern __shared__ __align__(128) unsigned char tiles[];
  constexpr int ROWB = D * 2;                 // bytes of one cell's row
  constexpr int CPR = ROWB / 16;              // 16-byte chunks per row
  constexpr int TILE_BYTES = M_TILE * ROWB;   // one K or V tile
  constexpr int KSTEPS = D / 16;              // k-steps of Q.K^T
  constexpr int NB = M_TILE / 8;              // score blocks of 8 cells
  constexpr int DB = D / 8;                   // output blocks of 8 columns
  constexpr int LOADS = M_TILE * CPR / M_THREADS;

  const int bh = blockIdx.x, b = bh / KVH, kvh = bh % KVH;
  const int split = blockIdx.z;
  const int G = H / KVH, R = G * S;
  const int r0 = blockIdx.y * RT;
  const int nr = min(RT, R - r0);
  const int pos0 = pos[b * S];
  const int end = tile_end(pos0, r0, nr, S, T_len);
  const int n_tiles = (end + M_TILE - 1) / M_TILE;
  if (split >= n_tiles) return;  // no tile of this split is visible
  const int my_tiles = (n_tiles - split + n_split - 1) / n_split;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t tiles_u32 = smem_u32(tiles);
  const __nv_bfloat16* kb = k + b * k_sb + (long long)kvh * D;
  const __nv_bfloat16* vb = v + b * v_sb + (long long)kvh * D;

  auto load_tile = [&](int i) {
    const int c0 = (split + i * n_split) * M_TILE;
    const uint32_t kdst = tiles_u32 + (i % M_STAGES) * 2 * TILE_BYTES;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int ch = tid + j * M_THREADS, c = ch / CPR, x = ch % CPR;
      const int cell = c0 + c;
      const int ok = cell < end ? 16 : 0;
      const long long at = ok ? cell : 0;  // a readable address either way
      const uint32_t off = c * ROWB + ((x ^ (c & 7)) << 4);
      cp_async16(kdst + off, kb + at * k_st + x * 8, ok);
      cp_async16(kdst + TILE_BYTES + off, vb + at * v_st + x * 8, ok);
    }
  };
  load_tile(0);
  cp_async_commit();

  // this thread's two rows, their positions, and their Q fragments
  const int rl = r0 + warp * 16 + g, rh = rl + 8;
  const bool vl = rl < R, vh = rh < R;
  const int big = 0x3fffffff;
  const int qpos_l = vl ? pos0 + rl % S : big, qpos_h = vh ? pos0 + rh % S : big;
  const int warp_min_qpos = __reduce_min_sync(0xffffffffu, min(qpos_l, qpos_h));
  uint32_t qa[KSTEPS][4];
  {
    const __nv_bfloat16* ql =
        q + ((long long)(b * S + (vl ? rl % S : 0)) * H + kvh * G + (vl ? rl / S : 0)) * D;
    const __nv_bfloat16* qh =
        q + ((long long)(b * S + (vh ? rh % S : 0)) * H + kvh * G + (vh ? rh / S : 0)) * D;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int d0 = kk * 16 + 2 * t;
      qa[kk][0] = vl ? *reinterpret_cast<const uint32_t*>(ql + d0) : 0u;
      qa[kk][1] = vh ? *reinterpret_cast<const uint32_t*>(qh + d0) : 0u;
      qa[kk][2] = vl ? *reinterpret_cast<const uint32_t*>(ql + d0 + 8) : 0u;
      qa[kk][3] = vh ? *reinterpret_cast<const uint32_t*>(qh + d0 + 8) : 0u;
    }
  }

  float o[DB][4];
#pragma unroll
  for (int i = 0; i < DB; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_l = NEG_INF, m_h = NEG_INF, l_l = 0.f, l_h = 0.f;

  // ldmatrix lane roles: lane supplies the row address of matrix lane / 8
  const int lm = lane >> 3, lr = lane & 7;

  for (int i = 0; i < my_tiles; ++i) {
    if (i + 1 < my_tiles) load_tile(i + 1);  // its stage was released at the end of i - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int c0 = (split + i * n_split) * M_TILE;
    const uint32_t ks = tiles_u32 + (i % M_STAGES) * 2 * TILE_BYTES;
    const uint32_t vs = ks + TILE_BYTES;

    // scores: 16 rows x 64 cells
    float sc[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        // matrices: (cells 0-7, d 0-7), (cells 0-7, d 8-15), (cells 8-15, d 0-7),
        // (cells 8-15, d 8-15) of this 16-cell, 16-column step
        const int cell = n2 * 16 + (lm >> 1) * 8 + lr;
        const int chunk = 2 * kk + (lm & 1);
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + cell * ROWB + ((chunk ^ (cell & 7)) << 4));
        mma_bf16(sc[2 * n2], qa[kk], kf[0], kf[1]);
        mma_bf16(sc[2 * n2 + 1], qa[kk], kf[2], kf[3]);
      }
    }

    // scale, mask (only where the tile crosses a position or the end), row max
    const bool need_mask = c0 + M_TILE - 1 > warp_min_qpos || c0 + M_TILE > end;
    float mx_l = -INFINITY, mx_h = -INFINITY;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[n][e] * scale_log2;
        if (need_mask) {
          const int cell = c0 + n * 8 + 2 * t + (e & 1);
          const int qp = e < 2 ? qpos_l : qpos_h;
          s = cell < end ? (cell <= qp ? s : NEG_INF) : -INFINITY;
        }
        sc[n][e] = s;
        if (e < 2) mx_l = fmaxf(mx_l, s); else mx_h = fmaxf(mx_h, s);
      }
    }
    const float mn_l = fmaxf(m_l, quad_max(mx_l)), mn_h = fmaxf(m_h, quad_max(mx_h));
    const float al_l = exp2f(m_l - mn_l), al_h = exp2f(m_h - mn_h);
    m_l = mn_l; m_h = mn_h;
    float sum_l = 0.f, sum_h = 0.f;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      sc[n][0] = exp2f(sc[n][0] - mn_l); sc[n][1] = exp2f(sc[n][1] - mn_l);
      sc[n][2] = exp2f(sc[n][2] - mn_h); sc[n][3] = exp2f(sc[n][3] - mn_h);
      sum_l += sc[n][0] + sc[n][1];
      sum_h += sc[n][2] + sc[n][3];
    }
    l_l = l_l * al_l + sum_l;
    l_h = l_h * al_h + sum_h;
#pragma unroll
    for (int i2 = 0; i2 < DB; ++i2) {
      o[i2][0] *= al_l; o[i2][1] *= al_l; o[i2][2] *= al_h; o[i2][3] *= al_h;
    }

    // o += P . V, P rounded to bf16 from the score registers
#pragma unroll
    for (int kk = 0; kk < M_TILE / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < DB / 2; ++d2) {
        // matrices: (cells 0-7, d 0-7), (cells 8-15, d 0-7), (cells 0-7, d 8-15),
        // (cells 8-15, d 8-15), each transposed on the way in
        const int cell = kk * 16 + (lm & 1) * 8 + lr;
        const int chunk = 2 * d2 + (lm >> 1);
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + cell * ROWB + ((chunk ^ (cell & 7)) << 4));
        mma_bf16(o[2 * d2], pa, vf[0], vf[1]);
        mma_bf16(o[2 * d2 + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage may be overwritten by the next load
  }

  l_l = quad_sum(l_l);
  l_h = quad_sum(l_h);
  if (n_split > 1) {
    const long long base = ((long long)bh * n_split + split) * R;
#pragma unroll
    for (int i = 0; i < DB; ++i) {
      if (vl) *reinterpret_cast<float2*>(part_acc + (base + rl) * D + i * 8 + 2 * t) =
          make_float2(o[i][0], o[i][1]);
      if (vh) *reinterpret_cast<float2*>(part_acc + (base + rh) * D + i * 8 + 2 * t) =
          make_float2(o[i][2], o[i][3]);
    }
    if (t == 0) {
      if (vl) *reinterpret_cast<float2*>(part_ml + (base + rl) * 2) = make_float2(m_l, l_l);
      if (vh) *reinterpret_cast<float2*>(part_ml + (base + rh) * 2) = make_float2(m_h, l_h);
    }
    return;
  }
  const float inv_l = 1.f / fmaxf(l_l, 1e-30f), inv_h = 1.f / fmaxf(l_h, 1e-30f);
  __nv_bfloat16* ol =
      out + ((long long)(b * S + (vl ? rl % S : 0)) * H + kvh * G + (vl ? rl / S : 0)) * D;
  __nv_bfloat16* oh =
      out + ((long long)(b * S + (vh ? rh % S : 0)) * H + kvh * G + (vh ? rh / S : 0)) * D;
#pragma unroll
  for (int i = 0; i < DB; ++i) {
    if (vl) *reinterpret_cast<__nv_bfloat162*>(ol + i * 8 + 2 * t) =
        __floats2bfloat162_rn(o[i][0] * inv_l, o[i][1] * inv_l);
    if (vh) *reinterpret_cast<__nv_bfloat162*>(oh + i * 8 + 2 * t) =
        __floats2bfloat162_rn(o[i][2] * inv_h, o[i][3] * inv_h);
  }
}

// ---------------------------------------------------------------------------
// merge of the splits
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One (batch row, KV head, row) per block, D threads. The splits that had a
// visible tile are merged in the order of their index. LOG2: the partial m
// are in base 2 (the tensor-core kernel), else in base e.
template <typename T, int D, bool LOG2>
__global__ void __launch_bounds__(D)
prefill_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                const int* __restrict__ pos, T* __restrict__ out, int S, int H,
                int KVH, int T_len, int tile, int n_split) {
  const int bh = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int b = bh / KVH, kvh = bh % KVH;
  const int G = H / KVH, R = G * S;
  const int r0 = r / RT * RT;
  const int end = tile_end(pos[b * S], r0, min(RT, R - r0), S, T_len);
  const int n_act = min(n_split, (end + tile - 1) / tile);
  float m = NEG_INF;
  for (int j = 0; j < n_act; ++j)
    m = fmaxf(m, part_ml[(((long long)bh * n_split + j) * R + r) * 2]);
  float l = 0.f, o = 0.f;
  for (int j = 0; j < n_act; ++j) {
    const long long at = ((long long)bh * n_split + j) * R + r;
    const float dm = part_ml[at * 2] - m;
    const float w = LOG2 ? exp2f(dm) : expf(dm);
    l = fmaf(part_ml[at * 2 + 1], w, l);
    o = fmaf(part_acc[at * D + d], w, o);
  }
  const int g = r / S, s = r % S;
  store_out(out + ((long long)(b * S + s) * H + kvh * G + g) * D + d,
            o / fmaxf(l, 1e-30f));
}

template <typename K>
int allow_smem(K kernel, size_t smem, size_t* set) {
  if (smem <= *set) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *set = smem;
  return (int)e;
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, const int* pos,
               float* out, float* part_acc, float* part_ml, int B, int S, int H,
               int KVH, int T_len, long long k_sb, long long k_st, long long v_sb,
               long long v_st, int n_split, float scale, cudaStream_t st) {
  const int R = (H / KVH) * S;
  const int ra = R < RT ? R : RT;
  const int n_rt = (R + RT - 1) / RT;
  const size_t smem =
      (size_t)(ra * D + 2 * F_TILE * (D + 1) + ra * F_TILE + ra) * sizeof(float);
  static size_t smem_set = 48 * 1024;  // the default limit for dynamic smem
  const int e = allow_smem(prefill_f32<D>, smem, &smem_set);
  if (e) return e;
  prefill_f32<D><<<dim3(B * KVH, n_rt, n_split), F_THREADS, smem, st>>>(
      q, k, v, pos, out, part_acc, part_ml, S, H, KVH, T_len, k_sb, k_st, v_sb, v_st,
      n_split, ra, scale);
  if (n_split > 1)
    prefill_combine<float, D, false><<<dim3(B * KVH, R), D, 0, st>>>(
        part_acc, part_ml, pos, out, S, H, KVH, T_len, F_TILE, n_split);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                const int* pos, __nv_bfloat16* out, float* part_acc, float* part_ml,
                int B, int S, int H, int KVH, int T_len, long long k_sb, long long k_st,
                long long v_sb, long long v_st, int n_split, float scale,
                cudaStream_t st) {
  const int R = (H / KVH) * S;
  const int n_rt = (R + RT - 1) / RT;
  const size_t smem = (size_t)M_STAGES * 2 * M_TILE * D * 2;
  static size_t smem_set = 48 * 1024;
  const int e = allow_smem(prefill_mma<D>, smem, &smem_set);
  if (e) return e;
  prefill_mma<D><<<dim3(B * KVH, n_rt, n_split), M_THREADS, smem, st>>>(
      q, k, v, pos, out, part_acc, part_ml, S, H, KVH, T_len, k_sb, k_st, v_sb, v_st,
      n_split, scale * LOG2E);
  if (n_split > 1)
    prefill_combine<__nv_bfloat16, D, true><<<dim3(B * KVH, R), D, 0, st>>>(
        part_acc, part_ml, pos, out, S, H, KVH, T_len, M_TILE, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, D) contiguous; k, v (B, T, KVH, D) with element strides
// (k_sb, k_st) / (v_sb, v_st) for the batch and cell axes, KVH and D
// contiguous; pos (B, S) int32 on the device; out like q. bf16 = 1 for
// bfloat16 tensors (tensor cores), 0 for float32 (CUDA cores). n_split >= 1
// splits the KV axis; above 1 it needs the f32 scratch part_acc
// (B*KVH, n_split, R, D) and part_ml (B*KVH, n_split, R, 2), R = (H/KVH)*S.
// Returns cudaGetLastError().
extern "C" int prima_flash_prefill(const void* q, const void* k, const void* v,
                                   const int* pos, void* out, float* part_acc,
                                   float* part_ml, int bf16, int D, int B, int S, int H,
                                   int KVH, int T, long long k_sb, long long k_st,
                                   long long v_sb, long long v_st, int n_split,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || (n_split > 1 && (!part_acc || !part_ml)))
    return (int)cudaErrorInvalidValue;
#define PRIMA_FA(FN, TYPE, DIM)                                                     \
  return FN<DIM>(static_cast<const TYPE*>(q), static_cast<const TYPE*>(k),         \
                 static_cast<const TYPE*>(v), pos, static_cast<TYPE*>(out),         \
                 part_acc, part_ml, B, S, H, KVH, T, k_sb, k_st, v_sb, v_st,        \
                 n_split, scale, st)
  if (bf16 && D == 128) PRIMA_FA(launch_bf16, __nv_bfloat16, 128);
  if (bf16 && D == 64) PRIMA_FA(launch_bf16, __nv_bfloat16, 64);
  if (!bf16 && D == 128) PRIMA_FA(launch_f32, float, 128);
  if (!bf16 && D == 64) PRIMA_FA(launch_f32, float, 64);
#undef PRIMA_FA
  return (int)cudaErrorInvalidValue;
}
