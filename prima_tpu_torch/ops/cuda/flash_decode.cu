// Split-K flash-decoding attention over the KV cache (sm_90a).
//
// Replaces prima_tpu/ops/attention_pallas.py:_decode_kernel (entry
// flash_decode): causal GQA attention for s_q <= 8 query rows per batch
// row. The GQA group is folded into rows (row = g * S + s, head
// h = kvh * G + g); row r of batch b sees KV cell c iff
// c <= positions[b, 0] + r % S, and only cells below
// nblk * kv_blk are read, nblk = clip(ceil((pos_last + 1) / kv_blk), 1,
// T / kv_blk). Scores, softmax and P.V are f32; masked cells score -1e30;
// out = acc / max(l, 1e-30) in q's dtype.
//
// Bound on the H100: device-memory bytes. Each (batch row, KV head) reads
// its visible K and V cells once (at the 8B shape, B = 4 near position
// 4000 in bf16, 65 MB a layer against ~4 KB of q and output), and the
// operations, 4 * rows * cells * D, are ~2 per byte at 4 rows.
//
// Design: grid (B * KVH, n_split, row tiles). At the 8B shape B * KVH is
// 32, a quarter of the 132 SMs, so the T axis is split into chunks of
// split_len cells and every block runs an online softmax over its chunk;
// a second kernel merges the chunks' (m, l, acc) from f32 scratch. Each
// block reads the positions from the device tensor (no host sync) and a
// chunk wholly past the last visible cell exits at once, so only the
// visible prefix streams. K/V tiles of 32 cells are read with 16-byte
// loads from the cache's natural (B, T, KVH, D) layout and its batch and
// cell strides (the engine hands in a one-slot view of the full cache);
// the next tile's loads are issued into registers before the current
// tile is computed, so the memory stream does not stop for the math, and
// each tile is then converted to f32 in shared memory. In the score phase
// a warp owns whole rows and a lane one cell, so the tile's row max and
// sum are warp shuffles; in the P.V phase a thread owns one column d of
// several rows, held in registers across the tiles. The row tile is the
// smallest of 8, 16 and 32 that holds the folded rows (the 8B decode step
// has 4), so a small step does not reserve registers for rows it does not
// have. Cells
// past the last visible one are not read at all: cell 0 is always visible
// (positions >= 0), so a chunk of masked cells would only add
// exp(-1e30 - m) = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;              // KV cells per tile: one per lane
constexpr float NEG_INF = -1e30f;     // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 loaded bytes of the cache -> f32
__device__ __forceinline__ void to_f32x(const uint4& v, float* o, float) {
  const float4 f = *reinterpret_cast<const float4*>(&v);
  o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
}
__device__ __forceinline__ void to_f32x(const uint4& v, float* o, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

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

// One past the last cell any row of batch row b may see: the TPU kernel's
// block limit nblk * kv_blk, cut at the last query position pos0 + S - 1
// (cells past it are masked for every row).
__device__ __forceinline__ int visible_end(const int* pos, int b, int S, int T,
                                           int kv_blk) {
  const int pos0 = pos[b * S];
  const int pos_last = pos[b * S + S - 1];
  int nblk = (pos_last + kv_blk) / kv_blk;
  const int max_blk = T / kv_blk;
  nblk = nblk < 1 ? 1 : (nblk > max_blk ? max_blk : nblk);
  const int lim = nblk * kv_blk;
  const int last = pos0 + S;
  return last < lim ? last : lim;
}

template <typename T, int D, int RT>
__global__ void __launch_bounds__(THREADS)
decode_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ pos,
             float* __restrict__ part_acc, float* __restrict__ part_ml, int S,
             int H, int KVH, int T_len, long long k_sb, long long k_st,
             long long v_sb, long long v_st, int kv_blk, int split_len,
             int n_split, int ra, float scale) {
  extern __shared__ float smem[];
  constexpr int P = D + 1;               // padded row: lanes hit distinct banks
  constexpr int VN = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int CPR = D / VN;            // 16-byte chunks per cell row
  constexpr int RSTEP = THREADS / D;     // rows between a thread's columns
  constexpr int NACC = RT / RSTEP;
  constexpr int RPW = RT / WARPS;        // rows per warp in the score phase
  constexpr int NCH = TILE * CPR / THREADS;  // 16-byte loads a thread, per tile

  const int bh = blockIdx.x, b = bh / KVH, kvh = bh % KVH;
  const int split = blockIdx.y;
  const int G = H / KVH, R = G * S;
  const int r0 = blockIdx.z * RT;
  const int nr = min(RT, R - r0);
  const int end = visible_end(pos, b, S, T_len, kv_blk);
  const int c_begin = split * split_len;
  if (c_begin >= end) return;
  const int c_end = min(c_begin + split_len, end);
  const int pos0 = pos[b * S];

  float* qs = smem;                 // ra x D
  float* ks = qs + ra * D;          // TILE x P
  float* vs = ks + TILE * P;        // TILE x P
  float* ps = vs + TILE * P;        // ra x TILE
  float* al = ps + ra * TILE;       // ra

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < nr * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int row = r0 + r, g = row / S, s = row % S;
    qs[r * D + d] = to_f32(q[((long long)(b * S + s) * H + kvh * G + g) * D + d]);
  }

  float m_r[RPW], l_r[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) { m_r[i] = NEG_INF; l_r[i] = 0.f; }
  const int dcol = tid % D, rbase = tid / D;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  const T* kb = k + b * k_sb + (long long)kvh * D;
  const T* vb = v + b * v_sb + (long long)kvh * D;
  uint4 rk[NCH], rv[NCH];  // the next tile, in flight
  auto fetch = [&](int c0) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int ch = tid + i * THREADS, cell = c0 + ch / CPR, j = ch % CPR;
      if (cell < c_end) {
        rk[i] = *reinterpret_cast<const uint4*>(kb + cell * k_st + j * VN);
        rv[i] = *reinterpret_cast<const uint4*>(vb + cell * v_st + j * VN);
      } else {
        rk[i] = make_uint4(0, 0, 0, 0);  // zeros: p = 0 must not meet NaN
        rv[i] = make_uint4(0, 0, 0, 0);
      }
    }
  };
  fetch(c_begin);
  for (int c0 = c_begin; c0 < c_end; c0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int ch = tid + i * THREADS, c = ch / CPR, j = ch % CPR;
      float fk[VN], fv[VN];
      to_f32x(rk[i], fk, T());
      to_f32x(rv[i], fv, T());
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        ks[c * P + j * VN + e] = fk[e];
        vs[c * P + j * VN + e] = fv[e];
      }
    }
    __syncthreads();
    if (c0 + TILE < c_end) fetch(c0 + TILE);

    // scores and the online softmax: warp w owns rows w, w + WARPS, ...
    const int cell = c0 + lane;
    float dot[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) dot[i] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float k0 = ks[lane * P + d], k1 = ks[lane * P + d + 1];
      const float k2 = ks[lane * P + d + 2], k3 = ks[lane * P + d + 3];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + WARPS * i;
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
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + WARPS * i;
      if (r < nr) {
        const int qpos = pos0 + (r0 + r) % S;
        const float s = cell < c_end ? (cell <= qpos ? dot[i] * scale : NEG_INF)
                                     : -INFINITY;
        const float m_new = fmaxf(m_r[i], warp_max(s));
        const float p = expf(s - m_new);
        const float alpha = expf(m_r[i] - m_new);
        l_r[i] = l_r[i] * alpha + warp_sum(p);
        m_r[i] = m_new;
        ps[r * TILE + lane] = p;
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
        for (int c = 0; c < TILE; c += 4) {
          const float4 pv = *reinterpret_cast<const float4*>(ps + r * TILE + c);
          a = fmaf(pv.x, vs[c * P + dcol], a);
          a = fmaf(pv.y, vs[(c + 1) * P + dcol], a);
          a = fmaf(pv.z, vs[(c + 2) * P + dcol], a);
          a = fmaf(pv.w, vs[(c + 3) * P + dcol], a);
        }
        acc[i] = a;
      }
    }
  }

  const long long base = ((long long)bh * n_split + split) * R + r0;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int r = rbase + i * RSTEP;
    if (r < nr) part_acc[(base + r) * D + dcol] = acc[i];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + WARPS * i;
      if (r < nr) {
        part_ml[(base + r) * 2] = m_r[i];
        part_ml[(base + r) * 2 + 1] = l_r[i];
      }
    }
  }
}

// Merge the chunks of one (batch row, KV head, row): block (bh, r), D threads.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               const int* __restrict__ pos, T* __restrict__ out, int S, int H,
               int KVH, int T_len, int kv_blk, int split_len, int n_split) {
  const int bh = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int b = bh / KVH, kvh = bh % KVH;
  const int G = H / KVH, R = G * S;
  const int end = visible_end(pos, b, S, T_len, kv_blk);
  int n_act = (end + split_len - 1) / split_len;
  n_act = n_act < 0 ? 0 : (n_act > n_split ? n_split : n_act);
  float m = NEG_INF;
  for (int j = 0; j < n_act; ++j)
    m = fmaxf(m, part_ml[(((long long)bh * n_split + j) * R + r) * 2]);
  float l = 0.f, o = 0.f;
  for (int j = 0; j < n_act; ++j) {
    const long long at = ((long long)bh * n_split + j) * R + r;
    const float w = expf(part_ml[at * 2] - m);
    l = fmaf(part_ml[at * 2 + 1], w, l);
    o = fmaf(part_acc[at * D + d], w, o);
  }
  const int g = r / S, s = r % S;
  store_out(out + ((long long)(b * S + s) * H + kvh * G + g) * D + d,
            o / fmaxf(l, 1e-30f));
}

template <typename T, int D, int RT>
int launch_split(const void* q, const void* k, const void* v, const int* pos,
                 float* part_acc, float* part_ml, int B, int S, int H, int KVH,
                 int T_len, long long k_sb, long long k_st, long long v_sb,
                 long long v_st, int kv_blk, int split_len, int n_split, float scale,
                 cudaStream_t st) {
  const int R = (H / KVH) * S;
  const int ra = R < RT ? R : RT;
  const int n_rt = (R + RT - 1) / RT;
  const size_t smem = (size_t)(ra * D + 2 * TILE * (D + 1) + ra * TILE + ra) * sizeof(float);
  static size_t smem_set = 48 * 1024;  // the default limit for dynamic smem
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split<T, D, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  decode_split<T, D, RT><<<dim3(B * KVH, n_split, n_rt), THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pos, part_acc, part_ml, S, H, KVH, T_len, k_sb, k_st, v_sb, v_st, kv_blk,
      split_len, n_split, ra, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out,
           float* part_acc, float* part_ml, int B, int S, int H, int KVH, int T_len,
           long long k_sb, long long k_st, long long v_sb, long long v_st,
           int kv_blk, int split_len, int n_split, float scale, cudaStream_t st) {
  const int R = (H / KVH) * S;
#define PRIMA_SPLIT(RT)                                                            \
  launch_split<T, D, RT>(q, k, v, pos, part_acc, part_ml, B, S, H, KVH, T_len, k_sb, \
                         k_st, v_sb, v_st, kv_blk, split_len, n_split, scale, st)
  const int e = R <= 8 ? PRIMA_SPLIT(8) : R <= 16 ? PRIMA_SPLIT(16) : PRIMA_SPLIT(32);
#undef PRIMA_SPLIT
  if (e != (int)cudaSuccess) return e;
  decode_combine<T, D><<<dim3(B * KVH, R), D, 0, st>>>(
      part_acc, part_ml, pos, static_cast<T*>(out), S, H, KVH, T_len, kv_blk,
      split_len, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, D) contiguous; k, v (B, T, KVH, D) with element strides
// (k_sb, k_st) / (v_sb, v_st) for the batch and cell axes, KVH and D
// contiguous; pos (B, S) int32 on the device; out like q; scratch
// part_acc (B*KVH, n_split, R, D) and part_ml (B*KVH, n_split, R, 2) f32.
// bf16 = 1 for bfloat16 tensors, 0 for float32. Returns cudaGetLastError().
extern "C" int prima_flash_decode(const void* q, const void* k, const void* v,
                                  const int* pos, void* out, float* part_acc,
                                  float* part_ml, int bf16, int D, int B, int S,
                                  int H, int KVH, int T, long long k_sb,
                                  long long k_st, long long v_sb, long long v_st,
                                  int kv_blk, int split_len, int n_split,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRIMA_FD(TYPE, DIM)                                                        \
  return launch<TYPE, DIM>(q, k, v, pos, out, part_acc, part_ml, B, S, H, KVH, T, \
                           k_sb, k_st, v_sb, v_st, kv_blk, split_len, n_split,    \
                           scale, st)
  if (bf16 && D == 128) PRIMA_FD(__nv_bfloat16, 128);
  if (bf16 && D == 64) PRIMA_FD(__nv_bfloat16, 64);
  if (!bf16 && D == 128) PRIMA_FD(float, 128);
  if (!bf16 && D == 64) PRIMA_FD(float, 64);
#undef PRIMA_FD
  return (int)cudaErrorInvalidValue;
}
