// Flash attention for prefill chunks (sm_90a).
//
// Replaces prima_tpu/ops/attention_pallas.py:_attn_kernel (entry
// flash_attention, s_q > 8): causal GQA attention of S query rows per
// batch row against the KV cache. The GQA group is folded into rows
// (row = g * S + s, head h = kvh * G + g); row r of batch b sees KV cell c
// iff c <= positions[b, 0] + r % S. Scores, softmax and P.V are f32;
// masked cells score -1e30; out = acc / max(l, 1e-30) in q's dtype.
//
// Bound on the H100: at prefill the operations, 4 * G * S * cells * D per
// (batch row, KV head), against K/V bytes read once: at the 8B shape a
// 256-row chunk folds 1024 rows per KV head and does 1024 operations per
// byte of bf16 cache, above the card's ~295 per byte for bf16 tensor
// cores, so the bound is the operation rate. This kernel runs them as f32 FMAs on the CUDA cores
// (67 TFLOP/s peak); tensor cores are a later step.
//
// Design: grid (B * KVH, tiles of 64 folded rows), 256 threads. A block
// stages its 64 query rows in shared memory, then walks the KV cells in
// tiles of 32, each loaded with 16-byte reads from the cache's natural
// (B, T, KVH, D) layout and its batch and cell strides (no transpose
// copy, unlike the TPU wrapper), converted to f32 in shared memory. In
// the score phase a warp owns 8 whole rows and a lane one cell, so each K
// value read from shared memory feeds 8 FMAs and the row max and sum of
// the online softmax are warp shuffles; in the P.V phase a thread owns one
// column of 32 (or 16) rows in registers, and each V value feeds all of
// them. The TPU kernel scans every KV block; this one stops at the row
// tile's last visible cell, pos0 + max(r % S) over its rows. That is
// exact: cell 0 is visible to every row (positions >= 0), so m is finite
// after the first tile, and every later fully masked cell would only add
// exp(-1e30 - m) = 0 to l and acc.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;            // KV cells per tile: one per lane
constexpr int RT = 64;              // folded query rows per block
constexpr int RPW = RT / WARPS;     // rows per warp in the score phase
constexpr float NEG_INF = -1e30f;   // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ pos,
               T* __restrict__ out, int S, int H, int KVH, int T_len,
               long long k_sb, long long k_st, long long v_sb, long long v_st,
               int ra, float scale) {
  extern __shared__ float smem[];
  constexpr int P = D + 1;               // padded row: lanes hit distinct banks
  constexpr int VN = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int CPR = D / VN;            // 16-byte chunks per cell row
  constexpr int RSTEP = THREADS / D;     // rows between a thread's columns
  constexpr int NACC = RT / RSTEP;

  const int bh = blockIdx.x, b = bh / KVH, kvh = bh % KVH;
  const int G = H / KVH, R = G * S;
  const int r0 = blockIdx.y * RT;
  const int nr = min(RT, R - r0);
  const int pos0 = pos[b * S];
  // the largest query position among this tile's rows
  const int s_first = r0 % S;
  const int max_s = s_first + nr - 1 >= S ? S - 1 : s_first + nr - 1;
  const int end = min(T_len, pos0 + max_s + 1);

  float* qs = smem;                 // ra x D
  float* ks = qs + ra * D;          // TILE x P
  float* vs = ks + TILE * P;        // TILE x P
  float* ps = vs + TILE * P;        // ra x TILE
  float* al = ps + ra * TILE;       // ra: alpha per tile, then l at the end

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
  for (int c0 = 0; c0 < end; c0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    for (int ch = tid; ch < TILE * CPR; ch += THREADS) {
      const int c = ch / CPR, j = ch % CPR, cell = c0 + c;
      float fk[VN], fv[VN];
      if (cell < end) {
        load16(kb + cell * k_st + j * VN, fk);
        load16(vb + cell * v_st + j * VN, fv);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) { fk[i] = 0.f; fv[i] = 0.f; }
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        ks[c * P + j * VN + i] = fk[i];
        vs[c * P + j * VN + i] = fv[i];
      }
    }
    __syncthreads();

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
        const float s = cell < end ? (cell <= qpos ? dot[i] * scale : NEG_INF)
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

  __syncthreads();  // every reader of al is done: it now carries l
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + WARPS * i;
      if (r < nr) al[r] = l_r[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int r = rbase + i * RSTEP;
    if (r < nr) {
      const int row = r0 + r, g = row / S, s = row % S;
      store_out(out + ((long long)(b * S + s) * H + kvh * G + g) * D + dcol,
                acc[i] / fmaxf(al[r], 1e-30f));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out,
           int B, int S, int H, int KVH, int T_len, long long k_sb, long long k_st,
           long long v_sb, long long v_st, float scale, cudaStream_t st) {
  const int R = (H / KVH) * S;
  const int ra = R < RT ? R : RT;
  const int n_rt = (R + RT - 1) / RT;
  const size_t smem = (size_t)(ra * D + 2 * TILE * (D + 1) + ra * TILE + ra) * sizeof(float);
  static size_t smem_set = 48 * 1024;  // the default limit for dynamic smem
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  prefill_kernel<T, D><<<dim3(B * KVH, n_rt), THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pos, static_cast<T*>(out), S, H, KVH, T_len, k_sb, k_st, v_sb, v_st, ra, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, D) contiguous; k, v (B, T, KVH, D) with element strides
// (k_sb, k_st) / (v_sb, v_st) for the batch and cell axes, KVH and D
// contiguous; pos (B, S) int32 on the device; out like q. bf16 = 1 for
// bfloat16 tensors, 0 for float32. Returns cudaGetLastError().
extern "C" int prima_flash_prefill(const void* q, const void* k, const void* v,
                                   const int* pos, void* out, int bf16, int D, int B,
                                   int S, int H, int KVH, int T, long long k_sb,
                                   long long k_st, long long v_sb, long long v_st,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRIMA_FA(TYPE, DIM)                                                       \
  return launch<TYPE, DIM>(q, k, v, pos, out, B, S, H, KVH, T, k_sb, k_st, v_sb, \
                           v_st, scale, st)
  if (bf16 && D == 128) PRIMA_FA(__nv_bfloat16, 128);
  if (bf16 && D == 64) PRIMA_FA(__nv_bfloat16, 64);
  if (!bf16 && D == 128) PRIMA_FA(float, 128);
  if (!bf16 && D == 64) PRIMA_FA(float, 64);
#undef PRIMA_FA
  return (int)cudaErrorInvalidValue;
}
