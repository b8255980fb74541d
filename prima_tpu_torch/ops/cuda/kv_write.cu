// In-place KV-cache writes (sm_90a): the byte-generic `prima_kv_write` and
// the fused K and V store of one layer, `prima_kv_store`.
//
// Replaces prima_tpu/ops/kv_pallas.py:_kv_write_kernel (entry kv_write):
// new (B, S, P) lands in cache (B, T, P) at row offsets
// clamp(pos[b], 0, T - S), the clamp of dynamic_update_slice that the
// engine relies on for parked rows.
//
// Bound on the H100: device-memory bytes, S * P * elt read plus the same
// written per row. At decode that is a few KB per launch, so the launch
// itself dominates; at prefill it is a plain copy.
//
// Design: grid (blocks, B); the positions stay a device int32 tensor, so
// no host sync is needed. Each block copies a share of its row's
// S * P * elt contiguous bytes with 16-byte vector loads and stores when
// both ends are 16-byte aligned, and bytewise for whatever is left. No
// alignment gate on P: P = 128 and 256 are as welcome as 1024.
//
// `prima_kv_store` replaces the same TPU kernel where the decoder calls it
// twice a layer (K, then V) and, for a KVQ8 / KVQ4 cache, the elementwise
// quantization around it (prima_tpu/ops/kvquant.py:82-102 quantize_kv,
// quantize_kv4, update_kv). Bound: bytes, the new K and V rows read once
// and their cache cells written once, 16 KB at the 8B decode step, so in
// practice the launch. Design: one launch a layer. Grid (blocks, B, 2):
// the last axis is K or V. A dense cache takes the rows as one contiguous
// run of 16-byte copies, cast in flight when the rows are of the other
// float type. For a quantized cache a warp owns one (row, head) vector:
// amax over D by shuffles, scale = amax / qmax and inv = 1 / max(scale,
// 1e-30) as true IEEE divisions (__fdiv_rn; no fast-math flag, and no
// reciprocal multiply), rintf(x * inv) with the product a single f32
// multiply (__fmul_rn, half to even like jnp.round), the clamp, and for
// KVQ4 the + 8 and the nibble pair (element i low, i + D/2 high); codes
// and the scale are stored in place, bit for bit what quantize_kv and
// quantize_kv4 give.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
kv_write_kernel(uint8_t* cache, const uint8_t* src, const int* pos, int T,
                int S, long long row_bytes, long long cache_bstride,
                int vec) {
  const int b = blockIdx.y;
  int p = pos[b];
  p = p < T - S ? p : T - S;
  p = p > 0 ? p : 0;
  const long long n = (long long)S * row_bytes;
  uint8_t* dst = cache + b * cache_bstride + p * row_bytes;
  const uint8_t* s = src + b * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n16 = n / 16;
    for (long long i = t0; i < n16; i += stride)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(s)[i];
    done = n16 * 16;
  }
  for (long long i = done + t0; i < n; i += stride) dst[i] = s[i];
}

// ---------------------------------------------------------------------------
// the fused K and V store of one layer
// ---------------------------------------------------------------------------

struct StoreArgs {
  void* dst[2];          // K and V cache: values, or codes
  float* scale[2];       // scales of a quantized cache
  const void* src[2];    // new K and V rows, (B, S, H, D) contiguous
  const int* pos;
  int T, S, H, D;
  long long dst_sb[2];   // batch stride of dst, bytes
  long long sc_sb[2];    // batch stride of the scales, elements
};

__device__ __forceinline__ int write_row(const int* pos, int b, int T, int S) {
  int p = pos[b];
  p = p < T - S ? p : T - S;
  return p > 0 ? p : 0;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 8 elements from 16-byte aligned src, as f32
__device__ __forceinline__ void load8(const float* src, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* dst, const float (&x)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&x)[8]) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = a;
}

// Dense cache of type TD from rows of type TS: the S rows of a batch row are
// one contiguous run in both.
template <typename TS, typename TD>
__global__ void __launch_bounds__(THREADS)
kv_store_dense(const StoreArgs a, int vec) {
  const int b = blockIdx.y, which = blockIdx.z;
  const int p = write_row(a.pos, b, a.T, a.S);
  const long long row = (long long)a.H * a.D;
  const long long n = a.S * row;
  // (selected, not indexed: indexing a kernel parameter copies it to the stack)
  TD* dst = reinterpret_cast<TD*>(static_cast<unsigned char*>(which ? a.dst[1] : a.dst[0]) +
                                  b * (which ? a.dst_sb[1] : a.dst_sb[0])) + p * row;
  const TS* src = static_cast<const TS*>(which ? a.src[1] : a.src[0]) + b * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n8 = n / 8;
    for (long long i = t0; i < n8; i += stride) {
      float x[8];
      load8(src + i * 8, x);
      store8(dst + i * 8, x);  // a bf16 value survives bf16 -> f32 -> bf16 unchanged
    }
    done = n8 * 8;
  }
  for (long long i = done + t0; i < n; i += stride) narrow(dst + i, widen(src[i]));
}

__device__ __forceinline__ void load4(const float* src, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float (&x)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
  const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  x[0] = f0.x; x[1] = f0.y; x[2] = f1.x; x[3] = f1.y;
}

// round(x * inv) clamped to [-QMAX, QMAX]: one f32 multiply, half to even
template <int QMAX>
__device__ __forceinline__ int code_of(float x, float inv) {
  const float r = rintf(__fmul_rn(x, inv));
  return (int)fminf(fmaxf(r, (float)-QMAX), (float)QMAX);
}

// Quantized cache: a warp owns one (row, head) vector of D elements; a lane
// takes the elements i .. i + 3 and their partners at i + D/2.
template <typename TS, int QMAX, bool PACK4>
__global__ void __launch_bounds__(THREADS)
kv_store_quant(const StoreArgs a) {
  const int b = blockIdx.y, which = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wpb = THREADS / 32;
  const int p = write_row(a.pos, b, a.T, a.S);
  const int D = a.D, half = D / 2, DQ = PACK4 ? half : D;
  const long long nvec = (long long)a.S * a.H;
  unsigned char* codes = static_cast<unsigned char*>(which ? a.dst[1] : a.dst[0]) +
                         b * (which ? a.dst_sb[1] : a.dst_sb[0]) + (long long)p * a.H * DQ;
  float* scales = (which ? a.scale[1] : a.scale[0]) + b * (which ? a.sc_sb[1] : a.sc_sb[0]) +
                  (long long)p * a.H;
  const TS* src = static_cast<const TS*>(which ? a.src[1] : a.src[0]) + b * nvec * D;
  for (long long vi = (long long)blockIdx.x * wpb + warp; vi < nvec;
       vi += (long long)gridDim.x * wpb) {
    const TS* x = src + vi * D;
    float amax = 0.f;
    for (int i = lane * 4; i < half; i += 128) {
      float lo[4], hi[4];
      load4(x + i, lo);
      load4(x + half + i, hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fmaxf(fabsf(lo[j]), fabsf(hi[j])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __fdiv_rn(amax, (float)QMAX);
    const float inv = scale > 0.f ? __fdiv_rn(1.f, fmaxf(scale, 1e-30f)) : 0.f;
    for (int i = lane * 4; i < half; i += 128) {
      float lo[4], hi[4];
      load4(x + i, lo);
      load4(x + half + i, hi);
      uint32_t wl = 0, wh = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = code_of<QMAX>(lo[j], inv), qh = code_of<QMAX>(hi[j], inv);
        if (PACK4) {
          wl |= (uint32_t)((ql + 8) | ((qh + 8) << 4)) << (8 * j);
        } else {
          wl |= (uint32_t)(ql & 0xff) << (8 * j);
          wh |= (uint32_t)(qh & 0xff) << (8 * j);
        }
      }
      *reinterpret_cast<uint32_t*>(codes + vi * DQ + i) = wl;
      if (!PACK4) *reinterpret_cast<uint32_t*>(codes + vi * DQ + half + i) = wh;
    }
    if (lane == 0) scales[vi] = scale;
  }
}

template <typename TS, typename TD>
void launch_dense(const StoreArgs& a, int B, cudaStream_t st) {
  const long long n = (long long)a.S * a.H * a.D;
  int vec = n % 8 == 0 && ((long long)a.H * a.D * sizeof(TD)) % 16 == 0;
  for (int w = 0; w < 2; ++w)
    vec = vec && (uintptr_t)a.dst[w] % 16 == 0 && (uintptr_t)a.src[w] % 16 == 0 &&
          a.dst_sb[w] % 16 == 0;
  long long blocks = ((vec ? n / 8 : n) + THREADS - 1) / THREADS;
  blocks = blocks > 1024 ? 1024 : (blocks < 1 ? 1 : blocks);
  kv_store_dense<TS, TD><<<dim3((unsigned)blocks, B, 2), THREADS, 0, st>>>(a, vec);
}

template <typename TS>
void launch_quant(const StoreArgs& a, int kind, int B, cudaStream_t st) {
  long long blocks = ((long long)a.S * a.H + THREADS / 32 - 1) / (THREADS / 32);
  blocks = blocks > 1024 ? 1024 : (blocks < 1 ? 1 : blocks);
  const dim3 grid((unsigned)blocks, B, 2);
  if (kind == 1) kv_store_quant<TS, 127, false><<<grid, THREADS, 0, st>>>(a);
  else kv_store_quant<TS, 7, true><<<grid, THREADS, 0, st>>>(a);
}

}  // namespace

// One layer's K and V rows into both caches, in place, at rows
// clamp(pos[b], 0, T - S). k_src, v_src: (B, S, H, D) contiguous, 16-byte
// aligned, bf16 (src_bf16 = 1) or f32. kind 0: dense caches (B, T, H, D) of
// bf16 (dst_bf16 = 1) or f32, each batch row contiguous, batch strides
// k_sb / v_sb in bytes. kind 1 (int8 codes, qmax 127) and 2 (packed
// nibbles, D/2 bytes a vector, qmax 7): codes in k_dst / v_dst and f32
// scales (B, T, H) in k_scale / v_scale with batch strides ksc_sb / vsc_sb
// in elements; D a multiple of 8, code rows 4-byte aligned. pos: (B,) int32
// on the device. Returns cudaGetLastError().
extern "C" int prima_kv_store(void* k_dst, void* v_dst, float* k_scale, float* v_scale,
                              const void* k_src, const void* v_src, const int* pos,
                              int kind, int src_bf16, int dst_bf16, int B, int T, int S,
                              int H, int D, long long k_sb, long long v_sb,
                              long long ksc_sb, long long vsc_sb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind < 0 || kind > 2 || S > T || (kind && (D % 8 || !k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  const StoreArgs a{{k_dst, v_dst}, {k_scale, v_scale}, {k_src, v_src}, pos, T, S, H, D,
                    {k_sb, v_sb}, {ksc_sb, vsc_sb}};
  if (kind) {
    if (src_bf16) launch_quant<__nv_bfloat16>(a, kind, B, st);
    else launch_quant<float>(a, kind, B, st);
  } else if (src_bf16) {
    if (dst_bf16) launch_dense<__nv_bfloat16, __nv_bfloat16>(a, B, st);
    else launch_dense<__nv_bfloat16, float>(a, B, st);
  } else {
    if (dst_bf16) launch_dense<float, __nv_bfloat16>(a, B, st);
    else launch_dense<float, float>(a, B, st);
  }
  return (int)cudaGetLastError();
}

// cache: (B, T, P) with batch stride cache_bstride bytes; src: (B, S, P)
// contiguous; pos: (B,) int32 on the device. Returns cudaGetLastError().
extern "C" int prima_kv_write(void* cache, const void* src, const int* pos,
                              int B, int T, int S, long long row_bytes,
                              long long cache_bstride, void* stream) {
  const long long n = (long long)S * row_bytes;
  const int vec = ((uintptr_t)cache % 16 == 0 && (uintptr_t)src % 16 == 0 &&
                   row_bytes % 16 == 0 && cache_bstride % 16 == 0);
  const long long units = vec ? n / 16 : n;
  long long blocks = (units + THREADS - 1) / THREADS;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  kv_write_kernel<<<dim3((unsigned)blocks, B), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(cache), static_cast<const uint8_t*>(src), pos, T, S,
      row_bytes, cache_bstride, vec);
  return (int)cudaGetLastError();
}
