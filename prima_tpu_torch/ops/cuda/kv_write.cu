// In-place KV-cache write (sm_90a).
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

#include <cuda_runtime.h>
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

}  // namespace

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
