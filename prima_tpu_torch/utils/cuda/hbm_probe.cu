// Device-memory read probe (sm_90a).
//
// Replaces the TPU bench's _stream_kernel (tools/probe_hbm.py, bench.py,
// experiments/kernel_roofline_r4.py): stream a large array from device
// memory once and reduce it, to learn what rate this card gives right now.
// The sum of the array's int32 words, as an int64, comes back so that the
// reads cannot be dropped and the result can be checked exactly.
//
// Bound on the H100: device-memory bytes, by construction: one add per 4
// bytes read. Design: a grid of 8 blocks per SM, 256 threads, 16-byte
// loads in a grid-stride loop unrolled four deep (four independent loads in
// flight per thread), int64 partial sums reduced by warp shuffles and
// shared memory, one integer atomicAdd per block (integer adds commute, so
// the result is the same on every run).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ long long sum4(const int4& v) {
  return (long long)v.x + v.y + v.z + v.w;
}

__global__ void __launch_bounds__(THREADS)
read_sum_kernel(const int4* __restrict__ x, long long n16, unsigned long long* out) {
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long acc = 0;
  for (; i + (UNROLL - 1) * stride < n16; i += UNROLL * stride) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc += sum4(v[u]);
  }
  for (; i < n16; i += stride) acc += sum4(__ldcs(x + i));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  __shared__ long long warp_acc[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < THREADS / 32; ++w) total += warp_acc[w];
    atomicAdd(out, (unsigned long long)total);
  }
}

}  // namespace

// x: n16 16-byte words, 16-byte aligned; out: one int64, zeroed by the
// caller, receives the sum of x's int32 words. Returns cudaGetLastError().
extern "C" int prima_hbm_read_sum(const void* x, long long n16, void* out, int blocks,
                                  void* stream) {
  if (blocks < 1 || n16 < 0) return (int)cudaErrorInvalidValue;
  read_sum_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), n16, static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
