// Fused dequant-GEMV for the port's quantized weights (sm_90a).
//
// Replaces prima_tpu/quant/pallas/qmatmul.py:_qmm_kernel (entry
// qmatmul_pallas): y(B, N) = x(B, K) . dequant(W)(N, K)^T for B <= 32
// rows, weights read packed, once, accumulated in f32.
//
// Bound on the H100: device-memory bytes. At decode the weights are read
// once per step and nothing else is large, so the least time is the
// packed weight bytes over 3.35 TB/s. At 4 bits a weight, each byte feeds
// 2 * B multiply-adds, so the instructions spent per byte decide whether
// the kernel reaches that bound.
//
// Design:
//  * One warp owns ROWS = 2 output rows and walks their K in 16-byte
//    chunks: lane l reads chunks l, l + 32, ..., so a warp reads 512
//    contiguous bytes per row per step, and the next step's quants and
//    scale bytes are loaded before this step's arithmetic (a register
//    double buffer) to keep two DRAM latencies in flight.
//  * A 16-byte chunk lies inside one sub-block (sub is 16 or 32, chunks
//    are 16-aligned): one scale decode per half-chunk, with shifts, not
//    divisions. nib4: byte i holds col i (low nibble) and col i + K/2
//    (high nibble), so a chunk yields 16 low and 16 high columns.
//  * A quant becomes a float with one byte permute (it lands in the low
//    byte of the float 2^23) and one f32 subtract; the weight is then
//    fma(q, sc, q_offset * sc - mn), and the B activation rows, read
//    through L1 as float4, are reused for both rows of the warp.
//  * Warp-shuffle reduction; no shared memory, no block barrier.
// What it leaves for later: TMA staging, split-K for narrow N, register
// blocking over more rows to cut the activation re-reads at larger B.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 2;

enum Layout { NIB4 = 0, INT8 = 1 };
enum ScaleMode { FLAT = 0, GROUPED = 1, PACKED = 2 };

struct Args {
  const float* x;       // (B, K)
  const uint8_t* qs;    // (N, row_bytes)
  const void* scales;   // f32 (N, S) | int8 (N, S) | uint8 (N, S)
  const void* mins;     // like scales | uint8 (N, S/2) | null
  const void* d;        // f32 (N, G) | int32 (N, G) pairs | null
  const void* dmin;     // f32 (N, G) | null
  float* out;           // (B, N)
  int B, N, K, sub_shift, gsub_shift, q_offset, smode;
};

// The raw scale words of one sub-block, loaded a step ahead of use.
struct ScaleRaw {
  uint32_t a, b, c, d;
};

__device__ __forceinline__ ScaleRaw load_scale(const Args& a, int n, int s) {
  const int S = a.K >> a.sub_shift;
  const size_t i = (size_t)n * S + s;
  ScaleRaw r{0u, 0u, 0u, 0u};
  if (a.smode == FLAT) {
    r.a = __float_as_uint(__ldg(static_cast<const float*>(a.scales) + i));
    if (a.mins) r.b = __float_as_uint(__ldg(static_cast<const float*>(a.mins) + i));
    return r;
  }
  const size_t gi = (size_t)n * (S >> a.gsub_shift) + (s >> a.gsub_shift);
  if (a.smode == GROUPED) {
    r.a = (uint32_t)(int)__ldg(static_cast<const int8_t*>(a.scales) + i);
    r.c = __float_as_uint(__ldg(static_cast<const float*>(a.d) + gi));
    if (a.mins) {
      r.b = (uint32_t)(int)__ldg(static_cast<const int8_t*>(a.mins) + i);
      r.d = __float_as_uint(__ldg(static_cast<const float*>(a.dmin) + gi));
    }
    return r;
  }
  // PACKED: 6-bit codes in 1.5 bytes per sub-block, f16 d/dmin pair
  const int half = S >> 1;
  r.a = __ldg(static_cast<const uint8_t*>(a.scales) + i);
  r.b = __ldg(static_cast<const uint8_t*>(a.mins) + (size_t)n * half +
              (s < half ? s : s - half));
  r.c = __ldg(static_cast<const uint32_t*>(a.d) + gi);
  r.d = s < half ? 0u : 4u;  // which nibble of b holds the low min bits
  return r;
}

// (scale, bias) of a sub-block: weight = q * scale + bias, with
// bias = q_offset * scale - min; scale = d * code as one f32 product.
__device__ __forceinline__ void decode_scale(const Args& a, const ScaleRaw& r,
                                             float& sc, float& bias) {
  float mn;
  if (a.smode == FLAT) {
    sc = __uint_as_float(r.a);
    mn = __uint_as_float(r.b);
  } else if (a.smode == GROUPED) {
    sc = __fmul_rn(__uint_as_float(r.c), (float)(int)r.a);
    mn = __fmul_rn(__uint_as_float(r.d), (float)(int)r.b);
  } else {
    const float dv = __half2float(__ushort_as_half((unsigned short)(r.c & 0xFFFFu)));
    const float dm = __half2float(__ushort_as_half((unsigned short)(r.c >> 16)));
    sc = __fmul_rn(dv, (float)(r.a & 63u));
    mn = __fmul_rn(dm, (float)(((r.a >> 6) << 4) | ((r.b >> r.d) & 15u)));
  }
  bias = __fsub_rn(__fmul_rn((float)a.q_offset, sc), mn);
}

// 16 weights of one half-chunk. Each word of `v` holds four bytes to
// convert (nibbles already masked for nib4; int8 bytes biased by 128 so
// the same unsigned path applies).
__device__ __forceinline__ void dequant16(const uint32_t (&v)[4], float sc,
                                          float bias, float offset, float* w) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    // byte i & 3 of word i >> 2 into the low byte of 0x4B000000 (2^23)
    const uint32_t bits = __byte_perm(v[i >> 2], 0x4B000000u, 0x7650u + (i & 3));
    const float q = __uint_as_float(bits) - offset;
    w[i] = fmaf(q, sc, bias);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

template <int LAYOUT, int NB>
__global__ void __launch_bounds__(THREADS) qgemv_kernel(const Args a) {
  constexpr int HALVES = LAYOUT == NIB4 ? 2 : 1;
  // nib4 nibbles convert as 2^23 + q; int8 bytes as 2^23 + q + 128
  constexpr float OFFSET = LAYOUT == NIB4 ? 8388608.0f : 8388736.0f;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS;
  if (n0 >= a.N) return;
  const int row_bytes = LAYOUT == NIB4 ? a.K >> 1 : a.K;
  const int n_chunks = row_bytes >> 4;
  const int half_k = a.K >> 1;
  int rows[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) rows[r] = min(n0 + r, a.N - 1);  // clamp, mask at the end

  float acc[ROWS][NB];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[r][b] = 0.0f;

  uint4 raw[ROWS];
  ScaleRaw sraw[ROWS][HALVES];
  auto load = [&](int j) {
    const int c0 = j << 4;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      raw[r] = __ldg(reinterpret_cast<const uint4*>(a.qs + (size_t)rows[r] * row_bytes) + j);
      sraw[r][0] = load_scale(a, rows[r], c0 >> a.sub_shift);
      if (HALVES == 2) sraw[r][HALVES - 1] = load_scale(a, rows[r], (c0 + half_k) >> a.sub_shift);
    }
  };
  if (lane < n_chunks) load(lane);

  for (int j = lane; j < n_chunks; j += 32) {
    uint4 cur[ROWS];
    ScaleRaw scur[ROWS][HALVES];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      cur[r] = raw[r];
#pragma unroll
      for (int h = 0; h < HALVES; ++h) scur[r][h] = sraw[r][h];
    }
    if (j + 32 < n_chunks) load(j + 32);  // next step's bytes in flight

    const int c0 = j << 4;
    float w[ROWS][16 * HALVES];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const uint32_t words[4] = {cur[r].x, cur[r].y, cur[r].z, cur[r].w};
      uint32_t v[4];
      float sc, bias;
      decode_scale(a, scur[r][0], sc, bias);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = LAYOUT == NIB4 ? (words[k] & 0x0F0F0F0Fu) : (words[k] ^ 0x80808080u);
      dequant16(v, sc, bias, OFFSET, w[r]);
      if (HALVES == 2) {
        decode_scale(a, scur[r][HALVES - 1], sc, bias);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = (words[k] >> 4) & 0x0F0F0F0Fu;
        dequant16(v, sc, bias, OFFSET, w[r] + 16);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < a.B) {
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          const float4* xp = reinterpret_cast<const float4*>(
              a.x + (size_t)b * a.K + c0 + h * half_k);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float4 xv = __ldg(xp + p);
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              const float* wr = w[r] + h * 16 + 4 * p;
              float s = acc[r][b];
              s = fmaf(wr[0], xv.x, s);
              s = fmaf(wr[1], xv.y, s);
              s = fmaf(wr[2], xv.z, s);
              s = fmaf(wr[3], xv.w, s);
              acc[r][b] = s;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float v = warp_sum(acc[r][b]);
      if (lane == 0 && b < a.B && n0 + r < a.N) a.out[(size_t)b * a.N + n0 + r] = v;
    }
}

template <int LAYOUT>
void launch(const Args& a, cudaStream_t stream) {
  const int rows_per_block = WARPS * ROWS;
  const dim3 grid((a.N + rows_per_block - 1) / rows_per_block);
  if (a.B <= 1) qgemv_kernel<LAYOUT, 1><<<grid, THREADS, 0, stream>>>(a);
  else if (a.B <= 2) qgemv_kernel<LAYOUT, 2><<<grid, THREADS, 0, stream>>>(a);
  else if (a.B <= 4) qgemv_kernel<LAYOUT, 4><<<grid, THREADS, 0, stream>>>(a);
  else if (a.B <= 8) qgemv_kernel<LAYOUT, 8><<<grid, THREADS, 0, stream>>>(a);
  else if (a.B <= 16) qgemv_kernel<LAYOUT, 16><<<grid, THREADS, 0, stream>>>(a);
  else qgemv_kernel<LAYOUT, 32><<<grid, THREADS, 0, stream>>>(a);
}

int log2_exact(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return (1 << s) == v ? s : -1;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 when
// sub or gsub is not a power of two.
extern "C" int prima_qgemv(const float* x, const uint8_t* qs, const void* scales,
                           const void* mins, const void* d, const void* dmin,
                           float* out, int B, int N, int K, int layout, int sub,
                           int gsub, int q_offset, int smode, void* stream) {
  const int sub_shift = log2_exact(sub), gsub_shift = log2_exact(gsub);
  if (sub_shift < 0 || gsub_shift < 0) return -1;
  const Args a{x, qs, scales, mins, d, dmin, out, B, N, K, sub_shift, gsub_shift,
               q_offset, smode};
  if (layout == NIB4) launch<NIB4>(a, static_cast<cudaStream_t>(stream));
  else launch<INT8>(a, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
