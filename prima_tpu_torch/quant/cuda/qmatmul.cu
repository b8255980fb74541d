// Fused dequant-GEMV for the port's quantized weights (sm_90a).
//
// Replaces prima_tpu/quant/pallas/qmatmul.py:_qmm_kernel (entry
// qmatmul_pallas): y(B, N) = x(B, K) . dequant(W)(N, K)^T for B <= 32
// rows, weights read packed, once, accumulated in f32.
//
// Bound on the H100: device-memory bytes. At decode the weights are read
// once per step and nothing else is large, so the least time is the
// packed weight bytes over 3.35 TB/s. At 4 bits a weight, each byte feeds
// 2 * B multiply-adds, so the work the SM spends per weight decides whether
// the kernel reaches that bound.
//
// Design, common to both kernels (B <= 8 a launch; more rows run in passes
// of 8):
//  * A block of 8 warps owns 128 output rows and one slice of K
//    (grid = K slices x row blocks, the slices of a row block side by side
//    so that they use each row's bytes, scale bytes too, at about the same
//    time); a warp owns 64 rows and one 32-byte
//    unit of every row's 128-byte stage.
//  * The scale is factored out of the inner loop. For a sub-block s,
//    sum_k (q_k * sc_s + bias_s) * x_k = sc_s * sum_k q_k x_k + bias_s * X_s
//    with X_s = sum_{k in s} x_k taken once per block and batch row while x
//    is staged. (sc_s, bias_s) are decoded once per row and sub-block
//    into shared memory, stage by stage. The raw scale words of the grouped
//    and packed modes (4 sub-blocks a 32-bit word) are copied for the
//    whole slice with the first stage's cp.async group, whole words from
//    consecutive addresses of a row (by the stage, a thread's 4 bytes cost
//    a 32-byte sector each and doubled the traffic from the L2); flat f32
//    scales and ragged shapes load them by element a stage ahead.
//  * x (the block's K slice, all batch rows) is staged in shared memory
//    once per block, at most 32 KB, which bounds the slice.
//  * Weights stream through a 3-stage shared-memory ring of 128 rows x 128
//    bytes filled with 16-byte cp.async, so each block keeps up to 32 KB in
//    flight whatever its register count; the 16-byte chunks of a row are
//    XOR-swizzled with the row index so that the reads have no bank
//    conflict.
//  * Split K: narrow N (wk/wv at N = 1024) and the x staging limit cut K
//    into slices, one block each; the parts go to f32 scratch
//    (ksplit, B, N), and the block that finishes a row block last (an
//    integer counter per row block, which wraps back to 0) adds them in
//    the order of their index: no float atomics, no second launch, the
//    same bits on every run. (Merging through a thread block cluster's
//    distributed shared memory was tried and was slower: clusters of 8
//    blocks of ~106 KB each wait for four free SMs of one GPC.)
//
// The expert-indexed entry, `prima_qgemv_indexed`, runs the same bodies
// for mixture-of-experts decode (the counterpart of the JAX package's
// dynamic slice of the stacked experts before qmatmul_pallas): P <= 32
// (row, expert) pairs grouped by expert, one launch. The third grid axis
// runs over expert slots, min(E, P) of them. Every warp of block z reads
// the ids from device memory and finds, with a match, a rank by shuffles
// and two ballots, the z-th smallest distinct id and that expert's pairs
// (a bit mask, ascending); a slot with no expert exits. The block moves
// every weight pointer by that many experts (the experts are contiguous row
// ranges of the stacked arrays), so nothing waits on the host and no expert
// is copied, and runs the pairs as the batch columns of one body: x rows
// are staged and results written through the column -> pair map, and the
// expert's weights stream once through the ring for all of them. An expert
// with more pairs than the template's columns runs further passes in the
// same block (the caller bounds them: `per_expert`); split-K scratch and
// arrival counters belong to a (slot, pass). A column's f32 sums depend on
// that column alone, so a pair's result has the same bits whichever pairs
// share its expert. Measured on the H100: the 8-column tensor-core body
// lost to passes of 4 at every grouping tried, so nib4 groups take 4
// columns; int8 takes 1 column for one pair an expert, else 2 (a column
// costs an FMA a weight on the CUDA cores, and 4 lost wherever an expert
// held 2 pairs or fewer).
//
// nib4 weights (Q4_K, Q4_0, Q4_1: byte i holds col i in its low nibble and
// col i + K/2 in its high one) go to `qgemv_mma`, on the tensor cores:
// even one PRMT, one subtract and B FMAs a weight kept the CUDA cores'
// dispatch rate, not the memory, as the limit (3-6x the bound at B = 4). A
// nibble q is exact in bf16 as 128 + q, which is the byte 0x43 over the
// nibble's byte: one PRMT makes two weights. x is split into a bf16 high
// and low part (x ~ hi + lo, residual <= 2^-17 |x|); the 4 (or 8) batch
// rows' parts are the 8 (or 16) columns of mma.sync.m16n8k16 with f32
// accumulators, 256 weights an mma. The 128 comes off with the
// bias: sc * (c - 128 X) + bias * X = sc * c + (bias - 128 sc) * X, X being
// the group sums of the same bf16 parts. Within a k-step a lane's pairs of
// columns are permuted the same way in both operands, so a lane reads one
// 32-bit word of a row and 8 bytes of x.
//
// int8 weights (Q5_K, Q6_K, Q8_0 and the rest: 8 bits are not exact in
// bf16) stay on the CUDA cores in `qgemv_fma`, exact in f32: a lane owns
// two rows and all lanes walk the same columns, so x is read as broadcast
// float4s, each feeding 2 rows x 4 weights x B FMAs, a quant becomes a
// float with one byte permute and one subtract (it lands in the low byte
// of the float 2^23), and no warp reduction is needed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RB = 128;             // output rows per block
constexpr int SB = 128;             // bytes of each row per stage
constexpr int UNIT = 32;            // bytes of a row one lane takes per stage
constexpr int UNITS = SB / UNIT;    // = warps per 64-row group
constexpr int STAGES = 3;
constexpr int MAX_NB = 8;           // batch rows per launch
constexpr int RAW_BYTES = RB * 33 * 4;  // a block's raw scale words
constexpr int X_FLOATS = 8192;      // floats of x a block stages (32 KB)

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
  float* part;          // (ksplit, B, N) scratch when ksplit > 1
  unsigned int* done;   // one counter per row block, 0 between launches
  int B, N, K, sub_shift, gsub_shift, q_offset, smode, ksb, ksplit;
};

// Which row of x and of the output batch column b is: b itself for the
// plain entry, its pair for the indexed one.
struct SameRows {
  __device__ __forceinline__ int operator()(int b) const { return b; }
};
struct MaskRows {
  unsigned pairs;  // the pass's pairs as a bit mask, column b = the b-th set bit
  __device__ __forceinline__ int operator()(int b) const {
    unsigned m = pairs;
    for (int i = 0; i < b; ++i) m &= m - 1;
    return __ffs(m) - 1;
  }
};

// The indexed entry's experts: (P,) ids on the device, the passes of the
// template's columns an expert may take (the scratch and counters hold that
// many a slot), and the bytes between two experts in each array (qs,
// scales, mins, d, dmin; 0 for an absent one).
struct Experts {
  const int* ids;
  int P, passes;
  long long stride[5];
};

// Slot blockIdx.z's expert `e` (the z-th smallest distinct id) and its
// pairs as a bit mask (0 for a slot with no expert). Every warp finds them
// on its own, so no barrier stands before the first load.
__device__ __forceinline__ unsigned find_group(const Experts& ex, int& e) {
  constexpr unsigned ALL = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int id = lane < ex.P ? __ldg(ex.ids + lane) : 0x7FFFFFFF;
  // a lane stands for its id when no lower lane holds it
  const unsigned same = __match_any_sync(ALL, id);
  const unsigned firsts = __ballot_sync(ALL, lane < ex.P && !(same & ((1u << lane) - 1u)));
  int rank = 0;  // distinct ids below this lane's
  for (unsigned m = firsts; m; m &= m - 1) rank += __shfl_sync(ALL, id, __ffs(m) - 1) < id;
  const unsigned hit = __ballot_sync(ALL, (firsts >> lane & 1u) && rank == (int)blockIdx.z);
  if (!hit) return 0u;
  e = __shfl_sync(ALL, id, __ffs(hit) - 1);
  return __ballot_sync(ALL, lane < ex.P && id == e);
}

// The arguments of pass `pass` over the pairs `count` of expert e: every
// weight pointer moved to the expert, B the pass's columns, the split-K
// scratch and counters of its (slot, pass).
__device__ __forceinline__ void group_args(Args& a, const Args& a0, const Experts& ex, int e,
                                           int cols, int pass, int count) {
  auto at = [e](const void* base, long long stride) -> const void* {
    return base ? static_cast<const unsigned char*>(base) + e * stride : nullptr;
  };
  a = a0;
  a.qs = static_cast<const uint8_t*>(at(a0.qs, ex.stride[0]));
  a.scales = at(a0.scales, ex.stride[1]);
  a.mins = at(a0.mins, ex.stride[2]);
  a.d = at(a0.d, ex.stride[3]);
  a.dmin = at(a0.dmin, ex.stride[4]);
  a.B = min(cols, count - pass * cols);
  if (a.ksplit > 1) {
    const size_t unit = (size_t)blockIdx.z * ex.passes + pass;
    a.part = a0.part + unit * a.ksplit * cols * a.N;
    a.done = a0.done + unit * gridDim.y;
  }
}

// The raw scale words of one sub-block, loaded a stage ahead of use.
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

// Four consecutive sub-blocks s0 .. s0 + 3 of row n, those below s_end,
// by element from device memory.
__device__ __forceinline__ void load_scale4(const Args& a, int n, int s0, int s_end,
                                            ScaleRaw (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = s0 + i < s_end ? load_scale(a, n, s0 + i) : ScaleRaw{0u, 0u, 0u, 0u};
}

// (scale, bias) of a sub-block: weight = q * scale + bias, with
// bias = q_offset * scale - min; scale = d * code as one f32 product.
__device__ __forceinline__ float2 decode_scale(const Args& a, const ScaleRaw& r) {
  float sc, mn;
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
  return make_float2(sc, __fsub_rn(__fmul_rn((float)a.q_offset, sc), mn));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// What both kernels share: the block's slice, the weight ring, and the
// (scale, bias) entries of the stage at hand. sbuf holds EPR x RB float2,
// entry-major; entry e of a stage is sub-block s0 + e (nib4: e < 4 the low
// columns, e >= 4 the high ones). rawbuf holds each row's raw scale words
// for the whole slice, row-major with an odd stride `wp`: the codes of each
// range of sub-blocks (nib4 has two ranges, the low and the high columns),
// the min codes, the d words of each range, the dmin words.
template <int LAYOUT, int EPR>
struct Slice {
  static constexpr int QPR = EPR / 4;  // quads of entries per row and stage
  static constexpr int RANGES = LAYOUT == NIB4 ? 2 : 1;
  const Args& a;
  int tid, n0, row_bytes, kb0, len, n_st, S, srow, squad, sn;
  int sr0, nw, ng, pm0, off_mins, off_d, off_dmin, n_words, wp;
  uint32_t ring_u32;
  float2* sbuf;
  uint32_t* rawbuf;
  float bias_fold;  // bias += bias_fold * scale (the tensor-core path's -128)
  bool raw_ok;      // the slice's scale words fit rawbuf and are whole aligned words

  __device__ __forceinline__ Slice(const Args& args, unsigned char* ring, float2* sb,
                                   uint32_t* raw, float fold)
      : a(args), sbuf(sb), rawbuf(raw), bias_fold(fold) {
    tid = threadIdx.x;
    n0 = blockIdx.y * RB;
    row_bytes = LAYOUT == NIB4 ? a.K >> 1 : a.K;
    kb0 = blockIdx.x * a.ksb;
    len = min(a.ksb, row_bytes - kb0);  // bytes of each row in this slice
    n_st = (len + SB - 1) / SB;
    S = a.K >> a.sub_shift;
    srow = tid % RB;
    squad = tid / RB;
    sn = min(n0 + srow, a.N - 1);
    ring_u32 = smem_u32(ring);
    // the slice's sub-blocks: `ns` from sr0 (and from S / 2 + sr0 for nib4)
    const int sh = LAYOUT == NIB4 ? 5 : a.sub_shift, gs = a.gsub_shift, half = S >> 1;
    const int ns = len >> sh;
    const bool mins_grouped = a.smode == GROUPED && a.mins;
    sr0 = kb0 >> sh;
    nw = ns >> 2;
    ng = ((sr0 + ns - 1) >> gs) - (sr0 >> gs) + 1;
    pm0 = LAYOUT == NIB4 || sr0 < half ? sr0 : sr0 - half;  // packed mins: S / 2 bytes
    off_mins = RANGES * nw;
    off_d = off_mins + (a.smode == PACKED ? nw : mins_grouped ? RANGES * nw : 0);
    off_dmin = off_d + RANGES * ng;
    n_words = off_dmin + (mins_grouped ? RANGES * ng : 0);
    wp = n_words | 1;
    raw_ok = a.smode != FLAT && gs >= 2 && (len & (SB - 1)) == 0 && (S & 7) == 0 &&
             n_words <= 32 && wp * RB * 4 <= RAW_BYTES &&
             (LAYOUT == NIB4 ? (half & ((1 << gs) - 1)) == 0
                             : a.smode != PACKED || sr0 + ns <= half || sr0 >= half);
  }

  // the first of the 4 sub-blocks of this thread's quad in stage t, and
  // one past the last sub-block of its half of the row
  __device__ __forceinline__ void quad_range(int t, int& s0, int& s_end) const {
    if (LAYOUT == NIB4) {  // quad = half: low columns, then high columns
      s0 = (squad ? S >> 1 : 0) + ((kb0 + t * SB) >> 5);
      s_end = squad ? S : S >> 1;
    } else {
      s0 = ((kb0 + t * SB) >> a.sub_shift) + 4 * squad;
      s_end = S;
    }
  }

  // every row's raw scale words of the slice, 4 bytes a copy, consecutive
  // threads on consecutive words of a row; they join the next group. Where
  // word w of a row comes from (an array and an offset within the row) is
  // worked out once per block, so that the copies cost no divisions.
  __device__ __forceinline__ void fetch_raw() const {
    if (!raw_ok) return;  // the same for every thread of the block
    __shared__ const unsigned char* src_base[32];
    __shared__ int src_pitch[32];
    const int half = S >> 1, G = S >> a.gsub_shift;
    if (tid < n_words) {
      const int w = tid;
      if (w < off_mins) {
        src_base[w] = static_cast<const unsigned char*>(a.scales) +
                      (w / nw ? half + sr0 : sr0) + 4 * (w % nw);
        src_pitch[w] = S;
      } else if (w < off_d && a.smode == PACKED) {
        src_base[w] = static_cast<const unsigned char*>(a.mins) + pm0 + 4 * (w - off_mins);
        src_pitch[w] = half;
      } else if (w < off_d) {
        const int j = w - off_mins;
        src_base[w] = static_cast<const unsigned char*>(a.mins) +
                      (j / nw ? half + sr0 : sr0) + 4 * (j % nw);
        src_pitch[w] = S;
      } else {
        const bool dm = w >= off_dmin;
        const int j = w - (dm ? off_dmin : off_d);
        const int g0 = (j / ng ? half + sr0 : sr0) >> a.gsub_shift;
        src_base[w] = static_cast<const unsigned char*>(dm ? a.dmin : a.d) +
                      4 * (g0 + j % ng);
        src_pitch[w] = 4 * G;
      }
    }
    __syncthreads();
    const uint32_t dst = smem_u32(rawbuf);
#pragma unroll 4
    for (int idx = tid; idx < RB * 32; idx += THREADS) {
      const int row = idx >> 5, w = idx & 31;
      if (w < n_words) {
        const size_t n = min(n0 + row, a.N - 1);
        cp_async4(dst + (row * wp + w) * 4, src_base[w] + n * src_pitch[w]);
      }
    }
  }

  // stage t of the weights into the ring (a group is committed either way)
  __device__ __forceinline__ void fetch(int t) const {
    if (t < n_st) {
      const uint32_t dst = ring_u32 + (t % STAGES) * RB * SB;
#pragma unroll
      for (int j = 0; j < RB * (SB / 16) / THREADS; ++j) {
        const int idx = tid + j * THREADS, row = idx >> 3, c = idx & 7;
        const int byte = t * SB + c * 16;
        if (byte < len) {
          const int n = min(n0 + row, a.N - 1);  // clamp, mask at the end
          cp_async16(dst + row * SB + ((c ^ (row & 7)) << 4),
                     a.qs + (size_t)n * row_bytes + kb0 + byte);
        }
      }
    }
    cp_async_commit();
  }

  // the scales of stage t: thread -> (row, quad of 4 sub-blocks), from
  // rawbuf once group 0 is complete and the block has met, else by element
  // from device memory
  __device__ __forceinline__ void load_quad(int t, ScaleRaw (&r)[4]) const {
    if (squad >= QPR || t >= n_st) return;
    int s0, s_end;
    quad_range(t, s0, s_end);
    if (!raw_ok) {
      load_scale4(a, sn, s0, s_end, r);
      return;
    }
    const int range = LAYOUT == NIB4 ? squad : 0;
    const int q = (s0 - (range ? (S >> 1) + sr0 : sr0)) >> 2;  // quad within its range
    const uint32_t* row = rawbuf + srow * wp;
    const bool mins_grouped = a.smode == GROUPED && a.mins;
    const int gw = range * ng + (s0 >> a.gsub_shift) -
                   ((range ? (S >> 1) + sr0 : sr0) >> a.gsub_shift);
    const uint32_t wc = row[range * nw + q];
    const uint32_t wm = a.smode == PACKED ? row[off_mins + q]
                        : mins_grouped    ? row[off_mins + range * nw + q] : 0u;
    const uint32_t wd = row[off_d + gw];
    const uint32_t wdm = mins_grouped ? row[off_dmin + gw] : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (a.smode == PACKED)
        r[i] = ScaleRaw{(wc >> (8 * i)) & 0xFFu, (wm >> (8 * i)) & 0xFFu, wd,
                        s0 >= (S >> 1) ? 4u : 0u};
      else
        r[i] = ScaleRaw{(uint32_t)(int)(int8_t)(wc >> (8 * i)),
                        (uint32_t)(int)(int8_t)(wm >> (8 * i)), wd, wdm};
    }
  }
  __device__ __forceinline__ void store_quad(int t, const ScaleRaw (&r)[4]) const {
    if (squad < QPR && t < n_st) {
      float2* dst = sbuf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 sb = decode_scale(a, r[i]);
        sb.y = fmaf(bias_fold, sb.x, sb.y);
        dst[(4 * squad + i) * RB + srow] = sb;
      }
    }
  }
};

// The block's results, value(row, b) for its RB rows: straight to `out`, or
// with split K to this slice's part; the block that arrives last at the
// row block's counter then adds the parts in the order of their index. The
// arrival is one acq_rel atomic by one thread after a block barrier: it
// publishes the whole block's part and, for the last block, makes every
// other part visible, with no fence of its own.
template <int NB, typename Rows, typename F>
__device__ __forceinline__ void finish(const Args& a, int n0, const Rows& rmap, F value) {
  const int tid = threadIdx.x;
  const size_t bn = (size_t)a.B * a.N;
  float* dst = a.ksplit > 1 ? a.part + blockIdx.x * bn : a.out;
  for (int idx = tid; idx < RB * NB; idx += THREADS) {
    const int row = idx % RB, b = idx / RB;
    if (b < a.B && n0 + row < a.N) {
      const int r = a.ksplit > 1 ? b : rmap(b);  // a part is by column, out by row
      dst[(size_t)r * a.N + n0 + row] = value(row, b);
    }
  }
  if (a.ksplit == 1) return;
  __shared__ unsigned int arrived;
  __syncthreads();
  if (tid == 0) {
    unsigned int before;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
                 : "=r"(before) : "l"(a.done + blockIdx.y), "r"(a.ksplit - 1) : "memory");
    arrived = before;
  }
  __syncthreads();
  if (arrived != (unsigned int)(a.ksplit - 1)) return;  // the counter is 0 again
  for (int idx = tid; idx < RB * NB; idx += THREADS) {
    const int row = idx % RB, b = idx / RB;
    if (b < a.B && n0 + row < a.N) {
      const size_t at = (size_t)b * a.N + n0 + row;
      float v = 0.f;
      for (int j0 = 0; j0 < a.ksplit; j0 += 8) {  // 8 loads in flight, added in order
        float p[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          p[u] = j0 + u < a.ksplit ? __ldcg(a.part + (j0 + u) * bn + at) : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) v += p[u];
      }
      a.out[(size_t)rmap(b) * a.N + n0 + row] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// int8 weights: CUDA cores, exact f32
// ---------------------------------------------------------------------------

// Byte i of v (an int8 biased by 128) as a float: it lands in the low byte
// of 2^23 and 2^23 + 128 comes off again.
__device__ __forceinline__ float byte_to_f32(uint32_t v, int i) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650u + i)) - 8388736.0f;
}

// Shared memory of a block, in this order:
//   ring  STAGES x RB x SB bytes of packed weights (then the warps' sums)
//   sbuf  EPR x RB float2 (scale, bias)
//   raw   RAW_BYTES of raw scale words
//   xs    NB x ksb floats: the block's slice of x
//   xsum  NB x ksb / GRAN floats: sums of x over GRAN columns
template <int NB, int GRAN, typename Rows>
__device__ __forceinline__ void qgemv_fma_body(const Args& a, const Rows& rmap) {
  constexpr int GPU = UNIT / GRAN;     // groups (sub-blocks) per unit
  constexpr int EPR = UNITS * GPU;     // (scale, bias) entries per row and stage
  static_assert(GRAN == 16 || GRAN == 32, "sub-blocks of 16 or 32");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float2* sbuf = reinterpret_cast<float2*>(ring + STAGES * RB * SB);
  uint32_t* rawbuf = reinterpret_cast<uint32_t*>(sbuf + EPR * RB);
  float* xs = reinterpret_cast<float*>(rawbuf + RAW_BYTES / 4);
  float* xsum = xs + NB * a.ksb;
  const Slice<INT8, EPR> sl(a, ring, sbuf, rawbuf, 0.f);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = sl.len, n_st = sl.n_st;

  sl.fetch_raw();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) sl.fetch(t);

  // stage x and its group sums: a float4 per thread, groups of GRAN / 4
  // lanes; up to 4 loads in flight per thread
  constexpr int XU = NB < 4 ? NB : 4;
  const int len4 = len >> 2;
  for (int i0 = 0; i0 < len4; i0 += THREADS) {
    const int i4 = i0 + tid;
    const bool in = i4 < len4;
#pragma unroll
    for (int b0 = 0; b0 < NB; b0 += XU) {
      float4 xv[XU];
#pragma unroll
      for (int k = 0; k < XU; ++k) {
        xv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in && b0 + k < a.B)
          xv[k] = __ldg(reinterpret_cast<const float4*>(
              a.x + (size_t)rmap(b0 + k) * a.K + sl.kb0) + i4);
      }
#pragma unroll
      for (int k = 0; k < XU; ++k) {
        const int b = b0 + k;
        if (in) *reinterpret_cast<float4*>(xs + b * a.ksb + 4 * i4) = xv[k];
        float sum = (xv[k].x + xv[k].y) + (xv[k].z + xv[k].w);
#pragma unroll
        for (int o = 1; o < GRAN / 4; o <<= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
        if (in && (i4 & (GRAN / 4 - 1)) == 0)
          xsum[b * (a.ksb / GRAN) + i4 / (GRAN / 4)] = sum;
      }
    }
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();  // x, the raw scale words and stage 0 are in
  ScaleRaw sraw[4];
  sl.load_quad(0, sraw);

  const int grp = warp / UNITS, u = warp % UNITS;
  int rows[2];
  rows[0] = grp * 64 + lane;
  rows[1] = rows[0] + 32;
  float acc[2][NB];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[r][b] = 0.f;

  for (int t = 0; t < n_st; ++t) {
    if (t > 0) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage t is in; stage t - 1 and its scales are free
    }
    sl.fetch(t + STAGES - 1);
    sl.store_quad(t, sraw);
    sl.load_quad(t + 1, sraw);  // a stage ahead of its use
    __syncthreads();            // stage t's scales are in sbuf

    const int col0 = t * SB + u * UNIT;  // this unit's first column within the slice
    if (col0 < len) {
      const unsigned char* st = ring + (t % STAGES) * RB * SB;
      const float2* sb = sbuf;
      uint32_t w[2][8];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              st + rows[r] * SB + (((2 * u + c) ^ (rows[r] & 7)) << 4));
          w[r][4 * c] = v.x; w[r][4 * c + 1] = v.y;
          w[r][4 * c + 2] = v.z; w[r][4 * c + 3] = v.w;
        }
      }
      float raw[2][NB];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int b = 0; b < NB; ++b) raw[r][b] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float qf[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t v = w[r][j] ^ 0x80808080u;
#pragma unroll
          for (int i = 0; i < 4; ++i) qf[r][i] = byte_to_f32(v, i);
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + b * a.ksb + col0 + 4 * j);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float s = raw[r][b];
            s = fmaf(qf[r][0], xv.x, s);
            s = fmaf(qf[r][1], xv.y, s);
            s = fmaf(qf[r][2], xv.z, s);
            s = fmaf(qf[r][3], xv.w, s);
            raw[r][b] = s;
          }
        }
        if ((j + 1) % (GRAN / 4) == 0) {  // a sub-block of GRAN columns is complete
          const int gi = j / (GRAN / 4);  // its index within the unit
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 sc = sb[(u * GPU + gi) * RB + rows[r]];
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const float xg = xsum[b * (a.ksb / GRAN) + col0 / GRAN + gi];
              acc[r][b] = fmaf(sc.x, raw[r][b], fmaf(sc.y, xg, acc[r][b]));
              raw[r][b] = 0.f;
            }
          }
        }
      }
    }
  }

  // add the four warps of each row group, in the order of their index
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // UNITS x NB x RB
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int b = 0; b < NB; ++b) red[(u * NB + b) * RB + rows[r]] = acc[r][b];
  __syncthreads();
  finish<NB>(a, sl.n0, rmap, [&](int row, int b) {
    float v = red[b * RB + row];
#pragma unroll
    for (int k = 1; k < UNITS; ++k) v += red[(k * NB + b) * RB + row];
    return v;
  });
}

// ---------------------------------------------------------------------------
// nib4 weights: tensor cores
// ---------------------------------------------------------------------------

// d (16 x 8, f32) = a (16 x 16, bf16, row) . b (16 x 8, bf16, col) [+ d]
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1, bool first) {
  if (first) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Columns of x in the mma: NT tiles of 8. Batch row b's high part is column
// b, its low part column NB + b (NB = 4 * NT batch rows, padded with zeros).
// Shared memory of a block, in this order:
//   ring  STAGES x RB x SB bytes of packed weights (then the warps' sums)
//   sbuf  8 x RB float2 (scale, bias - 128 scale)
//   raw   RAW_BYTES of raw scale words
//   xb    2 halves x NC columns x (ksb + 16) bf16: the parts of x, rows
//         padded by 32 bytes so that 8 columns' reads miss each other's banks
//   xg    2 halves x ksb / 32 groups x NC floats: the parts' sums over 32 columns
template <int NT, typename Rows>
__device__ __forceinline__ void qgemv_mma_body(const Args& a, const Rows& rmap) {
  constexpr int NB = 4 * NT, NC = 8 * NT, EPR = 2 * UNITS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float2* sbuf = reinterpret_cast<float2*>(ring + STAGES * RB * SB);
  uint32_t* rawbuf = reinterpret_cast<uint32_t*>(sbuf + EPR * RB);
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(rawbuf + RAW_BYTES / 4);
  const int xstride = a.ksb + 16;  // elements of one column's row
  float* xg = reinterpret_cast<float*>(xb + 2 * NC * xstride);
  const Slice<NIB4, EPR> sl(a, ring, sbuf, rawbuf, -128.f);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int len = sl.len, n_st = sl.n_st;

  sl.fetch_raw();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) sl.fetch(t);

  // stage x as bf16 high and low parts with their sums over 32 columns: a
  // float4 per thread, groups of 8 lanes; 4 loads in flight per thread
  const int len4 = len >> 2;
  for (int i0 = 0; i0 < len4; i0 += THREADS) {
    const int i4 = i0 + tid;
    const bool in = i4 < len4;
#pragma unroll
    for (int hb0 = 0; hb0 < 2 * NB; hb0 += 4) {
      float4 xq[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = (hb0 + k) / NB, b = (hb0 + k) % NB;
        xq[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in && b < a.B)
          xq[k] = __ldg(reinterpret_cast<const float4*>(
              a.x + (size_t)rmap(b) * a.K + h * (a.K >> 1) + sl.kb0) + i4);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = (hb0 + k) / NB, b = (hb0 + k) % NB;
        const float xf[4] = {xq[k].x, xq[k].y, xq[k].z, xq[k].w};
        uint32_t hi[4], lo[4];
        float sum_hi = 0.f, sum_lo = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[i] = bf16_bits(xf[i]);
          const float hf = __uint_as_float(hi[i] << 16);
          lo[i] = bf16_bits(xf[i] - hf);
          sum_hi += hf;
          sum_lo += __uint_as_float(lo[i] << 16);
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          sum_hi += __shfl_xor_sync(0xFFFFFFFFu, sum_hi, o);
          sum_lo += __shfl_xor_sync(0xFFFFFFFFu, sum_lo, o);
        }
        if (in) {
          *reinterpret_cast<uint2*>(xb + (h * NC + b) * xstride + 4 * i4) =
              make_uint2(hi[0] | hi[1] << 16, hi[2] | hi[3] << 16);
          *reinterpret_cast<uint2*>(xb + (h * NC + NB + b) * xstride + 4 * i4) =
              make_uint2(lo[0] | lo[1] << 16, lo[2] | lo[3] << 16);
          if ((i4 & 7) == 0) {
            float* dst = xg + (h * (a.ksb >> 5) + (i4 >> 3)) * NC;
            dst[b] = sum_hi;
            dst[NB + b] = sum_lo;
          }
        }
      }
    }
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();  // x, the raw scale words and stage 0 are in
  ScaleRaw sraw[4];
  sl.load_quad(0, sraw);

  // warp = (64-row group, unit); 4 row tiles of 16; lane = 4 * g + t4 holds
  // rows g and g + 8 of each tile and columns 2 t4, 2 t4 + 1 of each 8
  const int grp = warp / UNITS, u = warp % UNITS;
  const int row0 = grp * 64 + g;
  float acc[4][NT][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

  for (int t = 0; t < n_st; ++t) {
    if (t > 0) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage t is in; stage t - 1 and its scales are free
    }
    sl.fetch(t + STAGES - 1);
    sl.store_quad(t, sraw);
    sl.load_quad(t + 1, sraw);  // a stage ahead of its use
    __syncthreads();            // stage t's scales are in sbuf

    const int col0 = t * SB + u * UNIT;  // this unit's first byte within the slice
    if (col0 < len) {
      const unsigned char* st = ring + (t % STAGES) * RB * SB;
      const float2* sb = sbuf;
      // word t4 of both 16-byte chunks of the unit, rows g and g + 8 of each tile
      uint32_t w[4][2][2];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row0 + 16 * m + 8 * r;
            w[m][c][r] = *reinterpret_cast<const uint32_t*>(
                st + row * SB + (((2 * u + c) ^ (row & 7)) << 4) + 4 * t4);
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // low nibbles: columns below K/2; high: above
        float cf[4][NT][4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // a k-step: the 16 columns of chunk c
          uint2 bx[NT];
#pragma unroll
          for (int n = 0; n < NT; ++n)
            bx[n] = *reinterpret_cast<const uint2*>(
                xb + (h * NC + 8 * n + g) * xstride + col0 + 16 * c + 4 * t4);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const uint32_t v0 = (w[m][c][0] >> (4 * h)) & 0x0F0F0F0Fu;
            const uint32_t v1 = (w[m][c][1] >> (4 * h)) & 0x0F0F0F0Fu;
            // a nibble's byte under 0x43 is the bf16 128 + q; columns 4 t4 ..
            // 4 t4 + 3 sit in the k slots 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9
            const uint32_t af[4] = {__byte_perm(v0, 0x43434343u, 0x5140u),
                                    __byte_perm(v1, 0x43434343u, 0x5140u),
                                    __byte_perm(v0, 0x43434343u, 0x7362u),
                                    __byte_perm(v1, 0x43434343u, 0x7362u)};
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_bf16(cf[m][n], af, bx[n].x, bx[n].y, c == 0);
          }
        }
        // the sub-block of 32 columns is complete: scale it
        const int e = h * UNITS + u;
        float2 xs2[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          xs2[n] = *reinterpret_cast<const float2*>(
              xg + (h * (a.ksb >> 5) + (col0 >> 5)) * NC + 8 * n + 2 * t4);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 s0 = sb[e * RB + row0 + 16 * m];
          const float2 s1 = sb[e * RB + row0 + 16 * m + 8];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            acc[m][n][0] = fmaf(s0.x, cf[m][n][0], fmaf(s0.y, xs2[n].x, acc[m][n][0]));
            acc[m][n][1] = fmaf(s0.x, cf[m][n][1], fmaf(s0.y, xs2[n].y, acc[m][n][1]));
            acc[m][n][2] = fmaf(s1.x, cf[m][n][2], fmaf(s1.y, xs2[n].x, acc[m][n][2]));
            acc[m][n][3] = fmaf(s1.x, cf[m][n][3], fmaf(s1.y, xs2[n].y, acc[m][n][3]));
          }
        }
      }
    }
  }

  // add the four warps of each row group and the two parts of x, in a fixed order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // UNITS x NC x RB
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(u * NC + 8 * n + 2 * t4 + (i & 1)) * RB + row0 + 16 * m + 8 * (i >> 1)] =
            acc[m][n][i];
  __syncthreads();
  finish<NB>(a, sl.n0, rmap, [&](int row, int b) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < UNITS; ++k)
      v += red[(k * NC + b) * RB + row] + red[(k * NC + NB + b) * RB + row];
    return v;
  });
}

// The indexed entry's block: its slot's expert and pairs (find_group),
// then the pairs through `body` as COLS columns. A group that fits runs in
// one pass with its arguments in registers, as the plain kernels do; a
// wider one runs passes of COLS with the arguments in shared memory, which
// keeps the loop around the body from spilling its registers.
template <int COLS, typename Body>
__device__ __forceinline__ void run_groups(const Args& a0, const Experts& ex, Body body) {
  int e;
  unsigned mine = find_group(ex, e);
  const int count = __popc(mine);
  if (count <= COLS) {
    if (count) {  // the same for every thread of the block
      Args a;
      group_args(a, a0, ex, e, COLS, 0, count);
      body(a, MaskRows{mine});
    }
    return;
  }
  __shared__ Args sa;
  for (int pass = 0; mine; ++pass) {
    unsigned cur = mine;  // this pass's pairs: the next COLS of them
    for (int i = 0; i < COLS && mine; ++i) mine &= mine - 1;
    cur &= ~mine;
    if (pass == ex.passes) {  // more pairs than the caller's bound: NaN, not stale memory
      const MaskRows rest{cur | mine};
      for (int idx = threadIdx.x; idx < RB * __popc(rest.pairs); idx += THREADS) {
        const int n = blockIdx.y * RB + idx % RB;
        if (blockIdx.x == 0 && n < a0.N)
          a0.out[(size_t)rest(idx / RB) * a0.N + n] = __int_as_float(0x7FC00000);
      }
      return;
    }
    if (pass > 0) __syncthreads();  // the last pass is done with shared memory and `sa`
    if (threadIdx.x == 0) group_args(sa, a0, ex, e, COLS, pass, count);
    __syncthreads();
    body(sa, MaskRows{cur});
  }
}

// The kernels: the plain entry's, and the indexed entry's, which group the
// pairs by expert first.
template <int NB, int GRAN>
__global__ void __launch_bounds__(THREADS, 2) qgemv_fma(const Args a) {
  qgemv_fma_body<NB, GRAN>(a, SameRows{});
}
template <int NB, int GRAN>
__global__ void __launch_bounds__(THREADS, 2) qgemv_fma_indexed(const Args a,
                                                                const Experts ex) {
  run_groups<NB>(a, ex, [](const Args& g, const MaskRows& rows) {
    qgemv_fma_body<NB, GRAN>(g, rows);
  });
}
template <int NT>
__global__ void __launch_bounds__(THREADS, 2) qgemv_mma(const Args a) {
  qgemv_mma_body<NT>(a, SameRows{});
}
template <int NT>
__global__ void __launch_bounds__(THREADS, 2) qgemv_mma_indexed(const Args a,
                                                                const Experts ex) {
  run_groups<4 * NT>(a, ex, [](const Args& g, const MaskRows& rows) {
    qgemv_mma_body<NT>(g, rows);
  });
}

// A launch of `kernel` over `slots` (the indexed entry's expert slots; 1
// for the plain entry), its arguments `a` and `extra`.
template <typename K, typename... Extra>
int launch_kernel(K kernel, size_t smem, size_t* smem_set, int slots, cudaStream_t stream,
                  const Args& a, const Extra&... extra) {
  if (smem > *smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    *smem_set = smem;
  }
  // a row block's slices run together; the indexed entry's slots on z
  const dim3 grid(a.ksplit, (a.N + RB - 1) / RB, slots);
  kernel<<<grid, THREADS, smem, stream>>>(a, extra...);
  return (int)cudaGetLastError();
}

constexpr size_t RING_BYTES = (size_t)STAGES * RB * SB;

template <int NB, int GRAN, bool IDX = false>
int launch_fma(const Args& a, cudaStream_t stream, const Experts& ex = {}, int slots = 1) {
  constexpr int EPR = UNITS * (UNIT / GRAN);
  const size_t smem = RING_BYTES + EPR * RB * sizeof(float2) +
                      RAW_BYTES +
                      (size_t)NB * (a.ksb + a.ksb / GRAN) * sizeof(float);
  static size_t smem_set = 48 * 1024;  // the default limit for dynamic smem
  if constexpr (IDX)
    return launch_kernel(qgemv_fma_indexed<NB, GRAN>, smem, &smem_set, slots, stream, a, ex);
  else
    return launch_kernel(qgemv_fma<NB, GRAN>, smem, &smem_set, 1, stream, a);
}

template <int NT, bool IDX = false>
int launch_mma(const Args& a, cudaStream_t stream, const Experts& ex = {}, int slots = 1) {
  const size_t smem = RING_BYTES + 2 * UNITS * RB * sizeof(float2) +
                      RAW_BYTES + (size_t)2 * 8 * NT * (a.ksb + 16) * sizeof(__nv_bfloat16) +
                      (size_t)2 * (a.ksb / 32) * 8 * NT * sizeof(float);
  static size_t smem_set = 48 * 1024;
  if constexpr (IDX)
    return launch_kernel(qgemv_mma_indexed<NT>, smem, &smem_set, slots, stream, a, ex);
  else
    return launch_kernel(qgemv_mma<NT>, smem, &smem_set, 1, stream, a);
}

template <int GRAN>
int launch_int8(const Args& a, cudaStream_t stream) {
  if (a.B <= 1) return launch_fma<1, GRAN>(a, stream);
  if (a.B <= 2) return launch_fma<2, GRAN>(a, stream);
  if (a.B <= 4) return launch_fma<4, GRAN>(a, stream);
  return launch_fma<8, GRAN>(a, stream);
}

template <int GRAN>
int launch_int8_indexed(const Args& a, cudaStream_t stream, const Experts& ex, int slots) {
  if (a.B == 1) return launch_fma<1, GRAN, true>(a, stream, ex, slots);
  return launch_fma<2, GRAN, true>(a, stream, ex, slots);
}

int log2_exact(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return (1 << s) == v ? s : -1;
}

// The shapes and slicing both entries take, for B rows of x a launch.
bool shapes_ok(int B, int K, int layout, int sub, int gsub, int ksb, int ksplit,
               const float* part, const unsigned int* done) {
  const int row_bytes = layout == NIB4 ? K / 2 : K;
  // rows of x a launch stages: nib4 pads to 4 or 8, int8 to a power of two
  const int nb_pad = B > 4 ? 8 : (layout == NIB4 || B > 2) ? 4 : B;
  const int x_floats = (layout == NIB4 ? 2 : 1) * nb_pad * ksb;
  return log2_exact(sub) >= 0 && log2_exact(gsub) >= 0 && (sub == 16 || sub == 32) &&
         !(layout == NIB4 && sub != 32) && ksb > 0 && ksb % SB == 0 && row_bytes % UNIT == 0 &&
         ksplit == (row_bytes + ksb - 1) / ksb && (ksplit == 1 || (part && done)) &&
         x_floats <= X_FLOATS;
}

}  // namespace

// y (B, N) = x (B, K) . dequant(W)^T. Each row's bytes are cut into ksplit
// slices of ksb bytes (a multiple of 128, small enough that the slice of x
// fits the kernel's 32 KB staging area, which the caller sees to); with
// ksplit > 1 `part` is f32 scratch (ksplit, min(B, 8), N) and `done` holds
// one unsigned counter per block of 128 rows, all 0 before the first launch
// and 0 again after each. Returns cudaGetLastError() after the launches
// (0 = launched), or -1 when sub, gsub or the slicing is not one the
// kernels take.
extern "C" int prima_qgemv(const float* x, const uint8_t* qs, const void* scales,
                           const void* mins, const void* d, const void* dmin,
                           float* out, float* part, unsigned int* done, int B, int N,
                           int K, int layout,
                           int sub, int gsub, int q_offset, int smode, int ksb,
                           int ksplit, void* stream) {
  if (!shapes_ok(B, K, layout, sub, gsub, ksb, ksplit, part, done)) return -1;
  const int sub_shift = log2_exact(sub), gsub_shift = log2_exact(gsub);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int b0 = 0; b0 < B; b0 += MAX_NB) {
    const int nb = B - b0 < MAX_NB ? B - b0 : MAX_NB;
    float* y = out + (size_t)b0 * N;
    const Args a{x + (size_t)b0 * K, qs, scales, mins, d, dmin, y, part, done,
                 nb, N, K, sub_shift, gsub_shift, q_offset, smode, ksb, ksplit};
    int e;
    if (layout == NIB4) e = nb <= 4 ? launch_mma<1>(a, st) : launch_mma<2>(a, st);
    else if (sub == 16) e = launch_int8<16>(a, st);
    else e = launch_int8<32>(a, st);
    if (e) return e;
  }
  return 0;
}

// The expert-indexed GEMV: y (P, N) with y[p] = dequant(W_e)(N, K) . x[p]
// for e = ids[p], where W is the stacked experts (E * N rows) and
// estride_* the bytes between two experts in each array (0 for an absent
// one). ids (P <= 32) stays on the device. `slots` = min(E, P) blocks on
// the third grid axis, one a distinct expert; each runs its expert's pairs
// in passes of `cols` batch columns (nib4 4, int8 1 or 2), at
// most `passes` of them, which the caller sizes from a bound on the pairs
// of one expert (more pairs give NaN rows). ksb and ksplit are for `cols`
// rows of x. With ksplit > 1, `part` is f32 scratch (slots, passes,
// ksplit, cols, N) and `done` holds slots * passes * ceil(N / 128)
// counters, 0 before the first launch and after each. Returns as
// prima_qgemv.
extern "C" int prima_qgemv_indexed(const float* x, const uint8_t* qs, const void* scales,
                                   const void* mins, const void* d, const void* dmin,
                                   float* out, float* part, unsigned int* done,
                                   const int* ids, int P, int N, int K, int layout, int sub,
                                   int gsub, int q_offset, int smode, int ksb, int ksplit,
                                   int slots, int cols, int passes,
                                   long long estride_qs, long long estride_scales,
                                   long long estride_mins, long long estride_d,
                                   long long estride_dmin, void* stream) {
  const bool cols_ok = layout == NIB4 ? cols == 4 : cols == 1 || cols == 2;
  if (P < 1 || P > 32 || slots < 1 || slots > P || passes < 1 || !cols_ok || !ids ||
      !shapes_ok(cols, K, layout, sub, gsub, ksb, ksplit, part, done))
    return -1;
  const Args a{x, qs, scales, mins, d, dmin, out, part, done, cols, N, K, log2_exact(sub),
               log2_exact(gsub), q_offset, smode, ksb, ksplit};
  const Experts ex{ids, P, passes,
                   {estride_qs, estride_scales, estride_mins, estride_d, estride_dmin}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == NIB4) return launch_mma<1, true>(a, st, ex, slots);
  if (sub == 16) return launch_int8_indexed<16>(a, st, ex, slots);
  return launch_int8_indexed<32>(a, st, ex, slots);
}
