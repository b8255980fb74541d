// Split-K flash-decoding attention over the KV cache (sm_90a).
//
// Replaces prima_tpu/ops/attention_pallas.py:_decode_kernel (entry
// flash_decode): causal GQA attention for s_q <= 8 query rows per batch
// row. The GQA group is folded into rows (row = g * S + s, head
// h = kvh * G + g); row r of batch b sees KV cell c iff
// c <= positions[b, 0] + r % S, and only cells below
// nblk * kv_blk are read, nblk = clip(ceil((pos_last + 1) / kv_blk), 1,
// T / kv_blk). Scores and the softmax are f32; masked cells score -1e30;
// out = acc / max(l, 1e-30) in q's dtype. The cache is a dense tensor of
// q's type, or int8 codes (KVQ8) or packed nibbles (KVQ4: byte i of a
// row holds element i low and element i + D/2 high, offset by 8) with one
// f32 scale per (cell, head).
//
// Bound on the H100: device-memory bytes. Each (batch row, KV head) reads
// its visible K and V cells once (at the 8B shape, B = 4 near position
// 4000: 65.9 MB in bf16, 33.9 MB as q8_0, 17.5 MB as q4_0, against ~4 KB
// of q and output), and the operations, 4 * rows * cells * D, are ~2 per
// bf16 byte at 4 rows.
//
// Design.
//  * Grid (B * KVH, n_split, row tiles). The T axis is cut into n_split
//    chunks of split_len cells, a pure function of the shapes (chosen by
//    the wrapper so that ~256 blocks cover all of T, one wave of two blocks
//    an SM: a block's fixed costs, ~9 us of launch, first tile and merges,
//    want bytes behind them). A block reads
//    the positions from the device tensor (no host sync); a chunk wholly past
//    the last visible cell exits at once, and cells past it are never read.
//  * A block is four warps, and each warp is its own stream: warp w takes
//    the 16-cell tiles w, w + 4, ... of the chunk through a private ring
//    of shared memory, filled by 16-byte cp.async straight from the
//    cache's natural (B, T, KVH, D) layout and strides, in the cache's own
//    type (codes stay codes; nothing is converted or copied twice). The
//    ring is 3 stages for bf16 (4 for codes, 2 for f32 at D = 128), so a
//    warp keeps 2 tiles = 16 KB of bf16 in flight and a block 64 KB; two
//    blocks fit an SM (96 KB each), 128 KB in flight against the ~20 KB an
//    SM that 3.35 TB/s needs at device-memory latency. The main loop has no
//    block barrier at all: a warp waits for its own copies and
//    synchronizes itself. 16-byte chunks are XOR-swizzled by the cell (or,
//    for rows under 128 bytes, by the 128-byte line), so fragment reads do
//    not collide. What cp.async does not load (cells at or past the chunk's
//    end) it fills with zeros, so p = 0 never meets an old NaN.
//  * bf16 queries: both products on the tensor cores, mma.sync.m16n8k16
//    with f32 accumulators. The folded rows (4 at the 8B step) are padded
//    to one or two 16-row tiles. Dense K fragments come by ldmatrix, V by
//    ldmatrix.trans. Quantized caches are dequantized on the way: a thread
//    reads the codes of its fragment from shared memory, computes
//    code * scale in f32 and rounds once to bf16, which are the very bits
//    of the reference's `cache.astype(bf16)`, so the scale is NOT factored
//    out of the dot product (that would change the rounding). The exact way
//    costs a byte permute, an add, a multiply and half a pack an element
//    (the code becomes the low mantissa bits of 2^23, so no integer-to-float
//    conversion is needed): ~370 of the loop's ~900 instructions a tile, and
//    what keeps the q8_0 / q4_0 times above their byte bounds. The d axis of
//    Q.K^T and the column order of P.V are permuted so that each thread
//    reads its codes as one or two 16-byte words; q fragments follow the
//    same permutation, and with one row tile they stay in registers for the
//    whole walk. The online softmax is f32 in registers, base 2; P is
//    rounded to bf16 for P.V (2^-9 a term, as flash_attn.cu).
//  * f32 queries keep exact f32 FMAs on the CUDA cores with the same
//    staging: in the score phase a lane owns one cell and half of D, in
//    the P.V phase D / 32 columns of every row. A block takes 1, 4 or 16
//    rows (the row loops are unrolled, so padding rows cost instruction slots).
//  * Merges. The four warps' (m, l, acc) are merged through shared memory
//    in warp order. With more than one active chunk the block's part goes
//    to f32 scratch and the last block to arrive at an integer counter
//    (which wraps back to 0) adds the parts in index order: no second
//    launch, no float atomics, the same bits on every run.
// Cells past the last visible one are not read at all: cell 0 is always
// visible (positions >= 0), so a chunk of masked cells would only add
// exp(-1e30 - m) = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 16;               // KV cells of one warp's tile
constexpr float NEG_INF = -1e30f;     // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

enum Kind { DENSE = 0, Q8 = 1, Q4 = 2 };

struct Args {
  const void* q;
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;   // scales of a quantized cache, else null
  const float* vs;
  const int* pos;
  void* out;
  float* part_acc;
  float* part_ml;
  unsigned int* done;
  int S, H, KVH, T;
  long long k_sb, k_st, v_sb, v_st;      // batch and cell strides, bytes
  long long ks_sb, ks_st, vs_sb, vs_st;  // the same of the scales, elements
  int kv_blk, split_len, n_split;
  float scale;
};

template <int KIND, int D, int QSIZE>
__host__ __device__ constexpr int row_bytes() { return KIND == DENSE ? D * QSIZE : (KIND == Q8 ? D : D / 2); }
__host__ __device__ constexpr int n_stages(int rowb) { return rowb >= 512 ? 2 : (rowb >= 256 ? 3 : 4); }
template <int KIND, int ROWB>
__host__ __device__ constexpr int stage_bytes() { return 2 * SUB * ROWB + (KIND == DENSE ? 0 : 2 * SUB * 4); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <bool LOG2>
__device__ __forceinline__ float ex(float x) { return LOG2 ? exp2f(x) : expf(x); }

// Byte offset of byte `byte` of cell `cell` in a tile of ROWB-byte rows: the
// 16-byte chunks of a 128-byte line are XORed with the cell (rows of 128
// bytes or more) or with the line (shorter rows).
template <int ROWB>
__device__ __forceinline__ int swz(int cell, int byte) {
  if (ROWB >= 128) return cell * ROWB + (byte ^ ((cell & 7) << 4));
  const int off = cell * ROWB + byte;
  return off ^ (((off >> 7) & 7) << 4);
}

// Byte s of a word as a float, exactly, with no integer-to-float conversion
// (whose pipe is a quarter as wide as the FMA pipe and was what the
// dequantization waited for): the byte becomes the low mantissa bits of
// 2^23, and one subtraction leaves the code. Signed codes are biased by 128
// first (one XOR a word).
__device__ __forceinline__ float code_u8(uint32_t w, int s) {
  return __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7650 + s)) - 8388608.f;
}
__device__ __forceinline__ float code_s8(uint32_t w, int s) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4b000000u, 0x7650 + s)) - 8388736.f;
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

// What a block knows of its place: set by `place`, false when the chunk lies
// wholly past the last visible cell.
struct Place {
  int b, kvh, bh, split, G, R, r0, nr, c_begin, c_end, n_act, pos0;
};
template <int RT>
__device__ __forceinline__ bool place(const Args& a, Place& p) {
  p.bh = blockIdx.x;
  p.b = p.bh / a.KVH;
  p.kvh = p.bh % a.KVH;
  p.split = blockIdx.y;
  p.G = a.H / a.KVH;
  p.R = p.G * a.S;
  p.r0 = blockIdx.z * RT;
  p.nr = min(RT, p.R - p.r0);
  const int end = visible_end(a.pos, p.b, a.S, a.T, a.kv_blk);
  p.c_begin = p.split * a.split_len;
  if (p.c_begin >= end) return false;
  p.c_end = min(p.c_begin + a.split_len, end);
  p.n_act = min(a.n_split, (end + a.split_len - 1) / a.split_len);
  p.pos0 = a.pos[p.b * a.S];
  return true;
}

// A warp's ring of K/V tiles. Tile j of warp w holds the cells from
// c_begin + (j * WARPS + w) * SUB; a stage is [K tile][V tile] and, for a
// quantized cache, [16 K scales][16 V scales].
template <int KIND, int ROWB>
struct Ring {
  static constexpr int STAGES = n_stages(ROWB);
  static constexpr int STAGE = stage_bytes<KIND, ROWB>();
  static constexpr int CPR = ROWB / 16;           // 16-byte chunks per row
  static constexpr int LOADS = SUB * CPR / 32;    // per lane and tensor
  static_assert(SUB * CPR % 32 == 0, "a tile is a whole number of warp loads");

  unsigned char* base;   // this warp's stages
  uint32_t base_u32;
  const unsigned char *kb, *vb;
  const float *ksb, *vsb;
  long long k_st, v_st, ks_st, vs_st;
  int c_begin, c_end, warp, lane, n_my;

  __device__ __forceinline__ void init(const Args& a, const Place& p, unsigned char* smem) {
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    base = smem + warp * STAGES * STAGE;
    base_u32 = smem_u32(base);
    kb = a.k + p.b * a.k_sb + (long long)p.kvh * ROWB;
    vb = a.v + p.b * a.v_sb + (long long)p.kvh * ROWB;
    k_st = a.k_st;
    v_st = a.v_st;
    if (KIND != DENSE) {
      ksb = a.ks + p.b * a.ks_sb + p.kvh;
      vsb = a.vs + p.b * a.vs_sb + p.kvh;
      ks_st = a.ks_st;
      vs_st = a.vs_st;
    }
    c_begin = p.c_begin;
    c_end = p.c_end;
    const int n_sub = (c_end - c_begin + SUB - 1) / SUB;
    n_my = n_sub > warp ? (n_sub - warp + WARPS - 1) / WARPS : 0;
  }
  __device__ __forceinline__ int first_cell(int j) const {
    return c_begin + (j * WARPS + warp) * SUB;
  }
  __device__ __forceinline__ void load(int j) {
    const int c0 = first_cell(j);
    const uint32_t dst = base_u32 + (j % STAGES) * STAGE;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int ch = lane + i * 32, c = ch / CPR, x = ch % CPR;
      const int cell = c0 + c;
      const int ok = cell < c_end ? 16 : 0;
      const long long at = ok ? cell : c_begin;  // a readable address either way
      const int off = swz<ROWB>(c, x * 16);
      cp_async16(dst + off, kb + at * k_st + x * 16, ok);
      cp_async16(dst + SUB * ROWB + off, vb + at * v_st + x * 16, ok);
    }
    if (KIND != DENSE) {
      const int cell = c0 + (lane & 15);
      const int ok = cell < c_end ? 4 : 0;
      const long long at = ok ? cell : c_begin;
      const float* src = lane < 16 ? ksb + at * ks_st : vsb + at * vs_st;
      cp_async4(dst + 2 * SUB * ROWB + lane * 4, src, ok);
    }
  }
  // Start the first STAGES - 1 tiles.
  __device__ __forceinline__ void prologue() {
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < n_my) load(j);
      cp_async_commit();
    }
  }
  // Tile j has arrived for the whole warp; the stage tile j - 1 used is
  // free, so the load of tile j + STAGES - 1 starts into it.
  __device__ __forceinline__ const unsigned char* acquire(int j) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    if (j + STAGES - 1 < n_my) load(j + STAGES - 1);
    cp_async_commit();
    return base + (j % STAGES) * STAGE;
  }
};

// The block's merged rows (acc_s: nr x D, m and l per warp in ml_s) become
// the output, or with several active chunks this chunk's part; the block
// that arrives last at the counter adds the parts in index order. The
// arrival is one acq_rel atomic by one thread after a fence and a block
// barrier.
template <typename OutT, int D, int RT, bool LOG2>
__device__ __forceinline__ void finish(const Args& a, const Place& p, const float* acc_s,
                                       float (*ml_s)[RT][2]) {
  __shared__ float row_m[RT], row_l[RT];
  __shared__ unsigned int arrived;
  const int tid = threadIdx.x;
  if (tid < p.nr) {
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, ml_s[w][tid][0]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l = fmaf(ml_s[w][tid][1], ex<LOG2>(ml_s[w][tid][0] - m), l);
    row_m[tid] = m;
    row_l[tid] = l;
  }
  __syncthreads();
  OutT* out = static_cast<OutT*>(a.out);
  auto out_at = [&](int r, int d) {
    const int row = p.r0 + r, g = row / a.S, s = row % a.S;
    return out + ((long long)(p.b * a.S + s) * a.H + p.kvh * p.G + g) * D + d;
  };
  if (p.n_act == 1) {
    for (int e = tid; e < p.nr * D; e += THREADS) {
      const int r = e / D, d = e % D;
      store_out(out_at(r, d), acc_s[e] / fmaxf(row_l[r], 1e-30f));
    }
    return;
  }
  const long long base = ((long long)p.bh * a.n_split + p.split) * p.R + p.r0;
  for (int e = tid; e < p.nr * D; e += THREADS) a.part_acc[base * D + e] = acc_s[e];
  if (tid < p.nr) {
    a.part_ml[(base + tid) * 2] = row_m[tid];
    a.part_ml[(base + tid) * 2 + 1] = row_l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned int before;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
                 : "=r"(before)
                 : "l"(a.done + p.bh * gridDim.z + blockIdx.z), "r"(p.n_act - 1)
                 : "memory");
    arrived = before;
  }
  __syncthreads();
  if (arrived != (unsigned int)(p.n_act - 1)) return;  // the counter is 0 again
  for (int e = tid; e < p.nr * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const long long at0 = (long long)p.bh * a.n_split * p.R + p.r0 + r;
    float m = NEG_INF;
    for (int j = 0; j < p.n_act; ++j)
      m = fmaxf(m, __ldcg(a.part_ml + (at0 + (long long)j * p.R) * 2));
    float l = 0.f, o = 0.f;
    for (int j = 0; j < p.n_act; ++j) {
      const long long at = at0 + (long long)j * p.R;
      const float w = ex<LOG2>(__ldcg(a.part_ml + at * 2) - m);
      l = fmaf(__ldcg(a.part_ml + at * 2 + 1), w, l);
      o = fmaf(__ldcg(a.part_acc + at * D + d), w, o);
    }
    store_out(out_at(r, d), o / fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16 queries: tensor cores
// ---------------------------------------------------------------------------

// Which d the k-step kk of thread t (lane & 3) multiplies in its slot s
// (0, 1: k index 2t, 2t + 1; 2, 3: k index 2t + 8, 2t + 9). Dense tiles
// keep the natural order; code tiles give every thread a contiguous run.
template <int KIND, int D>
__device__ __forceinline__ int k_dim(int kk, int t, int s) {
  if (KIND == DENSE) return kk * 16 + 2 * t + (s & 1) + (s >> 1) * 8;
  if (KIND == Q8) return t * (D / 4) + kk * 4 + s;
  return (kk >= D / 32 ? D / 2 : 0) + t * (D / 8) + (kk % (D / 32)) * 4 + s;
}
// Which d the column n (0..7) of output block nb holds.
template <int KIND, int D>
__device__ __forceinline__ int out_dim(int nb, int n) {
  if (KIND == DENSE) return nb * 8 + n;
  if (KIND == Q8) return n * (D / 8) + nb;
  return (nb >= D / 16 ? D / 2 : 0) + n * (D / 16) + (nb % (D / 16));
}

// B fragments of Q.K^T for one tile: kf[kk][nb] = (b0, b1) of the 8 cells
// nb * 8 .. + 7 at k-step kk.
template <int KIND, int D>
__device__ __forceinline__ void load_k_frags(uint32_t (&kf)[D / 16][2][2],
                                             const unsigned char* tile, const float* ksc,
                                             int lane) {
  constexpr int ROWB = row_bytes<KIND, D, 2>();
  if constexpr (KIND == DENSE) {
    const uint32_t tile_u32 = smem_u32(tile);
    const int lm = lane >> 3, lr = lane & 7;
    const int cell = (lm >> 1) * 8 + lr;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // matrices: (cells 0-7, d 0-7), (cells 0-7, d 8-15), (cells 8-15, d 0-7),
      // (cells 8-15, d 8-15) of this 16-column step
      uint32_t r[4];
      ldmatrix_x4(r, tile_u32 + swz<ROWB>(cell, (2 * kk + (lm & 1)) * 16));
      kf[kk][0][0] = r[0]; kf[kk][0][1] = r[1];
      kf[kk][1][0] = r[2]; kf[kk][1][1] = r[3];
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int cell = nb * 8 + g;
      const float sc = ksc[cell];
      if constexpr (KIND == Q8) {
        // D / 4 codes of this thread: word kk is k-step kk
        uint32_t w[D / 16];
#pragma unroll
        for (int i = 0; i < D / 64; ++i) {
          const uint4 x = *reinterpret_cast<const uint4*>(
              tile + swz<ROWB>(cell, t * (D / 4) + i * 16));
          w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z; w[4 * i + 3] = x.w;
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          kf[kk][nb][0] = pack_bf16(code_s8(w[kk], 0) * sc, code_s8(w[kk], 1) * sc);
          kf[kk][nb][1] = pack_bf16(code_s8(w[kk], 2) * sc, code_s8(w[kk], 3) * sc);
        }
      } else {
        // D / 8 bytes: the low nibbles of word m are k-step m, the high
        // ones k-step m + D / 32
        uint32_t w[D / 32];
        if constexpr (D == 128) {
          const uint4 x = *reinterpret_cast<const uint4*>(tile + swz<ROWB>(cell, t * 16));
          w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
        } else {
          const uint2 x = *reinterpret_cast<const uint2*>(tile + swz<ROWB>(cell, t * 8));
          w[0] = x.x; w[1] = x.y;
        }
        const float off = -8.f * sc;  // exact: (n - 8) * sc = fma(n, sc, -8 sc)
#pragma unroll
        for (int m = 0; m < D / 32; ++m) {
          const uint32_t lo = w[m] & 0x0f0f0f0fu, hi = (w[m] >> 4) & 0x0f0f0f0fu;
          kf[m][nb][0] = pack_bf16(fmaf(code_u8(lo, 0), sc, off), fmaf(code_u8(lo, 1), sc, off));
          kf[m][nb][1] = pack_bf16(fmaf(code_u8(lo, 2), sc, off), fmaf(code_u8(lo, 3), sc, off));
          kf[m + D / 32][nb][0] =
              pack_bf16(fmaf(code_u8(hi, 0), sc, off), fmaf(code_u8(hi, 1), sc, off));
          kf[m + D / 32][nb][1] =
              pack_bf16(fmaf(code_u8(hi, 2), sc, off), fmaf(code_u8(hi, 3), sc, off));
        }
      }
    }
  }
}

// B fragments of P.V for one tile: vf[nb] = (b0, b1) of output block nb.
template <int KIND, int D>
__device__ __forceinline__ void load_v_frags(uint32_t (&vf)[D / 8][2],
                                             const unsigned char* tile, const float* vsc,
                                             int lane) {
  constexpr int ROWB = row_bytes<KIND, D, 2>();
  if constexpr (KIND == DENSE) {
    const uint32_t tile_u32 = smem_u32(tile);
    const int lm = lane >> 3, lr = lane & 7;
    const int cell = (lm & 1) * 8 + lr;
#pragma unroll
    for (int d2 = 0; d2 < D / 16; ++d2) {
      // matrices: (cells 0-7, d 0-7), (cells 8-15, d 0-7), (cells 0-7, d 8-15),
      // (cells 8-15, d 8-15), each transposed on the way in
      uint32_t r[4];
      ldmatrix_x4_trans(r, tile_u32 + swz<ROWB>(cell, (2 * d2 + (lm >> 1)) * 16));
      vf[2 * d2][0] = r[0]; vf[2 * d2][1] = r[1];
      vf[2 * d2 + 1][0] = r[2]; vf[2 * d2 + 1][1] = r[3];
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    // the thread's four cells (k index 2t, 2t + 1, 2t + 8, 2t + 9) and, of
    // each, the bytes whose columns it feeds
    constexpr int NW = KIND == Q8 ? D / 32 : D / 64;  // words a cell
    uint32_t w[4][NW];
    float sc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cell = 2 * t + (i & 1) + (i >> 1) * 8;
      sc[i] = vsc[cell];
      const unsigned char* src = tile + swz<ROWB>(cell, g * NW * 4);
      if constexpr (NW == 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(src);
        w[i][0] = x.x; w[i][1] = x.y; w[i][2] = x.z; w[i][3] = x.w;
      } else if constexpr (NW == 2) {
        const uint2 x = *reinterpret_cast<const uint2*>(src);
        w[i][0] = x.x; w[i][1] = x.y;
      } else {
        w[i][0] = *reinterpret_cast<const uint32_t*>(src);
      }
    }
    if constexpr (KIND == Q8) {
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        const int m = nb / 4, s = nb % 4;
        vf[nb][0] = pack_bf16(code_s8(w[0][m], s) * sc[0], code_s8(w[1][m], s) * sc[1]);
        vf[nb][1] = pack_bf16(code_s8(w[2][m], s) * sc[2], code_s8(w[3][m], s) * sc[3]);
      }
    } else {
      float off[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) off[i] = -8.f * sc[i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {  // byte j: low nibble block j, high j + D / 16
        const int m = j / 4, s = j % 4;
        float lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = fmaf(code_u8(w[i][m] & 0x0f0f0f0fu, s), sc[i], off[i]);
          hi[i] = fmaf(code_u8((w[i][m] >> 4) & 0x0f0f0f0fu, s), sc[i], off[i]);
        }
        vf[j][0] = pack_bf16(lo[0], lo[1]);
        vf[j][1] = pack_bf16(lo[2], lo[3]);
        vf[j + D / 16][0] = pack_bf16(hi[0], hi[1]);
        vf[j + D / 16][1] = pack_bf16(hi[2], hi[3]);
      }
    }
  }
}

// In the mma fragments lane = 4 * g + t: a thread holds rows g and g + 8 of
// each 16-row tile, and of every 8 columns the pair 2t, 2t + 1.
template <int KIND, int D, int MT>
__global__ void __launch_bounds__(THREADS)
decode_mma(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RT = 16 * MT;
  constexpr int ROWB = row_bytes<KIND, D, 2>();
  using R = Ring<KIND, ROWB>;
  constexpr int RING = WARPS * R::STAGES * R::STAGE;
  constexpr int QROW = D * 2 + 16;  // padded: the rows of a fragment miss each other's banks
  constexpr int KSTEPS = D / 16, DB = D / 8;
  static_assert(RT * D * 4 <= RING, "the merged rows reuse the ring");
  __shared__ float ml_s[WARPS][RT][2];

  Place p;
  if (!place<RT>(a, p)) return;
  R ring;
  ring.init(a, p, smem);
  ring.prologue();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // q rows as bf16 in shared memory, zeros past the last row
  unsigned char* qs = smem + RING;
  {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    for (int e = tid; e < RT * (D / 8); e += THREADS) {
      const int r = e / (D / 8), x = e % (D / 8);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < p.nr) {
        const int row = p.r0 + r, gi = row / a.S, s = row % a.S;
        val = *reinterpret_cast<const uint4*>(
            q + ((long long)(p.b * a.S + s) * a.H + p.kvh * p.G + gi) * D + x * 8);
      }
      *reinterpret_cast<uint4*>(qs + r * QROW + x * 16) = val;
    }
  }
  __syncthreads();

  // A fragments of q for row tile mt at k-step kk, in the order k_dim gives
  auto q_frag = [&](int mt, int kk, uint32_t (&qa)[4]) {
    const unsigned char* ql = qs + (mt * 16 + g) * QROW;
    const unsigned char* qh = ql + 8 * QROW;
    const int d01 = k_dim<KIND, D>(kk, t, 0) * 2, d23 = k_dim<KIND, D>(kk, t, 2) * 2;
    qa[0] = *reinterpret_cast<const uint32_t*>(ql + d01);
    qa[1] = *reinterpret_cast<const uint32_t*>(qh + d01);
    qa[2] = *reinterpret_cast<const uint32_t*>(ql + d23);
    qa[3] = *reinterpret_cast<const uint32_t*>(qh + d23);
  };
  // one row tile keeps its q fragments in registers for the whole walk; two
  // re-read them from shared memory at every tile (registers go to o)
  uint32_t q_reg[MT == 1 ? KSTEPS : 1][4];
  if (MT == 1) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) q_frag(0, kk, q_reg[kk]);
  }

  const int big = 0x3fffffff;
  int qpos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int rl = mt * 16 + g, rh = rl + 8;
    qpos[mt][0] = rl < p.nr ? p.pos0 + (p.r0 + rl) % a.S : big;
    qpos[mt][1] = rh < p.nr ? p.pos0 + (p.r0 + rh) % a.S : big;
  }
  const float scale_log2 = a.scale * LOG2E;
  float o[MT][DB][4];
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_r[mt][0] = m_r[mt][1] = NEG_INF;
    l_r[mt][0] = l_r[mt][1] = 0.f;
#pragma unroll
    for (int i = 0; i < DB; ++i) o[mt][i][0] = o[mt][i][1] = o[mt][i][2] = o[mt][i][3] = 0.f;
  }

  for (int j = 0; j < ring.n_my; ++j) {
    const unsigned char* st = ring.acquire(j);
    const float* sc_s = reinterpret_cast<const float*>(st + 2 * SUB * ROWB);
    const int c0 = ring.first_cell(j);
    uint32_t pa[MT][4];
    {
      uint32_t kf[KSTEPS][2][2];
      load_k_frags<KIND, D>(kf, st, sc_s, lane);
      // the mask only where the tile crosses a position or the chunk's end
      const bool need_mask = c0 + SUB - 1 > p.pos0 || c0 + SUB > p.c_end;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float sc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t qa[4];
          if (MT == 1) {
#pragma unroll
            for (int i = 0; i < 4; ++i) qa[i] = q_reg[kk][i];
          } else {
            q_frag(mt, kk, qa);
          }
          mma_bf16(sc[0], qa, kf[kk][0][0], kf[kk][0][1]);
          mma_bf16(sc[1], qa, kf[kk][1][0], kf[kk][1][1]);
        }
        float mx_l = -INFINITY, mx_h = -INFINITY;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float s = sc[n][e] * scale_log2;
            if (need_mask) {
              const int cell = c0 + n * 8 + 2 * t + (e & 1);
              const int qp = qpos[mt][e >> 1];
              s = cell < p.c_end ? (cell <= qp ? s : NEG_INF) : -INFINITY;
            }
            sc[n][e] = s;
            if (e < 2) mx_l = fmaxf(mx_l, s); else mx_h = fmaxf(mx_h, s);
          }
        }
        const float mn_l = fmaxf(m_r[mt][0], quad_max(mx_l));
        const float mn_h = fmaxf(m_r[mt][1], quad_max(mx_h));
        const float al_l = exp2f(m_r[mt][0] - mn_l), al_h = exp2f(m_r[mt][1] - mn_h);
        m_r[mt][0] = mn_l;
        m_r[mt][1] = mn_h;
        float sum_l = 0.f, sum_h = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          sc[n][0] = exp2f(sc[n][0] - mn_l); sc[n][1] = exp2f(sc[n][1] - mn_l);
          sc[n][2] = exp2f(sc[n][2] - mn_h); sc[n][3] = exp2f(sc[n][3] - mn_h);
          sum_l += sc[n][0] + sc[n][1];
          sum_h += sc[n][2] + sc[n][3];
        }
        l_r[mt][0] = l_r[mt][0] * al_l + sum_l;  // this thread's share; summed at the end
        l_r[mt][1] = l_r[mt][1] * al_h + sum_h;
#pragma unroll
        for (int i = 0; i < DB; ++i) {
          o[mt][i][0] *= al_l; o[mt][i][1] *= al_l;
          o[mt][i][2] *= al_h; o[mt][i][3] *= al_h;
        }
        // P rounded to bf16, as the A operand of P.V
        pa[mt][0] = pack_bf16(sc[0][0], sc[0][1]);
        pa[mt][1] = pack_bf16(sc[0][2], sc[0][3]);
        pa[mt][2] = pack_bf16(sc[1][0], sc[1][1]);
        pa[mt][3] = pack_bf16(sc[1][2], sc[1][3]);
      }
    }
    uint32_t vf[DB][2];
    load_v_frags<KIND, D>(vf, st + SUB * ROWB, sc_s + SUB, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < DB; ++nb) mma_bf16(o[mt][nb], pa[mt], vf[nb][0], vf[nb][1]);
  }

  // merge the four warps in warp order
  if (t == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) ml_s[warp][mt * 16 + hh * 8 + g][0] = m_r[mt][hh];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float l = quad_sum(l_r[mt][hh]);
      if (t == 0) ml_s[warp][mt * 16 + hh * 8 + g][1] = l;
    }
  __syncthreads();  // every warp is done with its ring: acc_s may take its place
  float* acc_s = reinterpret_cast<float*>(smem);
  float f[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mt * 16 + hh * 8 + g;
      float m = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) m = fmaxf(m, ml_s[w][r][0]);
      f[mt][hh] = exp2f(m_r[mt][hh] - m);
    }
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < DB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + (e >> 1) * 8 + g;
            if (r < p.nr) {
              float* dst = acc_s + r * D + out_dim<KIND, D>(nb, 2 * t + (e & 1));
              const float val = o[mt][nb][e] * f[mt][e >> 1];
              *dst = w == 0 ? val : *dst + val;
            }
          }
    }
    __syncthreads();
  }
  finish<__nv_bfloat16, D, RT, true>(a, p, acc_s, ml_s);
}

// ---------------------------------------------------------------------------
// f32 queries: CUDA cores, exact f32 FMAs
// ---------------------------------------------------------------------------

// Four consecutive elements d0 .. d0 + 3 of one cell's K row, dequantized.
template <int KIND, int D>
__device__ __forceinline__ void k_group(const unsigned char* tile, int cell, int d0,
                                        float sc, float (&x)[4]) {
  constexpr int ROWB = row_bytes<KIND, D, 4>();
  if constexpr (KIND == DENSE) {
    const float4 f = *reinterpret_cast<const float4*>(tile + swz<ROWB>(cell, d0 * 4));
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  } else if constexpr (KIND == Q8) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(tile + swz<ROWB>(cell, d0));
#pragma unroll
    for (int s = 0; s < 4; ++s) x[s] = code_s8(w, s) * sc;
  } else {
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(tile + swz<ROWB>(cell, d0 % (D / 2)));
    const uint32_t n = (w >> (d0 >= D / 2 ? 4 : 0)) & 0x0f0f0f0fu;
#pragma unroll
    for (int s = 0; s < 4; ++s) x[s] = (code_u8(n, s) - 8.f) * sc;
  }
}

// CW = D / 32 consecutive elements from d0 of one cell's V row.
template <int KIND, int D>
__device__ __forceinline__ void v_group(const unsigned char* tile, int cell, int d0,
                                        float sc, float (&x)[D / 32]) {
  constexpr int ROWB = row_bytes<KIND, D, 4>();
  constexpr int CW = D / 32;
  if constexpr (KIND == DENSE) {
    const float* f = reinterpret_cast<const float*>(tile + swz<ROWB>(cell, d0 * 4));
    if constexpr (CW == 4) {
      const float4 y = *reinterpret_cast<const float4*>(f);
      x[0] = y.x; x[1] = y.y; x[2] = y.z; x[3] = y.w;
    } else {
      const float2 y = *reinterpret_cast<const float2*>(f);
      x[0] = y.x; x[1] = y.y;
    }
  } else {
    const int byte = KIND == Q8 ? d0 : d0 % (D / 2);
    const unsigned char* src = tile + swz<ROWB>(cell, byte);
    uint32_t w;
    if constexpr (CW == 4) w = *reinterpret_cast<const uint32_t*>(src);
    else w = *reinterpret_cast<const unsigned short*>(src);
    if constexpr (KIND == Q8) {
#pragma unroll
      for (int s = 0; s < CW; ++s) x[s] = code_s8(w, s) * sc;
    } else {
      const uint32_t n = (w >> (d0 >= D / 2 ? 4 : 0)) & 0x0f0f0f0fu;
#pragma unroll
      for (int s = 0; s < CW; ++s) x[s] = (code_u8(n, s) - 8.f) * sc;
    }
  }
}

// Score phase: lane = (cell, half of D); P.V phase: lane = D / 32 columns of
// every row. A block's RT rows (1, 4 or 16: the row loops are unrolled, and a
// row that is only padding still costs its instruction slots) sit in registers.
template <int KIND, int D, int RT>
__global__ void __launch_bounds__(THREADS)
decode_f32(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ROWB = row_bytes<KIND, D, 4>();
  using R = Ring<KIND, ROWB>;
  constexpr int RING = WARPS * R::STAGES * R::STAGE;
  constexpr int CW = D / 32;
  static_assert(RT * D * 4 <= RING, "the merged rows reuse the ring");
  __shared__ float ml_s[WARPS][RT][2];

  Place p;
  if (!place<RT>(a, p)) return;
  R ring;
  ring.init(a, p, smem);
  ring.prologue();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* qs = reinterpret_cast<float*>(smem + RING);  // RT x D
  {
    const float* q = static_cast<const float*>(a.q);
    for (int e = tid; e < p.nr * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const int row = p.r0 + r, gi = row / a.S, s = row % a.S;
      qs[e] = q[((long long)(p.b * a.S + s) * a.H + p.kvh * p.G + gi) * D + d];
    }
  }
  __syncthreads();

  const int cell = lane & 15, half = lane >> 4;
  float m_r[RT], l_r[RT], acc[RT][CW];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m_r[r] = NEG_INF;
    l_r[r] = 0.f;
#pragma unroll
    for (int i = 0; i < CW; ++i) acc[r][i] = 0.f;
  }

  for (int j = 0; j < ring.n_my; ++j) {
    const unsigned char* st = ring.acquire(j);
    const float* sc_s = reinterpret_cast<const float*>(st + 2 * SUB * ROWB);
    const int c0 = ring.first_cell(j);
    float prob[RT];  // first the dot products, then the probabilities
#pragma unroll
    for (int r = 0; r < RT; ++r) prob[r] = 0.f;
    {
      const float ksc = KIND == DENSE ? 1.f : sc_s[cell];
#pragma unroll 4
      for (int i = 0; i < D / 8; ++i) {
        const int d0 = half * (D / 2) + 4 * i;
        float kx[4];
        k_group<KIND, D>(st, cell, d0, ksc, kx);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < p.nr) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + d0);
            prob[r] = fmaf(qv.x, kx[0], prob[r]);
            prob[r] = fmaf(qv.y, kx[1], prob[r]);
            prob[r] = fmaf(qv.z, kx[2], prob[r]);
            prob[r] = fmaf(qv.w, kx[3], prob[r]);
          }
        }
      }
    }
    const int cg = c0 + cell;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < p.nr) {
        const float dot = prob[r] + __shfl_xor_sync(FULL, prob[r], 16);
        const int qpos = p.pos0 + (p.r0 + r) % a.S;
        const float s = cg < p.c_end ? (cg <= qpos ? dot * a.scale : NEG_INF) : -INFINITY;
        float mx = s;
#pragma unroll
        for (int x = 8; x > 0; x >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, x));
        const float m_new = fmaxf(m_r[r], mx);
        const float pv = expf(s - m_new);
        const float alpha = expf(m_r[r] - m_new);
        float sum = pv;
#pragma unroll
        for (int x = 8; x > 0; x >>= 1) sum += __shfl_xor_sync(FULL, sum, x);
        l_r[r] = l_r[r] * alpha + sum;
        m_r[r] = m_new;
#pragma unroll
        for (int i = 0; i < CW; ++i) acc[r][i] *= alpha;
        prob[r] = pv;
      }
    }
    const unsigned char* vt = st + SUB * ROWB;
#pragma unroll 4
    for (int c = 0; c < SUB; ++c) {
      float vx[CW];
      v_group<KIND, D>(vt, c, lane * CW, KIND == DENSE ? 1.f : sc_s[SUB + c], vx);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < p.nr) {
          const float pv = __shfl_sync(FULL, prob[r], c);
#pragma unroll
          for (int i = 0; i < CW; ++i) acc[r][i] = fmaf(pv, vx[i], acc[r][i]);
        }
      }
    }
  }

  // merge the four warps in warp order
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      ml_s[warp][r][0] = m_r[r];
      ml_s[warp][r][1] = l_r[r];
    }
  }
  __syncthreads();  // every warp is done with its ring: acc_s may take its place
  float* acc_s = reinterpret_cast<float*>(smem);
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < p.nr) {
          float m = NEG_INF;
#pragma unroll
          for (int w2 = 0; w2 < WARPS; ++w2) m = fmaxf(m, ml_s[w2][r][0]);
          const float f = expf(m_r[r] - m);
#pragma unroll
          for (int i = 0; i < CW; ++i) {
            float* dst = acc_s + r * D + lane * CW + i;
            const float val = acc[r][i] * f;
            *dst = w == 0 ? val : *dst + val;
          }
        }
      }
    }
    __syncthreads();
  }
  finish<float, D, RT, false>(a, p, acc_s, ml_s);
}

template <typename K>
int allow_smem(K kernel, size_t smem, size_t* set) {
  if (smem <= *set) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *set = smem;
  return (int)e;
}

template <int KIND, int D, int MT>
int launch_mma(const Args& a, int B, cudaStream_t st) {
  constexpr int ROWB = row_bytes<KIND, D, 2>();
  constexpr int RT = 16 * MT;
  const size_t smem = (size_t)WARPS * n_stages(ROWB) * stage_bytes<KIND, ROWB>() +
                      (size_t)RT * (D * 2 + 16);
  static size_t smem_set = 48 * 1024;  // the default limit for dynamic smem
  const int e = allow_smem(decode_mma<KIND, D, MT>, smem, &smem_set);
  if (e) return e;
  const int R = (a.H / a.KVH) * a.S;
  decode_mma<KIND, D, MT><<<dim3(B * a.KVH, a.n_split, (R + RT - 1) / RT), THREADS, smem,
                            st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, int D, int RT>
int launch_f32(const Args& a, int B, cudaStream_t st) {
  constexpr int ROWB = row_bytes<KIND, D, 4>();
  const size_t smem = (size_t)WARPS * n_stages(ROWB) * stage_bytes<KIND, ROWB>() +
                      (size_t)RT * D * 4;
  static size_t smem_set = 48 * 1024;
  const int e = allow_smem(decode_f32<KIND, D, RT>, smem, &smem_set);
  if (e) return e;
  const int R = (a.H / a.KVH) * a.S;
  decode_f32<KIND, D, RT><<<dim3(B * a.KVH, a.n_split, (R + RT - 1) / RT), THREADS, smem,
                            st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, int D>
int launch(const Args& a, int bf16, int B, cudaStream_t st) {
  const int R = (a.H / a.KVH) * a.S;
  if (!bf16)
    return R == 1 ? launch_f32<KIND, D, 1>(a, B, st)
                  : (R <= 4 ? launch_f32<KIND, D, 4>(a, B, st) : launch_f32<KIND, D, 16>(a, B, st));
  // one 16-row tile where the folded rows fit it, else tiles of 32
  return R <= 16 ? launch_mma<KIND, D, 1>(a, B, st) : launch_mma<KIND, D, 2>(a, B, st);
}

}  // namespace

// q (B, S, H, D) contiguous, bf16 (bf16 = 1) or f32; k, v (B, T, KVH, D)
// with byte strides (k_sb, k_st) / (v_sb, v_st) for the batch and cell axes,
// KVH and D contiguous: of q's type (kind 0), int8 codes (kind 1) or packed
// nibbles (kind 2), the last two with f32 scales ks, vs (B, T, KVH) and
// their element strides; pos (B, S) int32 on the device; out like q. The T
// axis is cut into n_split chunks of split_len cells (a multiple of 16). For
// n_split > 1: scratch part_acc (B*KVH, n_split, R, D) and part_ml
// (B*KVH, n_split, R, 2) f32, and `done`, B*KVH*row tiles counters that are
// zero between launches (row tiles for bf16: 16 rows, 32 with R > 16; for f32:
// 1, 4 or 16 rows, the least that holds R, 16 beyond).
// Returns cudaGetLastError().
extern "C" int prima_flash_decode(
    const void* q, const void* k, const void* v, const float* ks, const float* vs,
    const int* pos, void* out, float* part_acc, float* part_ml, unsigned int* done,
    int bf16, int kind, int D, int B, int S, int H, int KVH, int T, long long k_sb,
    long long k_st, long long v_sb, long long v_st, long long ks_sb, long long ks_st,
    long long vs_sb, long long vs_st, int kv_blk, int split_len, int n_split,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || split_len < SUB || split_len % SUB ||
      (n_split > 1 && (!part_acc || !part_ml || !done)) || (kind != DENSE && (!ks || !vs)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, static_cast<const unsigned char*>(k), static_cast<const unsigned char*>(v),
               ks, vs, pos, out, part_acc, part_ml, done, S, H, KVH, T, k_sb, k_st, v_sb,
               v_st, ks_sb, ks_st, vs_sb, vs_st, kv_blk, split_len, n_split, scale};
#define PRIMA_FD(KIND, DIM) \
  if (kind == KIND && D == DIM) return launch<KIND, DIM>(a, bf16, B, st)
  PRIMA_FD(DENSE, 128);
  PRIMA_FD(DENSE, 64);
  PRIMA_FD(Q8, 128);
  PRIMA_FD(Q8, 64);
  PRIMA_FD(Q4, 128);
  PRIMA_FD(Q4, 64);
#undef PRIMA_FD
  return (int)cudaErrorInvalidValue;
}
