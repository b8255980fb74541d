// Native GGUF block converter: raw quant blocks -> the port's device layout.
//
// The load-time hot path (the role ggml-quants.c's dequant/repack routines
// play in the reference): decodes Q4_K / Q6_K / Q8_0 / Q4_0 blocks and
// emits the layout of prima_tpu_torch/quant/qtensor.py in natural column
// order (the Hopper GEMV never permutes columns). Multithreaded over rows
// with plain std::thread; exposed through a C ABI for ctypes.
//
// Bit-exactness contract: every output equals the numpy route's
// (quant/device_format.py to_device_format, then qtensor.pack_scales_np),
// which follows ggml's C.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// f16 (IEEE binary16, little-endian) -> f32
inline float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;
        } else {  // subnormal
            exp = 127 - 15 + 1;
            while (!(mant & 0x400)) { mant <<= 1; exp--; }
            mant &= 0x3FF;
            bits = sign | (exp << 23) | (mant << 13);
        }
    } else if (exp == 0x1F) {
        bits = sign | 0x7F800000u | (mant << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float out;
    std::memcpy(&out, &bits, sizeof(out));
    return out;
}

inline uint16_t rd16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}

// Q4_K scale/min unpack (get_scale_min_k4, ggml-quants.c)
inline void scale_min_k4(const uint8_t* q, int j, uint8_t* sc, uint8_t* m) {
    if (j < 4) {
        *sc = q[j] & 63;
        *m = q[j + 4] & 63;
    } else {
        *sc = (q[j + 4] & 0xF) | ((q[j - 4] >> 6) << 4);
        *m = (q[j + 4] >> 4) | ((q[j] >> 6) << 4);
    }
}

template <typename F>
void parallel_rows(int64_t rows, F fn) {
    unsigned n = std::thread::hardware_concurrency();
    if (n == 0) n = 4;
    if (n > 32) n = 32;
    if (rows < (int64_t)n * 4) { fn(0, rows); return; }
    std::vector<std::thread> ts;
    int64_t chunk = (rows + n - 1) / n;
    for (unsigned i = 0; i < n; i++) {
        int64_t r0 = i * chunk, r1 = std::min<int64_t>(rows, r0 + chunk);
        if (r0 >= r1) break;
        ts.emplace_back(fn, r0, r1);
    }
    for (auto& t : ts) t.join();
}

// A row's q values in natural column order, block by block (the layouts
// of ggml-quants.c's dequantize_row_q4_K / q4_0 / q6_K).
inline void q4k_row(const uint8_t* rb, int64_t k, uint8_t* v) {
    for (int64_t c0 = 0; c0 < k; c0 += 256) {
        const uint8_t* q = rb + (c0 / 256) * 144 + 16;
        for (int g = 0; g < 4; g++)
            for (int l = 0; l < 32; l++) {
                v[c0 + g * 64 + l] = q[g * 32 + l] & 0x0F;
                v[c0 + g * 64 + 32 + l] = q[g * 32 + l] >> 4;
            }
    }
}

inline void q4_0_row(const uint8_t* rb, int64_t k, uint8_t* v) {
    for (int64_t c0 = 0; c0 < k; c0 += 32) {
        const uint8_t* q = rb + (c0 / 32) * 18 + 2;
        for (int l = 0; l < 16; l++) {
            v[c0 + l] = q[l] & 0x0F;
            v[c0 + 16 + l] = q[l] >> 4;
        }
    }
}

inline void q6k_row(const uint8_t* rb, int64_t k, int8_t* v) {
    for (int64_t c0 = 0; c0 < k; c0 += 256) {
        const uint8_t* b = rb + (c0 / 256) * 210;
        for (int h = 0; h < 2; h++) {  // two halves of 128 columns
            const uint8_t* ql = b + h * 64;
            const uint8_t* qh = b + 128 + h * 32;
            int8_t* o = v + c0 + h * 128;
            for (int l = 0; l < 32; l++) {
                o[l] = (int8_t)(((ql[l] & 0x0F) | ((qh[l] >> 0) & 3) << 4) - 32);
                o[32 + l] = (int8_t)(((ql[32 + l] & 0x0F) | ((qh[l] >> 2) & 3) << 4) - 32);
                o[64 + l] = (int8_t)(((ql[l] >> 4) | ((qh[l] >> 4) & 3) << 4) - 32);
                o[96 + l] = (int8_t)(((ql[32 + l] >> 4) | ((qh[l] >> 6) & 3) << 4) - 32);
            }
        }
    }
}

// nib4 codes: byte j holds column j (low nibble) and column j + k/2 (high)
inline void pack_nib4(const uint8_t* v, int64_t k, uint8_t* q_out) {
    const int64_t half = k / 2;
    for (int64_t j = 0; j < half; j++)
        q_out[j] = (uint8_t)(v[j] | (v[j + half] << 4));
}

}  // namespace

extern "C" {

// Q4_K: raw (rows, k/256*144) -> qs nib4 (rows, k/2) and, by sub-block s
// of 32 columns (S = k/32, G = k/256 superblocks):
// packed = 0: 6-bit scale / min codes int8 (rows, S), superblock bases
//   d / dmin f32 (rows, G); the effective scale d*code is one f32
//   multiply on the device (the reference's rounding).
// packed = 1 (S % 16 == 0): the 4.5-bit footprint of pack_scales_np:
//   scales u8 (rows, S) = sc | (mn >> 4) << 6; mins u8 (rows, S/2) =
//   lo4(mn[s]) | lo4(mn[s + S/2]) << 4; d i32 (rows, G) = the raw f16
//   bits dmin << 16 | d; dmin_out unused.
void prima_torch_conv_q4k(const uint8_t* raw, int64_t rows, int64_t k,
                          uint8_t* qs, uint8_t* scales, uint8_t* mins,
                          void* d_out, float* dmin_out, int packed) {
    const int64_t row_bytes = (k / 256) * 144;
    const int64_t S = k / 32;
    const int64_t G = k / 256;
    parallel_rows(rows, [&](int64_t r0, int64_t r1) {
        std::vector<uint8_t> sc_tmp(S), mn_tmp(S), v(k);
        for (int64_t r = r0; r < r1; r++) {
            const uint8_t* rb = raw + r * row_bytes;
            for (int64_t blk = 0; blk < G; blk++) {
                const uint8_t* b = rb + blk * 144;
                if (packed) {
                    ((uint32_t*)d_out)[r * G + blk] =
                        (uint32_t)rd16(b + 2) << 16 | rd16(b);
                } else {
                    ((float*)d_out)[r * G + blk] = f16_to_f32(rd16(b));
                    dmin_out[r * G + blk] = f16_to_f32(rd16(b + 2));
                }
                for (int j = 0; j < 8; j++)
                    scale_min_k4(b + 4, j, &sc_tmp[blk * 8 + j], &mn_tmp[blk * 8 + j]);
            }
            uint8_t* sc_out = scales + r * S;
            if (packed) {
                uint8_t* mn_out = mins + r * (S / 2);
                for (int64_t s = 0; s < S; s++)
                    sc_out[s] = (uint8_t)(sc_tmp[s] | ((mn_tmp[s] >> 4) << 6));
                for (int64_t s = 0; s < S / 2; s++)
                    mn_out[s] = (uint8_t)((mn_tmp[s] & 0xF) | ((mn_tmp[s + S / 2] & 0xF) << 4));
            } else {
                std::memcpy(sc_out, sc_tmp.data(), S);
                std::memcpy(mins + r * S, mn_tmp.data(), S);
            }
            q4k_row(rb, k, v.data());
            pack_nib4(v.data(), k, qs + r * (k / 2));
        }
    });
}

// Q4_0: raw (rows, k/32*18) -> qs nib4 (rows, k/2), scales f32 (rows, k/32)
void prima_torch_conv_q4_0(const uint8_t* raw, int64_t rows, int64_t k,
                           uint8_t* qs, float* scales) {
    const int64_t row_bytes = (k / 32) * 18;
    const int64_t S = k / 32;
    parallel_rows(rows, [&](int64_t r0, int64_t r1) {
        std::vector<uint8_t> v(k);
        for (int64_t r = r0; r < r1; r++) {
            const uint8_t* rb = raw + r * row_bytes;
            for (int64_t blk = 0; blk < S; blk++)
                scales[r * S + blk] = f16_to_f32(rd16(rb + blk * 18));
            q4_0_row(rb, k, v.data());
            pack_nib4(v.data(), k, qs + r * (k / 2));
        }
    });
}

// Q6_K: raw (rows, k/256*210) -> qs int8 (rows, k), int8 scale codes
// (rows, k/16) and superblock base d f32 (rows, k/256)
void prima_torch_conv_q6k(const uint8_t* raw, int64_t rows, int64_t k,
                          int8_t* qs, int8_t* scales, float* d_out) {
    const int64_t row_bytes = (k / 256) * 210;
    const int64_t S = k / 16;
    const int64_t G = k / 256;
    parallel_rows(rows, [&](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; r++) {
            const uint8_t* rb = raw + r * row_bytes;
            for (int64_t blk = 0; blk < G; blk++) {
                const uint8_t* b = rb + blk * 210;
                d_out[r * G + blk] = f16_to_f32(rd16(b + 208));
                std::memcpy(scales + r * S + blk * 16, b + 192, 16);
            }
            q6k_row(rb, k, qs + r * k);
        }
    });
}

// Q8_0: raw (rows, k/32*34) -> qs int8 (rows, k), scales f32 (rows, k/32)
void prima_torch_conv_q8_0(const uint8_t* raw, int64_t rows, int64_t k,
                           int8_t* qs, float* scales) {
    const int64_t row_bytes = (k / 32) * 34;
    const int64_t S = k / 32;
    parallel_rows(rows, [&](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; r++) {
            const uint8_t* rb = raw + r * row_bytes;
            for (int64_t blk = 0; blk < S; blk++) {
                scales[r * S + blk] = f16_to_f32(rd16(rb + blk * 34));
                std::memcpy(qs + r * k + blk * 32, rb + blk * 34 + 2, 32);
            }
        }
    });
}

}  // extern "C"
