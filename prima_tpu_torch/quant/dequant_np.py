"""Bit-exact numpy reference dequantization for GGUF/GGML block formats.

Each function takes raw block bytes shaped (n_rows, row_bytes) uint8 and the
per-row element count, and returns float32 (n_rows, n). The arithmetic orders
match the reference scalar implementations (ggml/src/ggml-quants.c:
dequantize_row_q4_0 @1522, q4_1 @1542, q5_0 @1563, q5_1 @1589, q8_0 @1616,
q2_K @1979, q3_K @2327, q4_K @2555, q5_K @2763, q6_K @2977, iq2_xxs @3503,
iq1_s @3665, iq1_m @3690, iq4_nl @3742, iq4_xs @3760) so results are
bit-identical to the reference compiled with strict IEEE f32 (-ffp-contract=off).

All implementations are original, fully vectorized numpy.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ..gguf.constants import GGMLType, QK_K, TYPE_TRAITS

_CODEBOOK_DIR = os.path.join(os.path.dirname(__file__), "codebooks")

F32 = np.float32


@functools.lru_cache(maxsize=None)
def _codebook(name: str) -> np.ndarray:
    """Load an extracted constant codebook table (see tools/extract_codebooks.py)."""
    path = os.path.join(_CODEBOOK_DIR, f"{name}.npy")
    arr = np.load(path)
    arr.flags.writeable = False
    return arr


def _f16(raw_pairs: np.ndarray) -> np.ndarray:
    """Interpret little-endian byte pairs (..., 2) as f16, widen to f32."""
    return raw_pairs.copy().view(np.float16).astype(np.float32)


def _blocks(raw: np.ndarray, type_size: int) -> np.ndarray:
    """(n_rows, row_bytes) -> (n_blocks_total, type_size)."""
    n_rows, row_bytes = raw.shape
    assert row_bytes % type_size == 0
    return raw.reshape(n_rows * (row_bytes // type_size), type_size)


# -------------------------------------------------------------------------
# 32-element legacy formats
# -------------------------------------------------------------------------


def dequant_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2])  # (nb, 1)
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int32) - 8
    hi = (qs >> 4).astype(np.int32) - 8
    q = np.concatenate([lo, hi], axis=1).astype(F32)
    return (q * d).reshape(raw.shape[0], n)


def dequant_q4_1(raw: np.ndarray, n: int) -> np.ndarray:
    b = _blocks(raw, 20)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:20]
    lo = (qs & 0x0F).astype(F32)
    hi = (qs >> 4).astype(F32)
    q = np.concatenate([lo, hi], axis=1)
    return (q * d + m).reshape(raw.shape[0], n)


def dequant_q5_0(raw: np.ndarray, n: int) -> np.ndarray:
    b = _blocks(raw, 22)
    d = _f16(b[:, 0:2])
    qh = b[:, 2:6].copy().view(np.uint32)  # (nb, 1)
    qs = b[:, 6:22]
    j = np.arange(16, dtype=np.uint32)
    xh0 = ((qh >> j) << 4) & 0x10
    xh1 = (qh >> (j + 12)) & 0x10
    x0 = ((qs & 0x0F) | xh0.astype(np.uint8)).astype(np.int32) - 16
    x1 = ((qs >> 4) | xh1.astype(np.uint8)).astype(np.int32) - 16
    q = np.concatenate([x0, x1], axis=1).astype(F32)
    return (q * d).reshape(raw.shape[0], n)


def dequant_q5_1(raw: np.ndarray, n: int) -> np.ndarray:
    b = _blocks(raw, 24)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qh = b[:, 4:8].copy().view(np.uint32)
    qs = b[:, 8:24]
    j = np.arange(16, dtype=np.uint32)
    xh0 = ((qh >> j) << 4) & 0x10
    xh1 = (qh >> (j + 12)) & 0x10
    x0 = ((qs & 0x0F) | xh0.astype(np.uint8)).astype(F32)
    x1 = ((qs >> 4) | xh1.astype(np.uint8)).astype(F32)
    q = np.concatenate([x0, x1], axis=1)
    return (q * d + m).reshape(raw.shape[0], n)


def dequant_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    b = _blocks(raw, 34)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].copy().view(np.int8).astype(F32)
    return (qs * d).reshape(raw.shape[0], n)


# -------------------------------------------------------------------------
# K-quants (256-element super-blocks)
# -------------------------------------------------------------------------


def _get_scale_min_k4(scales12: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack 12 packed bytes into 8 (scale, min) 6-bit pairs.

    Matches get_scale_min_k4 (ggml-quants.c:1898).
    scales12: (nb, 12) uint8 -> (sc, m) each (nb, 8) int32.
    """
    q = scales12.astype(np.int32)
    sc = np.empty(q.shape[:-1] + (8,), dtype=np.int32)
    m = np.empty_like(sc)
    sc[..., :4] = q[..., 0:4] & 63
    m[..., :4] = q[..., 4:8] & 63
    sc[..., 4:] = (q[..., 8:12] & 0x0F) | ((q[..., 0:4] >> 6) << 4)
    m[..., 4:] = (q[..., 8:12] >> 4) | ((q[..., 4:8] >> 6) << 4)
    return sc, m


def dequant_q4_k(raw: np.ndarray, n: int) -> np.ndarray:
    b = _blocks(raw, 144)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])  # (nb,1)
    dmin = _f16(b[:, 2:4])
    sc, mn = _get_scale_min_k4(b[:, 4:16])  # (nb,8)
    qs = b[:, 16:144]  # (nb,128)
    d_sub = d * sc.astype(F32)  # (nb,8) — d*sc rounded once, as in C
    m_sub = dmin * mn.astype(F32)
    # layout: 4 groups of 64; group g: qs[32g:32g+32] low nibble -> sub 2g, high -> 2g+1
    qs4 = qs.reshape(nb, 4, 32)
    lo = (qs4 & 0x0F).astype(F32)
    hi = (qs4 >> 4).astype(F32)
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32)  # sub-block order
    y = q * d_sub[:, :, None] - m_sub[:, :, None]
    return y.reshape(raw.shape[0], n)


def dequant_q5_k(raw: np.ndarray, n: int) -> np.ndarray:
    b = _blocks(raw, 176)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _get_scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]  # (nb,32)
    qs = b[:, 48:176]  # (nb,128)
    d_sub = d * sc.astype(F32)
    m_sub = dmin * mn.astype(F32)
    qs4 = qs.reshape(nb, 4, 32)
    lo = (qs4 & 0x0F).astype(np.int32)
    hi = (qs4 >> 4).astype(np.int32)
    # u1 = 1<<(2g), u2 = 2<<(2g) bit masks on the same 32 qh bytes
    g = np.arange(4)
    u1 = (1 << (2 * g)).astype(np.uint8)[None, :, None]
    u2 = (2 << (2 * g)).astype(np.uint8)[None, :, None]
    hb1 = np.where((qh[:, None, :] & u1) != 0, 16, 0)
    hb2 = np.where((qh[:, None, :] & u2) != 0, 16, 0)
    q = np.stack([lo + hb1, hi + hb2], axis=2).reshape(nb, 8, 32).astype(F32)
    y = q * d_sub[:, :, None] - m_sub[:, :, None]
    return y.reshape(raw.shape[0], n)


def dequant_q6_k(raw: np.ndarray, n: int) -> np.ndarray:
    b = _blocks(raw, 210)
    nb = b.shape[0]
    ql = b[:, 0:128].reshape(nb, 2, 64)  # two 128-elem halves
    qh = b[:, 128:192].reshape(nb, 2, 32)
    sc = b[:, 192:208].copy().view(np.int8).reshape(nb, 2, 8).astype(np.int32)
    d = _f16(b[:, 208:210])  # (nb,1)
    l = np.arange(32)
    is_ = l // 16  # (32,)
    q1 = ((ql[:, :, 0:32] & 0x0F) | (((qh >> 0) & 3) << 4)).astype(np.int8).astype(np.int32) - 32
    q2 = ((ql[:, :, 32:64] & 0x0F) | (((qh >> 2) & 3) << 4)).astype(np.int8).astype(np.int32) - 32
    q3 = ((ql[:, :, 0:32] >> 4) | (((qh >> 4) & 3) << 4)).astype(np.int8).astype(np.int32) - 32
    q4 = ((ql[:, :, 32:64] >> 4) | (((qh >> 6) & 3) << 4)).astype(np.int8).astype(np.int32) - 32
    y = np.empty((nb, 2, 128), dtype=F32)
    dd = d[:, :, None]  # (nb,1,1)
    for qi, q, soff in ((0, q1, 0), (1, q2, 2), (2, q3, 4), (3, q4, 6)):
        scale = np.take_along_axis(sc, (is_ + soff)[None, None, :], axis=2).astype(F32)
        y[:, :, 32 * qi : 32 * qi + 32] = (dd * scale) * q.astype(F32)
    return y.reshape(raw.shape[0], n)


def dequant_q2_k(raw: np.ndarray, n: int) -> np.ndarray:
    b = _blocks(raw, 84)
    nb = b.shape[0]
    scales = b[:, 0:16].astype(np.int32)  # (nb,16): low4=scale, high4=min
    qs = b[:, 16:80].reshape(nb, 2, 32)  # two halves of 32 bytes
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    dl = d * (scales & 0x0F).astype(F32)  # (nb,16)
    ml = dmin * (scales >> 4).astype(F32)
    y = np.empty((nb, 256), dtype=F32)
    for h in range(2):
        for j in range(4):
            shift = 2 * j
            for half16 in range(2):
                s_idx = 8 * h + 2 * j + half16
                qbytes = qs[:, h, 16 * half16 : 16 * half16 + 16]
                q = ((qbytes >> shift) & 3).astype(F32)
                out = q * dl[:, s_idx : s_idx + 1] - ml[:, s_idx : s_idx + 1]
                base = 128 * h + 32 * j + 16 * half16
                y[:, base : base + 16] = out
    return y.reshape(raw.shape[0], n)


def _q3k_scales(sb: np.ndarray) -> np.ndarray:
    """Unpack q3_K 12-byte packed 6-bit scales to (nb, 16) int32 (0..63)."""
    a = sb.astype(np.int32)
    s = np.empty(a.shape[:-1] + (16,), dtype=np.int32)
    i = np.arange(4)
    s[..., 0:4] = (a[..., 0:4] & 0x0F) | ((a[..., 8:12] & 3) << 4)
    s[..., 4:8] = (a[..., 4:8] & 0x0F) | (((a[..., 8:12] >> 2) & 3) << 4)
    s[..., 8:12] = (a[..., 0:4] >> 4) | (((a[..., 8:12] >> 4) & 3) << 4)
    s[..., 12:16] = (a[..., 4:8] >> 4) | (((a[..., 8:12] >> 6) & 3) << 4)
    del i
    return s


def dequant_q3_k(raw: np.ndarray, n: int) -> np.ndarray:
    b = _blocks(raw, 110)
    nb = b.shape[0]
    hmask = b[:, 0:32]  # (nb,32)
    qs = b[:, 32:96].reshape(nb, 2, 32)
    scales = _q3k_scales(b[:, 96:108])  # (nb,16)
    d_all = _f16(b[:, 108:110])
    dl = d_all * (scales - 32).astype(F32)  # (nb,16)
    y = np.empty((nb, 256), dtype=F32)
    for h in range(2):
        for j in range(4):
            shift = 2 * j
            mbit = np.uint8(1 << (4 * h + j))
            for half16 in range(2):
                s_idx = 8 * h + 2 * j + half16
                qbytes = qs[:, h, 16 * half16 : 16 * half16 + 16]
                hbytes = hmask[:, 16 * half16 : 16 * half16 + 16]
                q = ((qbytes >> shift) & 3).astype(np.int32) - np.where(
                    (hbytes & mbit) != 0, 0, 4
                )
                base = 128 * h + 32 * j + 16 * half16
                y[:, base : base + 16] = q.astype(F32) * dl[:, s_idx : s_idx + 1]
    return y.reshape(raw.shape[0], n)


def dequant_q8_k(raw: np.ndarray, n: int) -> np.ndarray:
    b = _blocks(raw, 292)
    d = b[:, 0:4].copy().view(np.float32)
    qs = b[:, 4:260].copy().view(np.int8).astype(F32)
    return (qs * d).reshape(raw.shape[0], n)


# -------------------------------------------------------------------------
# Ternary formats (BitNet b1.58)
# -------------------------------------------------------------------------


def _tq1_trits(q: np.ndarray, n_trits: int) -> np.ndarray:
    """Extract the first n_trits base-3 digits of the ceil-scaled byte:
    digit n = ((q * 3^n mod 256) * 3) >> 8, shifted to {-1,0,1}
    (dequantize_row_tq1_0, ggml-quants.c:3443 — the fixed-point trick
    relies on q being ceil(v * 256/243))."""
    pow3 = np.array([1, 3, 9, 27, 81], np.uint16)[:n_trits]
    v = (q[:, None, :].astype(np.uint16) * pow3[None, :, None]) & 0xFF
    return ((v * 3) >> 8).astype(np.int32) - 1


def dequant_tq1_0(raw: np.ndarray, n: int) -> np.ndarray:
    """TQ1_0: 1.69 bpw ternary — 48 bytes of 5-elements-per-byte base-3
    packing + 4 bytes of 4-per-byte + f16 amax scale (block_tq1_0,
    ggml-common.h:234-240)."""
    b = _blocks(raw, 54)
    nb = b.shape[0]
    e0 = _tq1_trits(b[:, 0:32], 5).reshape(nb, 160)    # elems 0..159
    e1 = _tq1_trits(b[:, 32:48], 5).reshape(nb, 80)    # elems 160..239
    e2 = _tq1_trits(b[:, 48:52], 4).reshape(nb, 16)    # elems 240..255
    d = _f16(b[:, 52:54])
    q = np.concatenate([e0, e1, e2], axis=1).astype(F32)
    return (q * d).reshape(raw.shape[0], n)


def dequant_tq2_0(raw: np.ndarray, n: int) -> np.ndarray:
    """TQ2_0: 2.06 bpw ternary — 2 bits per element along 32-byte chunks
    + f16 amax scale (block_tq2_0, ggml-common.h:243-247)."""
    b = _blocks(raw, 66)
    nb = b.shape[0]
    qs = b[:, 0:64].reshape(nb, 2, 1, 32)
    shifts = (2 * np.arange(4, dtype=np.uint8)).reshape(1, 1, 4, 1)
    q = ((qs >> shifts) & 3).reshape(nb, 256).astype(np.int32) - 1
    d = _f16(b[:, 64:66])
    return (q.astype(F32) * d).reshape(raw.shape[0], n)


# -------------------------------------------------------------------------
# IQ formats (codebook-based)
# -------------------------------------------------------------------------

IQ1S_DELTA = np.float32(0.125)


def dequant_iq4_nl(raw: np.ndarray, n: int) -> np.ndarray:
    kvalues = _codebook("kvalues_iq4nl").astype(np.int32)  # (16,) int8 values
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:18]
    lo = kvalues[qs & 0x0F].astype(F32)
    hi = kvalues[qs >> 4].astype(F32)
    q = np.concatenate([lo, hi], axis=1)
    return (q * d).reshape(raw.shape[0], n)


def dequant_iq4_xs(raw: np.ndarray, n: int) -> np.ndarray:
    kvalues = _codebook("kvalues_iq4nl").astype(np.int32)
    b = _blocks(raw, 136)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])  # (nb,1)
    scales_h = b[:, 2:4].copy().view(np.uint16).astype(np.int32)  # (nb,1)
    scales_l = b[:, 4:8].astype(np.int32)  # (nb,4)
    qs = b[:, 8:136].reshape(nb, 8, 16)
    ib = np.arange(8)
    ls_lo = (scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F
    ls_hi = ((scales_h >> (2 * ib)) & 3) << 4
    ls = ls_lo | ls_hi  # (nb,8)
    dl = d * (ls - 32).astype(F32)  # (nb,8)
    lo = kvalues[qs & 0x0F].astype(F32)
    hi = kvalues[qs >> 4].astype(F32)
    q = np.concatenate([lo, hi], axis=2)  # (nb,8,32)
    y = q * dl[:, :, None]
    return y.reshape(raw.shape[0], n)


def dequant_iq2_xxs(raw: np.ndarray, n: int) -> np.ndarray:
    grid = _codebook("iq2xxs_grid")  # (256,) uint64
    grid_bytes = grid.view(np.uint8).reshape(256, 8).astype(np.int32)
    ksigns = _codebook("ksigns_iq2xs").astype(np.uint8)  # (128,)
    b = _blocks(raw, 66)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])  # (nb,1)
    qs = b[:, 2:66].copy().view(np.uint32).reshape(nb, 8, 2)  # 8 groups x (aux0, aux1)
    aux0 = qs[:, :, 0]
    aux1 = qs[:, :, 1]
    db = (d * (np.float32(0.5) + (aux1 >> 28).astype(F32))) * np.float32(0.25)  # (nb,8)
    # 4 sub-groups of 8 elems per group
    idx = np.stack([(aux0 >> (8 * l)) & 0xFF for l in range(4)], axis=2)  # (nb,8,4)
    sbits = np.stack([(aux1 >> (7 * l)) & 127 for l in range(4)], axis=2)
    mag = grid_bytes[idx]  # (nb,8,4,8)
    signs = ksigns[sbits]  # (nb,8,4)
    j = np.arange(8, dtype=np.uint8)
    sign = np.where((signs[..., None] & (1 << j)) != 0, np.float32(-1.0), np.float32(1.0))
    y = db[:, :, None, None] * mag.astype(F32) * sign
    return y.reshape(raw.shape[0], n)


def dequant_iq2_xs(raw: np.ndarray, n: int) -> np.ndarray:
    """IQ2_XS (2.3125 bpw): dequantize_row_iq2_xs ggml-quants.c:3531.
    Per u16: 9-bit index into the 512-entry iq2xs_grid + 7-bit ksigns code;
    4-bit scale nibble per 16 elements."""
    grid_bytes = _codebook("iq2xs_grid").view(np.uint8).reshape(512, 8).astype(np.int32)
    ksigns = _codebook("ksigns_iq2xs").astype(np.uint8)
    b = _blocks(raw, 74)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])  # (nb,1)
    qs = b[:, 2:66].copy().view(np.uint16).reshape(nb, 8, 4).astype(np.int32)
    sc = b[:, 66:74].astype(np.int32)  # (nb,8) nibble pairs
    ls = np.stack([sc & 0x0F, sc >> 4], axis=2).reshape(nb, 16)  # per 16 elems
    db = (d * (np.float32(0.5) + ls.astype(F32))) * np.float32(0.25)  # (nb,16)
    mag = grid_bytes[qs & 511]  # (nb,8,4,8)
    signs = ksigns[qs >> 9]  # (nb,8,4)
    j = np.arange(8, dtype=np.uint8)
    sign = np.where((signs[..., None] & (1 << j)) != 0, np.float32(-1.0), np.float32(1.0))
    y = db.reshape(nb, 8, 2, 1, 1) * (mag.astype(F32) * sign).reshape(nb, 8, 2, 2, 8)
    return y.reshape(raw.shape[0], n)


def dequant_iq2_s(raw: np.ndarray, n: int) -> np.ndarray:
    """IQ2_S (2.5625 bpw): dequantize_row_iq2_s ggml-quants.c:3558.
    8-bit grid index low bits in qs[0:32], 2 high bits per index from qh,
    raw sign bytes in qs[32:64], 4-bit scale nibble per 16 elements."""
    grid_bytes = _codebook("iq2s_grid").view(np.uint8).reshape(1024, 8).astype(np.int32)
    b = _blocks(raw, 82)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].reshape(nb, 8, 4).astype(np.int32)
    sbytes = b[:, 34:66].reshape(nb, 8, 4)
    qh = b[:, 66:74].astype(np.int32)  # (nb,8)
    sc = b[:, 74:82].astype(np.int32)
    ls = np.stack([sc & 0x0F, sc >> 4], axis=2).reshape(nb, 16)
    db = (d * (np.float32(0.5) + ls.astype(F32))) * np.float32(0.25)
    l = np.arange(4)
    idx = qs | ((qh[:, :, None] << (8 - 2 * l)) & 0x300)  # (nb,8,4)
    mag = grid_bytes[idx]  # (nb,8,4,8)
    j = np.arange(8, dtype=np.uint8)
    sign = np.where((sbytes[..., None] & (1 << j)) != 0, np.float32(-1.0), np.float32(1.0))
    y = db.reshape(nb, 8, 2, 1, 1) * (mag.astype(F32) * sign).reshape(nb, 8, 2, 2, 8)
    return y.reshape(raw.shape[0], n)


def dequant_iq3_xxs(raw: np.ndarray, n: int) -> np.ndarray:
    """IQ3_XXS (3.0625 bpw): dequantize_row_iq3_xxs ggml-quants.c:3590.
    One u8 grid index per 4 elements (256-entry u32 iq3xxs_grid); per-32-elem
    aux u32 = 4x7-bit ksigns codes + 4-bit scale."""
    grid_bytes = _codebook("iq3xxs_grid").view(np.uint8).reshape(256, 4).astype(np.int32)
    ksigns = _codebook("ksigns_iq2xs").astype(np.uint8)
    b = _blocks(raw, 98)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])
    qs = b[:, 2:66].reshape(nb, 8, 8).astype(np.int32)  # 8 idx bytes per ib32
    aux = b[:, 66:98].copy().view(np.uint32).reshape(nb, 8)
    db = (d * (np.float32(0.5) + (aux >> 28).astype(F32))) * np.float32(0.5)  # (nb,8)
    l = np.arange(4)
    sbits = (aux[:, :, None] >> (7 * l)) & 127  # (nb,8,4)
    signs = ksigns[sbits]
    j = np.arange(8, dtype=np.uint8)
    sign = np.where((signs[..., None] & (1 << j)) != 0, np.float32(-1.0), np.float32(1.0))
    mag = grid_bytes[qs].reshape(nb, 8, 4, 8)  # two u8 grids of 4 per sign byte
    y = db[:, :, None, None] * mag.astype(F32) * sign
    return y.reshape(raw.shape[0], n)


def dequant_iq3_s(raw: np.ndarray, n: int) -> np.ndarray:
    """IQ3_S (3.4375 bpw): dequantize_row_iq3_s ggml-quants.c:3622.
    8-bit grid index low bits + 1 high bit per index from qh (512-entry
    iq3s_grid), raw sign bytes, 4-bit scale nibble per 32 elements."""
    grid_bytes = _codebook("iq3s_grid").view(np.uint8).reshape(512, 4).astype(np.int32)
    b = _blocks(raw, 110)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])
    qs = b[:, 2:66].reshape(nb, 8, 8).astype(np.int32)
    qh = b[:, 66:74].astype(np.int32)  # (nb,8): high bit j for qs byte j
    sbytes = b[:, 74:106].reshape(nb, 8, 4)
    sc = b[:, 106:110].astype(np.int32)  # (nb,4) nibble pairs
    ls = np.stack([sc & 0x0F, sc >> 4], axis=2).reshape(nb, 8)  # per 32 elems
    db = d * (1 + 2 * ls).astype(F32)  # (nb,8)
    jbit = np.arange(8)
    idx = qs | (((qh[:, :, None] >> jbit) & 1) << 8)  # (nb,8,8)
    mag = grid_bytes[idx].reshape(nb, 8, 4, 8)
    j = np.arange(8, dtype=np.uint8)
    sign = np.where((sbytes[..., None] & (1 << j)) != 0, np.float32(-1.0), np.float32(1.0))
    y = db[:, :, None, None] * mag.astype(F32) * sign
    return y.reshape(raw.shape[0], n)


def dequant_iq1_s(raw: np.ndarray, n: int) -> np.ndarray:
    grid = _codebook("iq1s_grid")  # (2048,) uint64
    grid_bytes = grid.view(np.uint8).reshape(2048, 8).view(np.int8).astype(np.int32)
    b = _blocks(raw, 50)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])  # (nb,1)
    qs = b[:, 2:34].reshape(nb, 8, 4).astype(np.int32)  # 8 groups x 4 idx bytes
    qh = b[:, 34:50].copy().view(np.uint16).astype(np.int32)  # (nb,8)
    dl = d * (2 * ((qh >> 12) & 7) + 1).astype(F32)  # (nb,8)
    delta = np.where((qh & 0x8000) != 0, -IQ1S_DELTA, IQ1S_DELTA)  # (nb,8)
    l = np.arange(4)
    idx = qs | (((qh[:, :, None] >> (3 * l)) & 7) << 8)  # (nb,8,4)
    g = grid_bytes[idx]  # (nb,8,4,8)
    y = dl[:, :, None, None] * (g.astype(F32) + delta[:, :, None, None])
    return y.reshape(raw.shape[0], n)


def dequant_iq1_m(raw: np.ndarray, n: int) -> np.ndarray:
    grid = _codebook("iq1s_grid")
    grid_bytes = grid.view(np.uint8).reshape(2048, 8).view(np.int8).astype(np.int32)
    b = _blocks(raw, 56)
    nb = b.shape[0]
    qs = b[:, 0:32].reshape(nb, 8, 4).astype(np.int32)
    qh = b[:, 32:48].reshape(nb, 8, 2).astype(np.int32)
    sc = b[:, 48:56].copy().view(np.uint16).astype(np.uint32)  # (nb,4)
    scale_u16 = (
        (sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0) | ((sc[:, 2] >> 4) & 0x0F00) | (sc[:, 3] & 0xF000)
    ).astype(np.uint16)
    d = scale_u16.view(np.float16).astype(F32)[:, None]  # (nb,1)
    ib = np.arange(8)
    sc32 = sc.astype(np.int32)
    dl1 = d * (2 * ((sc32[:, ib // 2] >> (6 * (ib % 2) + 0)) & 0x7) + 1).astype(F32)  # (nb,8)
    dl2 = d * (2 * ((sc32[:, ib // 2] >> (6 * (ib % 2) + 3)) & 0x7) + 1).astype(F32)
    idx = np.empty((nb, 8, 4), dtype=np.int32)
    idx[:, :, 0] = qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700)
    idx[:, :, 1] = qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700)
    idx[:, :, 2] = qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700)
    idx[:, :, 3] = qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700)
    delta = np.empty((nb, 8, 4), dtype=F32)
    delta[:, :, 0] = np.where((qh[:, :, 0] & 0x08) != 0, -IQ1S_DELTA, IQ1S_DELTA)
    delta[:, :, 1] = np.where((qh[:, :, 0] & 0x80) != 0, -IQ1S_DELTA, IQ1S_DELTA)
    delta[:, :, 2] = np.where((qh[:, :, 1] & 0x08) != 0, -IQ1S_DELTA, IQ1S_DELTA)
    delta[:, :, 3] = np.where((qh[:, :, 1] & 0x80) != 0, -IQ1S_DELTA, IQ1S_DELTA)
    g = grid_bytes[idx].astype(F32)  # (nb,8,4,8)
    dl = np.stack([dl1, dl1, dl2, dl2], axis=2)  # (nb,8,4) — first two quarters use dl1
    y = dl[:, :, :, None] * (g + delta[:, :, :, None])
    return y.reshape(raw.shape[0], n)


# -------------------------------------------------------------------------
# Float passthrough + dispatch
# -------------------------------------------------------------------------


def dequant_f32(raw: np.ndarray, n: int) -> np.ndarray:
    return raw.copy().view(np.float32).reshape(raw.shape[0], n)


def dequant_f16(raw: np.ndarray, n: int) -> np.ndarray:
    return raw.copy().view(np.float16).astype(F32).reshape(raw.shape[0], n)


def dequant_bf16(raw: np.ndarray, n: int) -> np.ndarray:
    u = raw.copy().view(np.uint16).astype(np.uint32) << 16
    return u.view(np.float32).reshape(raw.shape[0], n)


DEQUANT_FNS = {
    GGMLType.F32: dequant_f32,
    GGMLType.F16: dequant_f16,
    GGMLType.BF16: dequant_bf16,
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q4_1: dequant_q4_1,
    GGMLType.Q5_0: dequant_q5_0,
    GGMLType.Q5_1: dequant_q5_1,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q2_K: dequant_q2_k,
    GGMLType.Q3_K: dequant_q3_k,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q5_K: dequant_q5_k,
    GGMLType.Q6_K: dequant_q6_k,
    GGMLType.Q8_K: dequant_q8_k,
    GGMLType.IQ4_NL: dequant_iq4_nl,
    GGMLType.IQ4_XS: dequant_iq4_xs,
    GGMLType.IQ2_XXS: dequant_iq2_xxs,
    GGMLType.IQ2_XS: dequant_iq2_xs,
    GGMLType.IQ2_S: dequant_iq2_s,
    GGMLType.IQ3_XXS: dequant_iq3_xxs,
    GGMLType.IQ3_S: dequant_iq3_s,
    GGMLType.IQ1_S: dequant_iq1_s,
    GGMLType.IQ1_M: dequant_iq1_m,
    GGMLType.TQ1_0: dequant_tq1_0,
    GGMLType.TQ2_0: dequant_tq2_0,
}


def dequantize(raw: np.ndarray, ggml_type: GGMLType, n_per_row: int) -> np.ndarray:
    """Dequantize raw row-blocked bytes to float32 (n_rows, n_per_row)."""
    fn = DEQUANT_FNS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"dequantization for {ggml_type.name}")
    if raw.ndim == 1:
        raw = raw.reshape(1, -1)
    return fn(np.ascontiguousarray(raw), n_per_row)


def dequantize_tensor(ti) -> np.ndarray:
    """Dequantize a reader TensorInfo to float32 in numpy (C-order) shape."""
    t = ti.ggml_type
    tt = TYPE_TRAITS[t]
    if not tt.is_quantized:
        if t == GGMLType.F32:
            return np.asarray(ti.data, dtype=np.float32)
        if t == GGMLType.F16:
            return ti.data.astype(np.float32)
        if t == GGMLType.BF16:
            return (ti.data.astype(np.uint32) << 16).view(np.float32)
        return ti.data.astype(np.float32)
    out = dequantize(ti.data, t, ti.ne[0])
    return out.reshape(ti.shape)
