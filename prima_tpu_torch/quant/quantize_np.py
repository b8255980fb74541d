"""Numpy quantizers: float32 rows -> GGUF block bytes.

The port's copy of prima_tpu/quant/quantize_np.py (host numpy, byte for
byte the same encodings).

Legacy 32-element formats (Q4_0/Q4_1/Q5_0/Q5_1/Q8_0) follow the reference
algorithms exactly (ggml/src/ggml-quants.c: quantize_row_q4_0_ref @698,
q8_0_ref @895, ...): absmax scaling with the same rounding rules, so encodings
are bit-identical given strict f32 arithmetic.

K-quant encoders (Q2_K..Q6_K) use single-pass round-to-nearest with the same
block geometry but without the reference's iterative weighted scale search
(make_qkx2_quants / make_qx_quants, ggml-quants.c:1746+). Decoded values are
valid for any GGUF consumer; quantization error is slightly higher than the
reference's searched encodings. Search-based parity is future work.

IQ1/IQ2/IQ3 encoders are not provided (they need codebook search + imatrix);
decode-side support lives in dequant_np.py.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType, QK_K

F32 = np.float32


def _f16_bytes(x: np.ndarray) -> np.ndarray:
    """float32 (..., ) -> uint8 (..., 2) little-endian f16."""
    h = x.astype(np.float16)
    return h.view(np.uint8).reshape(x.shape + (2,))


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """Round half away from zero, like the reference's nearest_int."""
    return np.trunc(x + np.where(x >= 0, 0.5, -0.5)).astype(np.int32)


def _rows(x: np.ndarray, block: int) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x.reshape(1, -1)
    if x.shape[-1] % block:
        raise ValueError(f"row length {x.shape[-1]} not divisible by {block}")
    return x


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    x = _rows(x, 32)
    n_rows, n = x.shape
    xb = x.reshape(-1, 32)
    amax = np.abs(xb).max(axis=1)
    d = (amax / 127.0).astype(F32)
    id_ = np.where(d != 0, np.float32(1.0) / np.where(d != 0, d, 1), np.float32(0.0))
    q = _nearest_int(xb * id_[:, None]).clip(-128, 127).astype(np.int8)
    out = np.empty((xb.shape[0], 34), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(n_rows, -1)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    x = _rows(x, 32)
    n_rows, n = x.shape
    xb = x.reshape(-1, 32)
    # signed value of max magnitude (reference keeps the sign)
    idx = np.abs(xb).argmax(axis=1)
    maxv = xb[np.arange(xb.shape[0]), idx]
    d = (maxv / -8.0).astype(F32)
    id_ = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    q = (xb * id_[:, None] + np.float32(8.5)).astype(np.int32).clip(0, 15).astype(np.uint8)
    out = np.empty((xb.shape[0], 18), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(n_rows, -1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    x = _rows(x, 32)
    n_rows, n = x.shape
    xb = x.reshape(-1, 32)
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = ((mx - mn) / 15.0).astype(F32)
    id_ = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    q = ((xb - mn[:, None]) * id_[:, None] + np.float32(0.5)).astype(np.int32).clip(0, 15).astype(np.uint8)
    out = np.empty((xb.shape[0], 20), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(mn.astype(F32))
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(n_rows, -1)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    x = _rows(x, 32)
    n_rows, n = x.shape
    xb = x.reshape(-1, 32)
    idx = np.abs(xb).argmax(axis=1)
    maxv = xb[np.arange(xb.shape[0]), idx]
    d = (maxv / -16.0).astype(F32)
    id_ = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    q = (xb * id_[:, None] + np.float32(16.5)).astype(np.int32).clip(0, 31).astype(np.uint32)
    lo = q & 0x0F
    hi = q >> 4  # 5th bit
    j = np.arange(16, dtype=np.uint32)
    qh = (hi[:, :16] << j).sum(axis=1, dtype=np.uint64) | (
        (hi[:, 16:] << (j + 16)).sum(axis=1, dtype=np.uint64)
    )
    out = np.empty((xb.shape[0], 22), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:6] = qh.astype(np.uint32)[:, None].view(np.uint8).reshape(-1, 4)
    out[:, 6:] = (lo[:, :16] | (lo[:, 16:] << 4)).astype(np.uint8)
    return out.reshape(n_rows, -1)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    x = _rows(x, 32)
    n_rows, n = x.shape
    xb = x.reshape(-1, 32)
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = ((mx - mn) / 31.0).astype(F32)
    id_ = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    q = ((xb - mn[:, None]) * id_[:, None] + np.float32(0.5)).astype(np.int32).clip(0, 31).astype(np.uint32)
    lo = q & 0x0F
    hi = q >> 4
    j = np.arange(16, dtype=np.uint32)
    qh = (hi[:, :16] << j).sum(axis=1, dtype=np.uint64) | (
        (hi[:, 16:] << (j + 16)).sum(axis=1, dtype=np.uint64)
    )
    out = np.empty((xb.shape[0], 24), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(mn.astype(F32))
    out[:, 4:8] = qh.astype(np.uint32)[:, None].view(np.uint8).reshape(-1, 4)
    out[:, 8:] = (lo[:, :16] | (lo[:, 16:] << 4)).astype(np.uint8)
    return out.reshape(n_rows, -1)


# ---------------------------------------------------------------------------
# K-quants
# ---------------------------------------------------------------------------


def _pack_scale_min_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Pack 8 (scale, min) 6-bit pairs into 12 bytes (inverse of get_scale_min_k4)."""
    nb = sc.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    scu = sc.astype(np.uint8)
    mnu = mn.astype(np.uint8)
    out[:, 0:4] = (scu[:, 0:4] & 63) | ((scu[:, 4:8] >> 4) << 6)
    out[:, 4:8] = (mnu[:, 0:4] & 63) | ((mnu[:, 4:8] >> 4) << 6)
    out[:, 8:12] = (scu[:, 4:8] & 0x0F) | ((mnu[:, 4:8] & 0x0F) << 4)
    return out


def _affine_sub_quant(xb: np.ndarray, n_sub: int, qmax: int):
    """Per-sub-block affine RTN: x ~ scale*q - min, q in [0, qmax]."""
    nb = xb.shape[0]
    sub = xb.reshape(nb, n_sub, -1)
    mn = np.minimum(sub.min(axis=2), 0.0)  # min <= 0 so stored -min >= 0
    mx = np.maximum(sub.max(axis=2), 0.0)
    scale = ((mx - mn) / qmax).astype(F32)
    return sub, -mn.astype(F32), scale


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    x = _rows(x, QK_K)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K)
    nb = xb.shape[0]
    sub, neg_mn, scale = _affine_sub_quant(xb, 8, 15)  # 8 sub-blocks of 32
    max_scale = scale.max(axis=1)
    max_min = neg_mn.max(axis=1)
    d = (max_scale / 63.0).astype(F32)
    dmin = (max_min / 63.0).astype(F32)
    inv_d = np.where(d > 0, 1.0 / d, 0.0).astype(F32)
    inv_m = np.where(dmin > 0, 1.0 / dmin, 0.0).astype(F32)
    ls = _nearest_int(scale * inv_d[:, None]).clip(0, 63)
    lm = _nearest_int(neg_mn * inv_m[:, None]).clip(0, 63)
    d_eff = d[:, None] * ls.astype(F32)
    m_eff = dmin[:, None] * lm.astype(F32)
    inv_de = np.where(d_eff > 0, 1.0 / d_eff, 0.0).astype(F32)
    q = _nearest_int((sub + m_eff[:, :, None]) * inv_de[:, :, None]).clip(0, 15).astype(np.uint8)
    # pack: group g of 64 elems <- sub 2g (low nibble), 2g+1 (high nibble)
    qsub = q.reshape(nb, 4, 2, 32)
    qs = (qsub[:, :, 0, :] | (qsub[:, :, 1, :] << 4)).reshape(nb, 128)
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    out[:, 4:16] = _pack_scale_min_k4(ls, lm)
    out[:, 16:] = qs
    return out.reshape(n_rows, -1)


def quantize_q5_k(x: np.ndarray) -> np.ndarray:
    x = _rows(x, QK_K)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K)
    nb = xb.shape[0]
    sub, neg_mn, scale = _affine_sub_quant(xb, 8, 31)
    max_scale = scale.max(axis=1)
    max_min = neg_mn.max(axis=1)
    d = (max_scale / 63.0).astype(F32)
    dmin = (max_min / 63.0).astype(F32)
    inv_d = np.where(d > 0, 1.0 / d, 0.0).astype(F32)
    inv_m = np.where(dmin > 0, 1.0 / dmin, 0.0).astype(F32)
    ls = _nearest_int(scale * inv_d[:, None]).clip(0, 63)
    lm = _nearest_int(neg_mn * inv_m[:, None]).clip(0, 63)
    d_eff = d[:, None] * ls.astype(F32)
    m_eff = dmin[:, None] * lm.astype(F32)
    inv_de = np.where(d_eff > 0, 1.0 / d_eff, 0.0).astype(F32)
    q = _nearest_int((sub + m_eff[:, :, None]) * inv_de[:, :, None]).clip(0, 31).astype(np.uint8)
    lo = q & 0x0F
    hi = q >> 4  # 1 bit per element, sub-block s -> qh bit (s)
    qs_pairs = lo.reshape(nb, 4, 2, 32)
    qs = (qs_pairs[:, :, 0, :] | (qs_pairs[:, :, 1, :] << 4)).reshape(nb, 128)
    # qh: 32 bytes; bit s of byte l = high bit of element l of sub-block s
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for s in range(8):
        qh |= (hi[:, s, :] << s).astype(np.uint8)
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    out[:, 4:16] = _pack_scale_min_k4(ls, lm)
    out[:, 16:48] = qh
    out[:, 48:] = qs
    return out.reshape(n_rows, -1)


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    x = _rows(x, QK_K)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K)
    nb = xb.shape[0]
    sub = xb.reshape(nb, 16, 16)
    amax = np.abs(sub).max(axis=2)
    sub_scale = (amax / 31.0).astype(F32)  # symmetric q in [-32, 31] -> use 31 for safety
    max_scale = sub_scale.max(axis=1)
    d = (max_scale / 127.0).astype(F32)
    inv_d = np.where(d > 0, 1.0 / d, 0.0).astype(F32)
    sc = _nearest_int(sub_scale * inv_d[:, None]).clip(-128, 127)
    d_eff = d[:, None] * sc.astype(F32)
    inv_de = np.where(d_eff != 0, 1.0 / d_eff, 0.0).astype(F32)
    q = (_nearest_int(sub * inv_de[:, :, None]).clip(-32, 31) + 32).astype(np.uint8)  # (nb,16,16)
    qf = q.reshape(nb, 2, 128)  # two halves
    lo = qf & 0x0F
    hi = (qf >> 4).astype(np.uint8)  # 2 bits
    ql = np.empty((nb, 2, 64), dtype=np.uint8)
    ql[:, :, 0:32] = lo[:, :, 0:32] | (lo[:, :, 64:96] << 4)
    ql[:, :, 32:64] = lo[:, :, 32:64] | (lo[:, :, 96:128] << 4)
    qh = (
        hi[:, :, 0:32]
        | (hi[:, :, 32:64] << 2)
        | (hi[:, :, 64:96] << 4)
        | (hi[:, :, 96:128] << 6)
    )
    out = np.empty((nb, 210), dtype=np.uint8)
    out[:, 0:128] = ql.reshape(nb, 128)
    out[:, 128:192] = qh.reshape(nb, 64)
    out[:, 192:208] = sc.astype(np.int8).view(np.uint8)
    out[:, 208:210] = _f16_bytes(d)
    return out.reshape(n_rows, -1)


def quantize_q3_k(x: np.ndarray) -> np.ndarray:
    x = _rows(x, QK_K)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K)
    nb = xb.shape[0]
    sub = xb.reshape(nb, 16, 16)
    amax = np.abs(sub).max(axis=2)
    sub_scale = (amax / 4.0).astype(F32)  # q in [-4, 3]
    max_scale = sub_scale.max(axis=1)
    d = (max_scale / 31.0).astype(F32)  # 6-bit signed scale: [-32, 31]
    inv_d = np.where(d > 0, 1.0 / d, 0.0).astype(F32)
    sc6 = _nearest_int(sub_scale * inv_d[:, None]).clip(-32, 31)  # signed 6-bit
    d_eff = d[:, None] * sc6.astype(F32)
    inv_de = np.where(d_eff != 0, 1.0 / d_eff, 0.0).astype(F32)
    q = (_nearest_int(sub * inv_de[:, :, None]).clip(-4, 3) + 4).astype(np.uint8)  # 0..7
    lo = (q & 3).reshape(nb, 2, 128)
    hbit = (q >> 2).reshape(nb, 2, 128)  # 1 = no subtraction of 4
    # hmask bit (4h+j) of byte (16*half16+l): 1 when q >= 4
    hmask = np.zeros((nb, 32), dtype=np.uint8)
    qs = np.zeros((nb, 2, 32), dtype=np.uint8)
    for h in range(2):
        for j in range(4):
            seg = lo[:, h, 32 * j : 32 * j + 32]
            qs[:, h, :] |= (seg << (2 * j)).astype(np.uint8)
            hb = hbit[:, h, 32 * j : 32 * j + 32]
            hmask |= (hb << (4 * h + j)).astype(np.uint8)
    # store 6-bit scales (value+32 gives 0..63? reference stores raw 6-bit with -32 bias at decode)
    s6 = (sc6 + 32).astype(np.uint8)  # 0..63; decode does -32
    packed = np.zeros((nb, 12), dtype=np.uint8)
    packed[:, 0:4] = (s6[:, 0:4] & 0x0F) | ((s6[:, 8:12] & 0x0F) << 4)
    packed[:, 4:8] = (s6[:, 4:8] & 0x0F) | ((s6[:, 12:16] & 0x0F) << 4)
    packed[:, 8:12] = (
        (s6[:, 0:4] >> 4)
        | ((s6[:, 4:8] >> 4) << 2)
        | ((s6[:, 8:12] >> 4) << 4)
        | ((s6[:, 12:16] >> 4) << 6)
    )
    out = np.empty((nb, 110), dtype=np.uint8)
    out[:, 0:32] = hmask
    out[:, 32:96] = qs.reshape(nb, 64)
    out[:, 96:108] = packed
    out[:, 108:110] = _f16_bytes(d)
    return out.reshape(n_rows, -1)


def quantize_q2_k(x: np.ndarray) -> np.ndarray:
    x = _rows(x, QK_K)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K)
    nb = xb.shape[0]
    sub, neg_mn, scale = _affine_sub_quant(xb, 16, 3)
    max_scale = scale.max(axis=1)
    max_min = neg_mn.max(axis=1)
    d = (max_scale / 15.0).astype(F32)
    dmin = (max_min / 15.0).astype(F32)
    inv_d = np.where(d > 0, 1.0 / d, 0.0).astype(F32)
    inv_m = np.where(dmin > 0, 1.0 / dmin, 0.0).astype(F32)
    ls = _nearest_int(scale * inv_d[:, None]).clip(0, 15)
    lm = _nearest_int(neg_mn * inv_m[:, None]).clip(0, 15)
    d_eff = d[:, None] * ls.astype(F32)
    m_eff = dmin[:, None] * lm.astype(F32)
    inv_de = np.where(d_eff > 0, 1.0 / d_eff, 0.0).astype(F32)
    q = _nearest_int((sub + m_eff[:, :, None]) * inv_de[:, :, None]).clip(0, 3).astype(np.uint8)
    scales = (ls | (lm << 4)).astype(np.uint8)
    qflat = q.reshape(nb, 2, 128)  # halves of 128
    qs = np.zeros((nb, 2, 32), dtype=np.uint8)
    for j in range(4):
        qs |= (qflat[:, :, 32 * j : 32 * j + 32] << (2 * j)).astype(np.uint8)
    out = np.empty((nb, 84), dtype=np.uint8)
    out[:, 0:16] = scales
    out[:, 16:80] = qs.reshape(nb, 64)
    out[:, 80:82] = _f16_bytes(d)
    out[:, 82:84] = _f16_bytes(dmin)
    return out.reshape(n_rows, -1)


def quantize_iq4_nl(x: np.ndarray) -> np.ndarray:
    from .dequant_np import _codebook

    kvalues = _codebook("kvalues_iq4nl").astype(np.float32)  # (16,)
    x = _rows(x, 32)
    n_rows, n = x.shape
    xb = x.reshape(-1, 32)
    idx = np.abs(xb).argmax(axis=1)
    maxv = xb[np.arange(xb.shape[0]), idx]
    d = (maxv / kvalues[0]).astype(F32)  # map absmax onto the most negative LUT entry
    id_ = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    scaled = xb * id_[:, None]
    q = np.abs(scaled[:, :, None] - kvalues[None, None, :]).argmin(axis=2).astype(np.uint8)
    out = np.empty((xb.shape[0], 18), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(n_rows, -1)


def quantize_iq4_xs(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ4_XS: 256-element superblocks of 32-element sub-blocks indexing the
    nonlinear kvalues_iq4nl LUT, with 6-bit block scales (port of
    quantize_row_iq4_nl_impl with super_block_size=256, ntry=7)."""
    from .dequant_np import _codebook

    values = _codebook("kvalues_iq4nl").astype(np.float64)  # (16,) ascending
    x = _rows(x, QK_K)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K).astype(np.float64)
    nb = xb.shape[0]
    sub = xb.reshape(nb, 8, 32)

    sigma2 = 2.0 * np.sum(xb * xb, axis=1, keepdims=True) / QK_K  # (nb, 1)
    if qw is not None:
        qw_b = np.broadcast_to(qw.astype(np.float64), (n_rows, n)).reshape(nb, 8, 32)
        w = qw_b * np.sqrt(sigma2[:, :, None] + sub * sub)
    else:
        w = sub * sub

    flat = sub.reshape(nb * 8, 32)
    wf = w.reshape(nb * 8, 32)
    amax_i = np.argmax(np.abs(flat), axis=1)
    mx = flat[np.arange(nb * 8), amax_i]
    dead = np.abs(mx) < 1e-15
    mx_safe = np.where(dead, 1.0, mx)

    # nearest-LUT index for scaled values: (m, 32)
    def nearest(id_):
        scaled = id_[:, None] * flat
        return np.abs(scaled[:, :, None] - values[None, None, :]).argmin(axis=2)

    def ls(idx):
        q = values[idx]
        sumqx = np.sum(wf * q * flat, axis=1)
        sumq2 = np.sum(wf * q * q, axis=1)
        return sumqx, sumq2

    d0 = -mx_safe / values[0]
    idx = nearest(1.0 / d0)
    sumqx, sumq2 = ls(idx)
    d = np.where(sumq2 > 0, sumqx / np.where(sumq2 > 0, sumq2, 1), 0.0)
    best = d * sumqx
    for itry in range(-7, 8):
        id_try = (itry + values[0]) / mx_safe
        i2 = nearest(id_try)
        sqx, sq2 = ls(i2)
        better = (sq2 > 0) & (sqx * sqx > best * sq2)
        nd = sqx / np.where(sq2 > 0, sq2, 1)
        d = np.where(better, nd, d)
        best = np.where(better, nd * sqx, best)
    scales = np.where(dead, 0.0, d).reshape(nb, 8)

    # 6-bit superblock scale quantization
    amax_s = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), amax_s]
    d_super = np.where(max_scale != 0, -max_scale / 32.0, 0.0)
    d16 = d_super.astype(np.float32).astype(np.float16)
    d_superf = d16.astype(np.float64)
    id_s = np.where(d_superf != 0, 1.0 / np.where(d_superf != 0, d_superf, 1), 0.0)
    lsc = np.clip(_nearest_int(id_s[:, None] * scales), -32, 31)  # (nb, 8)
    dl = d_superf[:, None] * lsc
    idl = np.where(dl != 0, 1.0 / np.where(dl != 0, dl, 1), 0.0)
    scaled = idl.reshape(nb * 8)[:, None] * flat
    L = np.abs(scaled[:, :, None] - values[None, None, :]).argmin(axis=2)
    L = L.reshape(nb, 8, 32).astype(np.uint8)

    l6 = (lsc + 32).astype(np.uint8)  # (nb, 8)
    scales_l = ((l6[:, 0::2] & 0xF) | ((l6[:, 1::2] & 0xF) << 4)).astype(np.uint8)
    sh = np.zeros(nb, np.uint32)
    for ib in range(8):
        sh |= (l6[:, ib].astype(np.uint32) >> 4) << (2 * ib)
    qs = (L[:, :, 0:16] | (L[:, :, 16:32] << 4)).reshape(nb, 128)

    out = np.empty((nb, 136), dtype=np.uint8)
    out[:, 0:2] = np.ascontiguousarray(d16).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = np.ascontiguousarray(sh.astype(np.uint16)).view(np.uint8).reshape(nb, 2)
    out[:, 4:8] = scales_l
    out[:, 8:] = qs
    return out.reshape(n_rows, -1)


def _tq_trits(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-256-block amax scale and {0,1,2} trits (shared by TQ1_0/TQ2_0;
    quantize_row_tq1_0_ref ggml-quants.c:3318 — id uses the UNROUNDED f32
    amax, only the stored d is f16)."""
    xb = _rows(x, 256).reshape(-1, 256)
    amax = np.abs(xb).max(axis=1).astype(F32)
    id_ = np.divide(np.float32(1.0), amax, out=np.zeros_like(amax),
                    where=amax != 0)
    xi = (_nearest_int(xb * id_[:, None]) + 1).astype(np.uint16)  # 0,1,2
    return amax, xi


def _tq1_pack(xi: np.ndarray) -> np.ndarray:
    """Base-3 big-endian pack of (nb, n_trits, width) trit groups into
    ceil-scaled bytes: q = ceil(sum(3^(k-1-n) * trit_n) * 256 / 243)."""
    nb, n_trits, _ = xi.shape
    q = np.zeros((nb, xi.shape[2]), np.uint16)
    for t in range(n_trits):
        q = q * 3 + xi[:, t]
    q *= 3 ** (5 - n_trits)  # qh: shift the digits to the most-significant
    return ((q * 256 + 242) // 243).astype(np.uint8)


def quantize_tq1_0(x: np.ndarray) -> np.ndarray:
    n_rows = _rows(x, 256).shape[0]
    amax, xi = _tq_trits(x)
    nb = xi.shape[0]
    out = np.empty((nb, 54), np.uint8)
    out[:, 0:32] = _tq1_pack(xi[:, 0:160].reshape(nb, 5, 32))
    out[:, 32:48] = _tq1_pack(xi[:, 160:240].reshape(nb, 5, 16))
    out[:, 48:52] = _tq1_pack(xi[:, 240:256].reshape(nb, 4, 4))
    out[:, 52:54] = _f16_bytes(amax)
    return out.reshape(n_rows, -1)


def quantize_tq2_0(x: np.ndarray) -> np.ndarray:
    n_rows = _rows(x, 256).shape[0]
    amax, xi = _tq_trits(x)
    nb = xi.shape[0]
    grp = xi.reshape(nb, 2, 4, 32).astype(np.uint8)  # (chunk, bitpos, byte)
    shifts = (2 * np.arange(4, dtype=np.uint8)).reshape(1, 1, 4, 1)
    qs = (grp << shifts).sum(axis=2, dtype=np.uint8).reshape(nb, 64)
    out = np.empty((nb, 66), np.uint8)
    out[:, 0:64] = qs
    out[:, 64:66] = _f16_bytes(amax)
    return out.reshape(n_rows, -1)


QUANTIZE_FNS = {
    GGMLType.Q8_0: quantize_q8_0,
    GGMLType.Q4_0: quantize_q4_0,
    GGMLType.Q4_1: quantize_q4_1,
    GGMLType.Q5_0: quantize_q5_0,
    GGMLType.Q5_1: quantize_q5_1,
    GGMLType.Q2_K: quantize_q2_k,
    GGMLType.Q3_K: quantize_q3_k,
    GGMLType.Q4_K: quantize_q4_k,
    GGMLType.Q5_K: quantize_q5_k,
    GGMLType.Q6_K: quantize_q6_k,
    GGMLType.IQ4_NL: quantize_iq4_nl,
    GGMLType.IQ4_XS: quantize_iq4_xs,
    GGMLType.TQ1_0: quantize_tq1_0,
    GGMLType.TQ2_0: quantize_tq2_0,
}


def quantize(x: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """Quantize float32 rows to raw block bytes (n_rows, row_bytes)."""
    if ggml_type == GGMLType.F32:
        return np.ascontiguousarray(x, dtype=np.float32).view(np.uint8)
    if ggml_type == GGMLType.F16:
        return np.ascontiguousarray(x.astype(np.float16)).view(np.uint8)
    if ggml_type == GGMLType.BF16:
        u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
        return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16).view(np.uint8)
    fn = QUANTIZE_FNS.get(ggml_type)
    if fn is None:
        from .quantize_iq import (quantize_iq1_m, quantize_iq1_s,
                                  quantize_iq2_s, quantize_iq2_xs,
                                  quantize_iq2_xxs, quantize_iq3_s,
                                  quantize_iq3_xxs)

        iq = {GGMLType.IQ2_XXS: quantize_iq2_xxs,
              GGMLType.IQ2_XS: quantize_iq2_xs,
              GGMLType.IQ2_S: quantize_iq2_s,
              GGMLType.IQ3_XXS: quantize_iq3_xxs,
              GGMLType.IQ3_S: quantize_iq3_s,
              GGMLType.IQ1_S: quantize_iq1_s,
              GGMLType.IQ1_M: quantize_iq1_m}.get(ggml_type)
        if iq is None:
            raise NotImplementedError(f"quantization to {ggml_type.name}")
        # unweighted: sqrt(sigma2+x^2) default weights
        return iq(np.atleast_2d(np.asarray(x, dtype=np.float32)))
    return fn(x)
