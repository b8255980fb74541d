"""Importance-matrix-weighted quantization (the reference's imatrix path).

The port's copy of prima_tpu/quant/quantize_imatrix.py: the same bytes
from the same inputs, and imatrix files that cross both ways.

Vectorized numpy ports of the weighted encoders the reference uses when
`llama-quantize --imatrix` is given (ggml-quants.c: quantize_row_q4_K_impl,
quantize_row_q5_K_impl, quantize_row_q6_K_impl with quant_weights, built on
make_qkx3_quants / make_qx_quants / make_qp_quants): minimize the
activation-weighted quantization error  sum_j w_j (x_j - x̂_j)^2  where
w_j = imatrix_j * sqrt(sigma2 + x_j^2) per superblock.

The imatrix FILE FORMAT matches examples/imatrix/imatrix.cpp:207-292
(n_entries, then per entry name/ncall/nval/values f32, then last_call and
the dataset filename), so caches from llama-imatrix can be used directly
and vice versa.
"""

from __future__ import annotations

import struct

import numpy as np

from ..gguf.constants import GGMLType, QK_K
from .quantize_np import _f16_bytes, _nearest_int, _pack_scale_min_k4, _rows

F32 = np.float32
F64 = np.float64
GROUP_MAX_EPS = 1e-15


# ---------------------------------------------------------------------------
# imatrix file IO (examples/imatrix format)
# ---------------------------------------------------------------------------


def save_imatrix(path: str, stats: dict, last_call: int,
                 dataset: str = "") -> None:
    """stats: name -> (values f32 array, ncall). Values must already be the
    stored form (mean of x^2 per column) * ncall, as the reference writes."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(stats)))
        for name, (values, ncall) in stats.items():
            nb = name.encode("utf-8")
            f.write(struct.pack("<i", len(nb)))
            f.write(nb)
            f.write(struct.pack("<ii", int(ncall), len(values)))
            f.write(np.asarray(values, np.float32).tobytes())
        f.write(struct.pack("<i", int(last_call)))
        db = dataset.encode("utf-8")
        f.write(struct.pack("<i", len(db)))
        f.write(db)


def load_imatrix(path: str) -> dict:
    """-> name -> per-column importance (values / ncall), ready to use as
    quant_weights (examples/quantize/quantize.cpp load_imatrix)."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    (n_entries,) = struct.unpack_from("<i", data, off)
    off += 4
    out = {}
    for _ in range(n_entries):
        (ln,) = struct.unpack_from("<i", data, off)
        off += 4
        name = data[off:off + ln].decode("utf-8")
        off += ln
        ncall, nval = struct.unpack_from("<ii", data, off)
        off += 8
        vals = np.frombuffer(data, np.float32, nval, off).copy()
        off += 4 * nval
        if ncall > 0:
            vals /= ncall
        out[name] = vals
    return out


# ---------------------------------------------------------------------------
# Weighted scale search primitives (vectorized over blocks)
# ---------------------------------------------------------------------------


def make_qx_quants(x: np.ndarray, nmax: int, qw: np.ndarray) -> tuple:
    """Weighted symmetric search (make_qx_quants, rmse_type=1 path with qw).
    x, qw: (nb, n). Returns (scale (nb,), L (nb, n) ints in [0, 2*nmax))."""
    x = x.astype(F64)
    w = qw.astype(F64)
    nb, n = x.shape
    amax_i = np.argmax(np.abs(x), axis=1)
    mx = x[np.arange(nb), amax_i]
    dead = np.abs(mx) < GROUP_MAX_EPS
    mx_safe = np.where(dead, 1.0, mx)

    def stats(iscale):
        l = np.clip(_nearest_int(iscale[:, None] * x), -nmax, nmax - 1)
        sumlx = np.sum(w * x * l, axis=1)
        suml2 = np.sum(w * l * l, axis=1)
        return l, sumlx, suml2

    iscale = -nmax / mx_safe
    L, sumlx, suml2 = stats(iscale)
    scale = np.where(suml2 > 0, sumlx / np.where(suml2 > 0, suml2, 1), 0.0)
    best = scale * sumlx
    for s in range(-9, 10):
        if s == 0:
            continue
        isc = -(nmax + 0.1 * s) / mx_safe
        l, slx, sl2 = stats(isc)
        better = (sl2 > 0) & (slx * slx > best * sl2)
        L = np.where(better[:, None], l, L)
        new_scale = slx / np.where(sl2 > 0, sl2, 1)
        scale = np.where(better, new_scale, scale)
        best = np.where(better, new_scale * slx, best)
    L = np.where(dead[:, None], 0, L + nmax)
    scale = np.where(dead, 0.0, scale)
    return scale.astype(F32), L.astype(np.int32)


def make_qkx3_quants(x: np.ndarray, weights: np.ndarray, nmax: int,
                     rmin: float = -0.9, rdelta: float = 0.05,
                     nstep: int = 36) -> tuple:
    """Weighted affine search (make_qkx3_quants, use_mad=False).
    x, weights: (nb, n). Returns (scale, the_min, L)."""
    x = x.astype(F64)
    w = weights.astype(F64)
    mn = np.minimum(x.min(axis=1), 0.0)
    mx = x.max(axis=1)
    sum_w = w.sum(axis=1)
    sum_x = np.sum(w * x, axis=1)

    flat = mx <= mn  # all-equal rows (after min clamp): scale 0
    rng = np.where(flat, 1.0, mx - mn)

    iscale = nmax / rng
    L = np.clip(_nearest_int(iscale[:, None] * (x - mn[:, None])), 0, nmax)
    scale = 1.0 / iscale
    diff = scale[:, None] * L + mn[:, None] - x
    best_mad = np.sum(w * diff * diff, axis=1)

    for step in range(nstep + 1):
        # the reference uses the LIVE updated min in both the candidate
        # iscale denominator and the shift (make_qkx3_quants)
        rng_live = np.where(flat, 1.0, np.maximum(mx - mn, 1e-30))
        isc = (rmin + rdelta * step + nmax) / rng_live
        l = np.clip(_nearest_int(isc[:, None] * (x - mn[:, None])), 0, nmax)
        sum_l = np.sum(w * l, axis=1)
        sum_l2 = np.sum(w * l * l, axis=1)
        sum_xl = np.sum(w * l * x, axis=1)
        D = sum_w * sum_l2 - sum_l * sum_l
        ok = D > 0
        D_safe = np.where(ok, D, 1.0)
        this_scale = (sum_w * sum_xl - sum_x * sum_l) / D_safe
        this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D_safe
        pos = this_min > 0
        sum_l2_safe = np.where(sum_l2 > 0, sum_l2, 1.0)
        this_scale = np.where(pos, sum_xl / sum_l2_safe, this_scale)
        this_min = np.where(pos, 0.0, this_min)
        diff = this_scale[:, None] * l + this_min[:, None] - x
        mad = np.sum(w * diff * diff, axis=1)
        better = ok & (mad < best_mad)
        L = np.where(better[:, None], l, L)
        best_mad = np.where(better, mad, best_mad)
        scale = np.where(better, this_scale, scale)
        mn = np.where(better, this_min, mn)

    scale = np.where(flat, 0.0, scale)
    L = np.where(flat[:, None], 0, L)
    return scale.astype(F32), (-mn).astype(F32), L.astype(np.int32)


def make_qp_quants(x: np.ndarray, nmax: int, sw: np.ndarray) -> tuple:
    """Weighted non-negative search with coordinate refinement
    (make_qp_quants). x, sw: (nb, n). Returns (scale, L)."""
    x = x.astype(F64)
    w = sw.astype(F64)
    nb, n = x.shape
    mx = x.max(axis=1)
    dead = mx == 0
    mx_safe = np.where(dead, 1.0, mx)

    iscale = nmax / mx_safe
    L = _nearest_int(iscale[:, None] * x)
    diff = x - (1.0 / iscale)[:, None] * L
    best_mse = np.sum(w * diff * diff, axis=1)
    for s in range(-4, 5):
        if s == 0:
            continue
        isc = (0.1 * s + nmax) / mx_safe
        l = np.minimum(nmax, _nearest_int(isc[:, None] * x))
        diff = x - (1.0 / isc)[:, None] * l
        mse = np.sum(w * diff * diff, axis=1)
        better = mse < best_mse
        best_mse = np.where(better, mse, best_mse)
        iscale = np.where(better, isc, iscale)

    L = np.minimum(nmax, _nearest_int(iscale[:, None] * x)).astype(np.int64)
    sumlx = np.sum(w * x * L, axis=1)
    suml2 = np.sum(w * L * L, axis=1)
    # coordinate refinement, element order as in the reference
    for _ in range(5):
        changed = np.zeros(nb, bool)
        for i in range(n):
            wi, xi, li = w[:, i], x[:, i], L[:, i]
            slx = sumlx - wi * xi * li
            sl2 = suml2 - wi * li * li
            ok = (slx > 0) & (sl2 > 0)
            new_l = np.minimum(
                nmax, _nearest_int(xi * sl2 / np.where(ok, slx, 1.0)))
            cand = ok & (new_l != li)
            slx2 = slx + wi * xi * new_l
            sl22 = sl2 + wi * new_l * new_l
            accept = cand & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(accept, new_l, li)
            sumlx = np.where(accept, slx2, sumlx)
            suml2 = np.where(accept, sl22, suml2)
            changed |= accept
        if not changed.any():
            break
    scale = np.where(dead, 0.0, sumlx / np.where(suml2 > 0, suml2, 1.0))
    return scale.astype(F32), L.astype(np.int32)


# ---------------------------------------------------------------------------
# Weighted row encoders
# ---------------------------------------------------------------------------


def _super_weights(xb: np.ndarray, qw_b: np.ndarray) -> np.ndarray:
    """Per-element search weights: imatrix * sqrt(sigma2 + x^2), sigma2 =
    2*sum(x^2)/QK_K per superblock (quantize_row_q4_K_impl)."""
    sigma2 = 2.0 * np.sum(xb.astype(F64) ** 2, axis=1, keepdims=True) / QK_K
    return qw_b * np.sqrt(sigma2 + xb.astype(F64) ** 2)


def _qkx_affine(xb, qw_b, nmax):
    """Shared Q4_K/Q5_K body: weighted sub-block search + 6-bit block
    scales. Returns (d, dmin, ls, lm, L0)."""
    nb = xb.shape[0]
    w = _super_weights(xb, qw_b)
    x_sub = xb.reshape(nb * 8, 32)
    w_sub = w.reshape(nb * 8, 32)
    sw = w_sub.sum(axis=1).reshape(nb, 8).astype(F32)
    scales, mins, L0 = make_qkx3_quants(x_sub, w_sub, nmax)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    d, ls = make_qp_quants(scales, 63, sw)
    dmin, lm = make_qp_quants(mins, 63, sw)
    return (d.astype(np.float16).astype(F32),
            dmin.astype(np.float16).astype(F32),
            ls, lm, L0.reshape(nb, 8, 32))


def _requant_affine(xb, d, dmin, ls, lm, L0, qmax):
    """Final re-quantization against the f16-rounded block scales; sub-blocks
    whose effective scale is zero keep the search L."""
    nb = xb.shape[0]
    sub = xb.reshape(nb, 8, 32)
    d_eff = d[:, None] * ls.astype(F32)
    m_eff = dmin[:, None] * lm.astype(F32)
    inv = np.where(d_eff != 0, 1.0 / np.where(d_eff != 0, d_eff, 1), 0.0)
    q = np.clip(_nearest_int((sub + m_eff[:, :, None]) * inv[:, :, None]), 0, qmax)
    return np.where((d_eff == 0)[:, :, None], L0, q).astype(np.uint8)


def quantize_q4_k(x: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """imatrix-weighted Q4_K rows (quantize_row_q4_K_impl with weights)."""
    x = _rows(x, QK_K)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K).astype(F32)
    qw_b = np.broadcast_to(qw.astype(F64), (n_rows, n)).reshape(-1, QK_K)
    d, dmin, ls, lm, L0 = _qkx_affine(xb, qw_b, 15)
    q = _requant_affine(xb, d, dmin, ls, lm, L0, 15)
    nb = xb.shape[0]
    qsub = q.reshape(nb, 4, 2, 32)
    qs = (qsub[:, :, 0, :] | (qsub[:, :, 1, :] << 4)).reshape(nb, 128)
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    out[:, 4:16] = _pack_scale_min_k4(ls.astype(np.uint8), lm.astype(np.uint8))
    out[:, 16:] = qs
    return out.reshape(n_rows, -1)


def quantize_q5_k(x: np.ndarray, qw: np.ndarray) -> np.ndarray:
    x = _rows(x, QK_K)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K).astype(F32)
    qw_b = np.broadcast_to(qw.astype(F64), (n_rows, n)).reshape(-1, QK_K)
    d, dmin, ls, lm, L0 = _qkx_affine(xb, qw_b, 31)
    q = _requant_affine(xb, d, dmin, ls, lm, L0, 31).astype(np.int32)
    nb = xb.shape[0]
    # split 5-bit values into low nibbles + high bits (block_q5_K packing)
    qsub = q.reshape(nb, 4, 2, 32)
    lo = qsub & 0x0F
    hi = qsub >> 4  # 0/1
    qs = (lo[:, :, 0, :] | (lo[:, :, 1, :] << 4)).reshape(nb, 128).astype(np.uint8)
    qh = np.zeros((nb, 32), np.uint8)
    for g in range(4):
        qh |= (hi[:, g, 0, :] << (2 * g)).astype(np.uint8)
        qh |= (hi[:, g, 1, :] << (2 * g + 1)).astype(np.uint8)
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    out[:, 4:16] = _pack_scale_min_k4(ls.astype(np.uint8), lm.astype(np.uint8))
    out[:, 16:48] = qh
    out[:, 48:] = qs
    return out.reshape(n_rows, -1)


def quantize_q6_k(x: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """imatrix-weighted Q6_K (quantize_row_q6_K_impl: raw imatrix weights)."""
    x = _rows(x, QK_K)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K).astype(F32)
    nb = xb.shape[0]
    qw_b = np.broadcast_to(qw.astype(F64), (n_rows, n)).reshape(nb, QK_K)
    x_sub = xb.reshape(nb * 16, 16)
    w_sub = qw_b.reshape(nb * 16, 16)
    scale, L0 = make_qx_quants(x_sub, 32, w_sub)
    scales = scale.reshape(nb, 16)
    L0 = L0.reshape(nb, 16, 16)
    amax_i = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), amax_i]
    dead = np.abs(max_scale) < GROUP_MAX_EPS
    iscale = -128.0 / np.where(dead, 1.0, max_scale)
    d = (1.0 / iscale).astype(np.float16).astype(F32)
    sc8 = np.minimum(127, _nearest_int(iscale[:, None] * scales)).astype(np.int8)
    sc8 = np.where(dead[:, None], 0, sc8).astype(np.int8)  # zeroed block
    d_eff = d[:, None] * sc8.astype(F32)
    inv = np.where(d_eff != 0, 1.0 / np.where(d_eff != 0, d_eff, 1), 0.0)
    sub = xb.reshape(nb, 16, 16)
    L = np.clip(_nearest_int(sub * inv[:, :, None]), -32, 31) + 32
    # zero-scale sub-blocks keep the search quants; fully dead blocks zero out
    L = np.where((d_eff == 0)[:, :, None], L0, L)
    L = np.where(dead[:, None, None], 0, L).reshape(nb, QK_K).astype(np.uint8)
    half = L.reshape(nb, 2, 128)
    ql = np.empty((nb, 2, 64), np.uint8)
    qh = np.empty((nb, 2, 32), np.uint8)
    q1, q2 = half[:, :, 0:32], half[:, :, 32:64]
    q3, q4 = half[:, :, 64:96], half[:, :, 96:128]
    ql[:, :, 0:32] = (q1 & 0x0F) | ((q3 & 0x0F) << 4)
    ql[:, :, 32:64] = (q2 & 0x0F) | ((q4 & 0x0F) << 4)
    qh[:, :, :] = (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
    out = np.empty((nb, 210), dtype=np.uint8)
    out[:, 0:128] = ql.reshape(nb, 128)
    out[:, 128:192] = qh.reshape(nb, 64)
    out[:, 192:208] = sc8.view(np.uint8)
    out[:, 208:210] = _f16_bytes(np.where(dead, 0.0, d).astype(F32))
    return out.reshape(n_rows, -1)


def _q_iq4_xs(x: np.ndarray, qw: np.ndarray) -> np.ndarray:
    from .quantize_np import quantize_iq4_xs

    return quantize_iq4_xs(x, qw)


from .quantize_iq import (quantize_iq1_m, quantize_iq1_s,  # noqa: E402
                          quantize_iq2_s, quantize_iq2_xs, quantize_iq2_xxs,
                          quantize_iq3_s, quantize_iq3_xxs)

_WEIGHTED = {
    GGMLType.Q4_K: quantize_q4_k,
    GGMLType.Q5_K: quantize_q5_k,
    GGMLType.Q6_K: quantize_q6_k,
    GGMLType.IQ4_XS: _q_iq4_xs,
    GGMLType.IQ2_XXS: quantize_iq2_xxs,
    GGMLType.IQ2_XS: quantize_iq2_xs,
    GGMLType.IQ2_S: quantize_iq2_s,
    GGMLType.IQ3_XXS: quantize_iq3_xxs,
    GGMLType.IQ3_S: quantize_iq3_s,
    GGMLType.IQ1_S: quantize_iq1_s,
    GGMLType.IQ1_M: quantize_iq1_m,
}


def quantize_weighted(x: np.ndarray, ggml_type: GGMLType,
                      qw: np.ndarray | None) -> np.ndarray:
    """Weighted when an imatrix row is available and the format supports it;
    falls back to the unweighted encoder otherwise."""
    fn = _WEIGHTED.get(ggml_type)
    if fn is None or qw is None:
        from .quantize_np import quantize

        return quantize(x, ggml_type)
    return fn(x, qw)
