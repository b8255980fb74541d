"""IQ-family encoders: importance-weighted codebook quantization.

The port's copy of prima_tpu/quant/quantize_iq.py, over the port's own
codebook tables (dequant_np._codebook).

The analogue of the reference's quantize_row_iq{1,2,3}* implementations
(ggml/src/ggml-quants.c:13433+): weights are folded to magnitudes with an
even-parity sign fix, matched against the fixed E8-lattice grid tables, and
block scales are found by candidate search + weighted least squares.

Instead of the reference's kmap/neighbour lists, every grid entry is scored
in one vectorized pass (err(g; s) = s^2<w,g^2> - 2s<w|x|,g> + const, so the
per-group <w|x|,g> and <w,g^2> matmuls are computed ONCE and reused across
all candidate scales) — an exhaustive search that is simpler and at least
as accurate as the reference's neighbour heuristic. The emitted bytes are
valid wire format (verified in tests by decoding through the reference
implementation compiled as an oracle).

All encoders accept an optional per-column importance row (imatrix); the
default weight is sqrt(sigma2 + x^2) as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np

from ..gguf.constants import QK_K
from .dequant_np import _codebook

F32 = np.float32
GROUP_MAX_EPS = 1e-15


@functools.lru_cache(maxsize=None)
def _grid(name: str, gsize: int) -> np.ndarray:
    g = _codebook(name)
    dt = np.uint8 if g.dtype == np.uint64 or g.dtype == np.uint32 else None
    assert dt is not None
    return g.view(np.uint8).reshape(-1, 8 if g.dtype == np.uint64 else 4).astype(np.float32)[:, :gsize]


@functools.lru_cache(maxsize=None)
def _ksigns_index() -> np.ndarray:
    """8-bit sign mask -> 7-bit ksigns code (or -1 if invalid parity)."""
    ks = _codebook("ksigns_iq2xs")
    idx = np.full(256, -1, np.int32)
    for code, mask in enumerate(np.asarray(ks)):
        idx[mask] = code
    return idx


def _weights(xb: np.ndarray, qw: np.ndarray | None) -> np.ndarray:
    """(nb, QK_K) superblock weights: qw * sqrt(sigma2 + x^2)."""
    sigma2 = np.mean(xb * xb, axis=-1, keepdims=True)
    w = np.sqrt(sigma2 + xb * xb)
    if qw is not None:
        w = w * qw
    return w.astype(F32)


def _fold_signs(xb: np.ndarray, w: np.ndarray, gsize: int, parity: bool):
    """Fold signs of groups of `gsize` into magnitudes.

    parity=True additionally restricts each 8-element span to an even number
    of negatives (the ksigns constraint), flipping the least-important
    element when needed. Returns (|x| (nb, n), sign_mask_per_8 (nb, n//8))."""
    nb, n = xb.shape
    xa = np.abs(xb)
    neg = (xb < 0)
    spans = neg.reshape(nb, n // 8, 8)
    if parity:
        odd = spans.sum(axis=-1) % 2 == 1  # (nb, n//8)
        imp = (w * xb * xb).reshape(nb, n // 8, 8)
        imin = imp.argmin(axis=-1)
        flip = odd[..., None] & (np.arange(8) == imin[..., None])
        spans = spans ^ flip
        xa = np.where(flip.reshape(nb, n), -xa, xa)  # folded value flips sign
    mask = (spans << np.arange(8)).sum(axis=-1).astype(np.int32)
    return xa, mask


def _group_tables(xa: np.ndarray, w: np.ndarray, grid: np.ndarray):
    """Per group: A[g] = <w*|x|, grid_g>, B[g] = <w, grid_g^2>.

    xa, w: (ng, gsize); grid: (G, gsize). Returns (ng, G) each."""
    a = (w * xa) @ grid.T
    b = w @ (grid * grid).T
    return a.astype(F32), np.maximum(b, 1e-20).astype(F32)


def _best_scaled_fit(a, b, xmax, gmax: float, n_cand: int = 13):
    """Joint (grid index, block scale) search.

    a, b: (nb, gpb, G). xmax: (nb,) max folded magnitude per scale block;
    gmax: the largest grid magnitude. Candidate scales sweep xmax/(f*gmax)
    for f in [0.7, 1.3] (the reference's is-loop equivalent); each candidate
    picks per-group grid entries then refits the block scale by weighted
    least squares, and the best (scale, grids) pair wins.
    Returns (idx (nb, gpb), scale (nb,))."""
    nb, gpb, G = a.shape
    best_metric = np.full(nb, -1.0, F32)
    best_idx = np.zeros((nb, gpb), np.int32)
    best_scale = np.zeros(nb, F32)
    safe_max = np.maximum(xmax, GROUP_MAX_EPS)
    for f in np.linspace(0.7, 1.3, n_cand):
        s = (safe_max / (f * gmax)).astype(F32)  # (nb,)
        # argmax_g 2 s A - s^2 B per group
        metric = 2.0 * s[:, None, None] * a - (s * s)[:, None, None] * b
        idx = metric.argmax(axis=-1)  # (nb, gpb)
        ga = np.take_along_axis(a, idx[..., None], axis=-1)[..., 0]
        gb = np.take_along_axis(b, idx[..., None], axis=-1)[..., 0]
        sa, sb = ga.sum(axis=-1), gb.sum(axis=-1)
        ls_scale = np.where(sb > 0, sa / np.maximum(sb, 1e-20), 0.0)
        m = np.where(sb > 0, ls_scale * sa, -1.0)
        upd = m > best_metric
        best_metric = np.where(upd, m, best_metric)
        best_scale = np.where(upd, np.maximum(ls_scale, 0.0), best_scale)
        best_idx = np.where(upd[:, None], idx, best_idx)
    return best_idx, best_scale


def _ls_codes(scales, d, ls_max):
    with np.errstate(divide="ignore", invalid="ignore"):
        l = np.rint(0.5 * (scales / np.maximum(d, 1e-30)[:, None] - 1.0))
    return np.clip(np.nan_to_num(l), 0, ls_max).astype(np.int64)


def quantize_iq2_xxs(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ2_XXS (66 B / 256): per-8 grid idx (256-entry), 7-bit ksigns codes,
    4-bit scale per 32, f16 d per superblock."""
    grid = _grid("iq2xxs_grid", 8)  # odd magnitudes 1..7 (as float)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K).astype(F32)
    nsb = xb.shape[0]
    qw_b = (np.broadcast_to(qw.astype(F32), (n_rows, n)).reshape(-1, QK_K)
            if qw is not None else None)
    w = _weights(xb, qw_b)
    xa, smask = _fold_signs(xb, w, 8, parity=True)
    scode = _ksigns_index()[smask]  # (nsb, 32) all valid by construction
    assert (scode >= 0).all()

    a, b = _group_tables(xa.reshape(-1, 8), w.reshape(-1, 8), grid)
    a = a.reshape(nsb, 8, 4, grid.shape[0])  # 8 scale blocks x 4 groups
    b = b.reshape(nsb, 8, 4, grid.shape[0])
    xmax = xa.reshape(nsb, 8, 32).max(axis=-1).reshape(-1)
    idx, scale = _best_scaled_fit(a.reshape(-1, 4, grid.shape[0]),
                                  b.reshape(-1, 4, grid.shape[0]), xmax,
                                  float(grid.max()))
    idx = idx.reshape(nsb, 8, 4)
    scales = scale.reshape(nsb, 8)

    # superblock: db = d*(0.5+ls)*0.25 -> effective q scale = d*(1+2ls)/8
    # so scales ~ d*(1+2ls)/8; choose d = 8*max/31 ... fold the /8 into d:
    max_scale = scales.max(axis=-1)
    d = (8.0 * max_scale / 31.0).astype(np.float16)
    df = d.astype(F32)
    ls = _ls_codes(8.0 * scales, df, 15)  # (nsb, 8)

    aux0 = (idx.astype(np.uint32) << (8 * np.arange(4))).sum(axis=-1)
    aux1 = (scode.reshape(nsb, 8, 4).astype(np.uint32)
            << (7 * np.arange(4))).sum(axis=-1)
    aux1 |= ls.astype(np.uint32) << 28
    out = np.empty((nsb, 66), np.uint8)
    out[:, 0:2] = d.view(np.uint16).view(np.uint8).reshape(nsb, 2)
    qs = np.empty((nsb, 8, 2), np.uint32)
    qs[:, :, 0] = aux0
    qs[:, :, 1] = aux1
    out[:, 2:66] = qs.view(np.uint8).reshape(nsb, 64)
    return out.reshape(n_rows, -1)


def quantize_iq2_xs(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ2_XS (74 B / 256): u16 = 9-bit idx (512-entry grid) + 7-bit ksigns,
    4-bit scale per 16."""
    grid = _grid("iq2xs_grid", 8)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K).astype(F32)
    nsb = xb.shape[0]
    qw_b = (np.broadcast_to(qw.astype(F32), (n_rows, n)).reshape(-1, QK_K)
            if qw is not None else None)
    w = _weights(xb, qw_b)
    xa, smask = _fold_signs(xb, w, 8, parity=True)
    scode = _ksigns_index()[smask]
    assert (scode >= 0).all()

    a, b = _group_tables(xa.reshape(-1, 8), w.reshape(-1, 8), grid)
    G = grid.shape[0]
    xmax = xa.reshape(nsb, 16, 16).max(axis=-1).reshape(-1)  # per-16 scale
    idx, scale = _best_scaled_fit(a.reshape(-1, 2, G), b.reshape(-1, 2, G),
                                  xmax, float(grid.max()))
    idx = idx.reshape(nsb, 16, 2)
    scales = scale.reshape(nsb, 16)

    max_scale = scales.max(axis=-1)
    d = (8.0 * max_scale / 31.0).astype(np.float16)
    ls = _ls_codes(8.0 * scales, d.astype(F32), 15)  # (nsb, 16)

    u16 = (idx.reshape(nsb, 32) | (scode << 9)).astype(np.uint16)
    out = np.empty((nsb, 74), np.uint8)
    out[:, 0:2] = d.view(np.uint16).view(np.uint8).reshape(nsb, 2)
    out[:, 2:66] = u16.view(np.uint8).reshape(nsb, 64)
    packed = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)
    out[:, 66:74] = packed
    return out.reshape(n_rows, -1)


def quantize_iq2_s(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ2_S (82 B / 256): 10-bit idx (1024-entry grid) split qs/qh, RAW sign
    bytes (no parity constraint), 4-bit scale per 16."""
    grid = _grid("iq2s_grid", 8)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K).astype(F32)
    nsb = xb.shape[0]
    qw_b = (np.broadcast_to(qw.astype(F32), (n_rows, n)).reshape(-1, QK_K)
            if qw is not None else None)
    w = _weights(xb, qw_b)
    xa, smask = _fold_signs(xb, w, 8, parity=False)

    a, b = _group_tables(xa.reshape(-1, 8), w.reshape(-1, 8), grid)
    G = grid.shape[0]
    xmax = xa.reshape(nsb, 16, 16).max(axis=-1).reshape(-1)
    idx, scale = _best_scaled_fit(a.reshape(-1, 2, G), b.reshape(-1, 2, G),
                                  xmax, float(grid.max()))
    idx = idx.reshape(nsb, 32)
    scales = scale.reshape(nsb, 16)

    max_scale = scales.max(axis=-1)
    d = (8.0 * max_scale / 31.0).astype(np.float16)
    ls = _ls_codes(8.0 * scales, d.astype(F32), 15)

    out = np.empty((nsb, 82), np.uint8)
    out[:, 0:2] = d.view(np.uint16).view(np.uint8).reshape(nsb, 2)
    out[:, 2:34] = (idx & 0xFF).astype(np.uint8)
    out[:, 34:66] = smask.astype(np.uint8)
    # qh: 2 high bits per idx, 4 idx per ib32 -> (qh >> (8-2l)) & 0x300
    hi = (idx >> 8).reshape(nsb, 8, 4)
    qh = np.zeros((nsb, 8), np.uint8)
    for l in range(4):
        qh |= (hi[:, :, l] << (2 * l)).astype(np.uint8)
    out[:, 66:74] = qh
    out[:, 74:82] = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)
    return out.reshape(n_rows, -1)


def quantize_iq3_xxs(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ3_XXS (98 B / 256): per-4 grid idx (256-entry), 7-bit ksigns per 8,
    4-bit scale per 32; db = d*(0.5+s)*0.5."""
    grid = _grid("iq3xxs_grid", 4)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K).astype(F32)
    nsb = xb.shape[0]
    qw_b = (np.broadcast_to(qw.astype(F32), (n_rows, n)).reshape(-1, QK_K)
            if qw is not None else None)
    w = _weights(xb, qw_b)
    xa, smask = _fold_signs(xb, w, 4, parity=True)
    scode = _ksigns_index()[smask]
    assert (scode >= 0).all()

    a, b = _group_tables(xa.reshape(-1, 4), w.reshape(-1, 4), grid)
    G = grid.shape[0]
    xmax = xa.reshape(nsb, 8, 32).max(axis=-1).reshape(-1)
    idx, scale = _best_scaled_fit(a.reshape(-1, 8, G), b.reshape(-1, 8, G),
                                  xmax, float(grid.max()))
    idx = idx.reshape(nsb, 8, 8)
    scales = scale.reshape(nsb, 8)

    # db = d*(0.5+s)*0.5 -> q scale = d*(1+2s)/4; d = 4*max/31
    max_scale = scales.max(axis=-1)
    d = (4.0 * max_scale / 31.0).astype(np.float16)
    ls = _ls_codes(4.0 * scales, d.astype(F32), 15)

    out = np.empty((nsb, 98), np.uint8)
    out[:, 0:2] = d.view(np.uint16).view(np.uint8).reshape(nsb, 2)
    out[:, 2:66] = idx.reshape(nsb, 64).astype(np.uint8)
    aux = (scode.reshape(nsb, 8, 4).astype(np.uint32)
           << (7 * np.arange(4))).sum(axis=-1)
    aux |= ls.astype(np.uint32) << 28
    out[:, 66:98] = aux.astype(np.uint32).view(np.uint8).reshape(nsb, 32)
    return out.reshape(n_rows, -1)


def quantize_iq3_s(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ3_S (110 B / 256): 9-bit idx (512-entry grid) split qs/qh, raw sign
    bytes, 4-bit scale per 32; db = d*(1+2*ls)."""
    grid = _grid("iq3s_grid", 4)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K).astype(F32)
    nsb = xb.shape[0]
    qw_b = (np.broadcast_to(qw.astype(F32), (n_rows, n)).reshape(-1, QK_K)
            if qw is not None else None)
    w = _weights(xb, qw_b)
    xa, smask = _fold_signs(xb, w, 4, parity=False)

    a, b = _group_tables(xa.reshape(-1, 4), w.reshape(-1, 4), grid)
    G = grid.shape[0]
    xmax = xa.reshape(nsb, 8, 32).max(axis=-1).reshape(-1)
    idx, scale = _best_scaled_fit(a.reshape(-1, 8, G), b.reshape(-1, 8, G),
                                  xmax, float(grid.max()))
    idx = idx.reshape(nsb, 8, 8)
    scales = scale.reshape(nsb, 8)

    # db = d*(1+2*ls): d = max/31
    max_scale = scales.max(axis=-1)
    d = (max_scale / 31.0).astype(np.float16)
    ls = _ls_codes(scales, d.astype(F32), 15)

    out = np.empty((nsb, 110), np.uint8)
    out[:, 0:2] = d.view(np.uint16).view(np.uint8).reshape(nsb, 2)
    out[:, 2:66] = (idx.reshape(nsb, 64) & 0xFF).astype(np.uint8)
    hi = (idx >> 8).reshape(nsb, 8, 8)  # 1 high bit per qs byte
    qh = np.zeros((nsb, 8), np.uint8)
    for j in range(8):
        qh |= (hi[:, :, j] << j).astype(np.uint8)
    out[:, 66:74] = qh
    out[:, 74:106] = smask.astype(np.uint8)
    out[:, 106:110] = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)
    return out.reshape(n_rows, -1)


IQ1_DELTA = 0.125


@functools.lru_cache(maxsize=None)
def _signed_grid(name: str) -> np.ndarray:
    """u64 grid entries as SIGNED per-byte values (iq1s: {-1, 0, 1})."""
    g = _codebook(name)
    return g.view(np.uint8).reshape(-1, 8).view(np.int8).astype(np.float32)


def _iq1_tables(xa, w, grid):
    """Base tables for delta-shifted grids: returns (Ag, Bg, Cg, Sx, Sw) so
    A(d)=Ag+d*Sx, B(d)=Bg+2d*Cg+d^2*Sw for grid values (g + d)."""
    ag = (w * xa) @ grid.T
    bg = w @ (grid * grid).T
    cg = w @ grid.T
    sx = (w * xa).sum(axis=-1, keepdims=True)
    sw = w.sum(axis=-1, keepdims=True)
    return ag, bg, cg, sx, sw


def quantize_iq1_s(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ1_S (50 B / 256): per-8 grid idx (2048-entry ternary grid), 3-bit
    scale + block-wide +-IQ1S_DELTA shift per 32
    (quantize_row_iq1_s_impl, ggml-quants.c:14608)."""
    grid = _signed_grid("iq1s_grid")
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K).astype(F32)
    nsb = xb.shape[0]
    qw_b = (np.broadcast_to(qw.astype(F32), (n_rows, n)).reshape(-1, QK_K)
            if qw is not None else None)
    w = _weights(xb, qw_b)

    # signed grid: no folding; per 32-block delta in {+0.125, -0.125}
    xg = xb.reshape(-1, 8)
    wg = w.reshape(-1, 8)
    ag, bg, cg, sx, sw = _iq1_tables(xg, wg, grid)
    G = grid.shape[0]
    nblk = nsb * 8  # 32-elem scale blocks
    xmax = np.abs(xb).reshape(nblk, 32).max(axis=-1)

    best = (None, None, None, np.full(nblk, -1.0, F32))
    for dsign in (1.0, -1.0):
        d = dsign * IQ1_DELTA
        a = (ag + d * sx).reshape(nblk, 4, G)
        b = np.maximum(bg + 2 * d * cg + d * d * sw, 1e-20).reshape(nblk, 4, G)
        idx, scale = _best_scaled_fit(a, b, xmax, 1.0 + IQ1_DELTA)
        ga = np.take_along_axis(a, idx[..., None], axis=-1)[..., 0].sum(-1)
        metric = scale * np.maximum(ga, 0.0)
        if best[0] is None:
            best = (idx, scale, np.full(nblk, dsign == -1.0), metric)
        else:
            upd = metric > best[3]
            best = (np.where(upd[:, None], idx, best[0]),
                    np.where(upd, scale, best[1]),
                    np.where(upd, dsign == -1.0, best[2]),
                    np.where(upd, metric, best[3]))
    idx, scale, neg_delta, _ = best
    idx = idx.reshape(nsb, 8, 4)
    scales = scale.reshape(nsb, 8)
    neg_delta = neg_delta.reshape(nsb, 8)

    # dl = d*(2*sh+1), sh 3-bit: d = max/15
    max_scale = scales.max(axis=-1)
    d16 = (max_scale / 15.0).astype(np.float16)
    sh = np.clip(np.nan_to_num(np.rint(
        0.5 * (scales / np.maximum(d16.astype(F32), 1e-30)[:, None] - 1.0))),
        0, 7).astype(np.uint32)

    out = np.empty((nsb, 50), np.uint8)
    out[:, 0:2] = d16.view(np.uint16).view(np.uint8).reshape(nsb, 2)
    out[:, 2:34] = (idx & 0xFF).astype(np.uint8).reshape(nsb, 32)
    hi = (idx >> 8).astype(np.uint32)  # 3 high bits per group
    qh = (hi << (3 * np.arange(4))).sum(axis=-1).astype(np.uint32)
    qh |= sh << 12
    qh |= neg_delta.astype(np.uint32) << 15
    out[:, 34:50] = qh.astype(np.uint16).view(np.uint8).reshape(nsb, 16)
    return out.reshape(n_rows, -1)


def quantize_iq1_m(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ1_M (56 B / 256): per-8 (grid idx, +-delta) pairs — searched as one
    4096-entry extended grid — 3-bit scale per 16, f16 superblock scale
    spread across the scale-word high nibbles
    (quantize_row_iq1_m_impl, ggml-quants.c:14821)."""
    grid = _signed_grid("iq1s_grid")
    ext = np.concatenate([grid + IQ1_DELTA, grid - IQ1_DELTA])  # (4096, 8)
    n_rows, n = x.shape
    xb = x.reshape(-1, QK_K).astype(F32)
    nsb = xb.shape[0]
    qw_b = (np.broadcast_to(qw.astype(F32), (n_rows, n)).reshape(-1, QK_K)
            if qw is not None else None)
    w = _weights(xb, qw_b)

    a, b = _group_tables(xb.reshape(-1, 8), w.reshape(-1, 8), ext)
    G2 = ext.shape[0]
    nblk = nsb * 16  # 16-elem scale blocks, 2 groups each
    xmax = np.abs(xb).reshape(nblk, 16).max(axis=-1)
    eidx, scale = _best_scaled_fit(a.reshape(nblk, 2, G2),
                                   b.reshape(nblk, 2, G2), xmax,
                                   1.0 + IQ1_DELTA)
    neg_delta = (eidx >= 2048).reshape(nsb, 16, 2)
    idx = (eidx % 2048).reshape(nsb, 16, 2)
    scales = scale.reshape(nsb, 16)

    # dl = d*(2*c+1), c 3-bit: d = max/15, f16 bits spread across nibbles
    max_scale = scales.max(axis=-1)
    d16 = (max_scale / 15.0).astype(np.float16)
    dbits = d16.view(np.uint16).astype(np.uint32)
    codes = np.clip(np.nan_to_num(np.rint(
        0.5 * (scales / np.maximum(d16.astype(F32), 1e-30)[:, None] - 1.0))),
        0, 7).astype(np.uint32)  # (nsb, 16)

    out = np.empty((nsb, 56), np.uint8)
    out[:, 0:32] = (idx & 0xFF).astype(np.uint8).reshape(nsb, 32)
    # qh: 2 bytes per 32-block; nibble per group: 3 idx-high bits + delta bit
    hi = (idx >> 8).astype(np.uint32).reshape(nsb, 8, 4)
    dneg = neg_delta.astype(np.uint32).reshape(nsb, 8, 4)
    nib = hi | (dneg << 3)  # (nsb, 8, 4)
    qh = np.empty((nsb, 8, 2), np.uint8)
    qh[:, :, 0] = (nib[:, :, 0] | (nib[:, :, 1] << 4)).astype(np.uint8)
    qh[:, :, 1] = (nib[:, :, 2] | (nib[:, :, 3] << 4)).astype(np.uint8)
    out[:, 32:48] = qh.reshape(nsb, 16)
    # scale words: per u16 w: c[4w..4w+3] in 3-bit fields + d nibble w<<12
    c = codes.reshape(nsb, 4, 4)
    sc = (c[:, :, 0] | (c[:, :, 1] << 3) | (c[:, :, 2] << 6)
          | (c[:, :, 3] << 9))
    dn = (dbits[:, None] >> (4 * np.arange(4))) & 0xF
    sc = sc | (dn << 12)
    out[:, 48:56] = sc.astype(np.uint16).view(np.uint8).reshape(nsb, 8)
    return out.reshape(n_rows, -1)
