"""Host-side conversion: GGUF block formats -> TPU-friendly uniform layout.

Every supported weight format is re-laid-out at load time into a UQTensor:

    y[r, c] = scales[r, c // sub] * q[r, c] - mins[r, c // sub]

with q integer. Sub-block scales are premultiplied on the host in f32 with
the reference's rounding order (e.g. Q4_K's d*sc, dmin*m — ggml-quants.c:2555),
so device dequant stays bit-identical to the reference while the device only
ever sees two layouts:

  - 'int8':  qs int8 (rows, K)            — Q5/Q6/Q8/Q2/Q3/IQ* after decode
  - 'nib4':  qs uint8 (rows, K/2)         — 4-bit formats; byte i packs
             col i (low nibble) and col i + K/2 (high nibble), so a kernel
             tile never interleaves: the low half of the columns comes from
             low nibbles, the high half from high nibbles.

This is the TPU analogue of the reference's repacked CPU layouts
(ggml/src/ggml-aarch64.c): one load-time shuffle buys branch-free kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..gguf.constants import GGMLType, QK_K
from .dequant_np import _blocks, _codebook, _f16, _get_scale_min_k4, _q3k_scales

F32 = np.float32


@dataclass
class UQTensor:
    """Uniform quantized tensor (host numpy arrays, ready for device_put).

    Two scale representations:
      * flat (gsub == 1): `scales`/`mins` are f32 (rows, S) premultiplied
        per-sub-block values; `d`/`dmin` are None.
      * grouped (gsub > 1, the K-quant superblock structure): `scales`/`mins`
        are int8 codes (rows, S) and `d`/`dmin` are f32 (rows, S // gsub)
        per-superblock bases. The effective scale of sub-block s is
        d[s // gsub] * scales[s], multiplied in f32 ON DEVICE — the same
        single f32 rounding the reference applies (ggml-quants.c:2555
        `d * sc`), so dequant stays bit-exact while a Q4_K row streams
        4.75 bits/weight from HBM instead of 6.
    """

    qs: np.ndarray  # int8 (rows, K) | uint8 (rows, K/2)
    scales: np.ndarray  # f32 (rows, S) | int8 codes (rows, S); S = K // sub
    mins: np.ndarray | None  # same representation as scales, or None
    sub: int  # sub-block size (16 or 32)
    layout: str  # 'int8' | 'nib4'
    q_offset: int  # added to unpacked nibbles before scaling (nib4 only)
    ggml_type: GGMLType
    shape: tuple[int, int]  # (rows, K)
    d: np.ndarray | None = None  # f32 (rows, S // gsub) when gsub > 1
    dmin: np.ndarray | None = None  # f32 (rows, S // gsub) when mins grouped
    gsub: int = 1  # sub-blocks per scale group (QK_K // sub for K-quants)

    @property
    def nbytes(self) -> int:
        n = self.qs.nbytes + self.scales.nbytes
        for a in (self.mins, self.d, self.dmin):
            if a is not None:
                n += a.nbytes
        return n


def _pack_nib4(q: np.ndarray) -> np.ndarray:
    """(rows, K) uint8 values 0..15 -> (rows, K/2) canonical nib4 bytes."""
    rows, k = q.shape
    half = k // 2
    return (q[:, :half] | (q[:, half:] << 4)).astype(np.uint8)


def unpack_nib4(packed: np.ndarray, q_offset: int) -> np.ndarray:
    """Inverse of _pack_nib4 (host reference; kernels do this on device)."""
    lo = (packed & 0x0F).astype(np.int8) + q_offset
    hi = (packed >> 4).astype(np.int8) + q_offset
    return np.concatenate([lo, hi], axis=-1)


# --- per-format converters: raw (rows, row_bytes) -> UQTensor -------------


def _conv_q4_0(raw: np.ndarray, k: int) -> UQTensor:
    rows = raw.shape[0]
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2]).reshape(rows, -1)  # (rows, nb)
    qs = b[:, 2:18]
    lo = qs & 0x0F
    hi = qs >> 4
    q = np.concatenate([lo, hi], axis=1).reshape(rows, k).astype(np.uint8)
    return UQTensor(_pack_nib4(q), d, None, 32, "nib4", -8, GGMLType.Q4_0, (rows, k))


def _conv_q4_1(raw: np.ndarray, k: int) -> UQTensor:
    rows = raw.shape[0]
    b = _blocks(raw, 20)
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    m = _f16(b[:, 2:4]).reshape(rows, -1)
    qs = b[:, 4:20]
    q = np.concatenate([qs & 0x0F, qs >> 4], axis=1).reshape(rows, k).astype(np.uint8)
    return UQTensor(_pack_nib4(q), d, -m, 32, "nib4", 0, GGMLType.Q4_1, (rows, k))


def _conv_q5_0(raw: np.ndarray, k: int) -> UQTensor:
    rows = raw.shape[0]
    b = _blocks(raw, 22)
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    qh = b[:, 2:6].copy().view(np.uint32)
    qs = b[:, 6:22]
    j = np.arange(16, dtype=np.uint32)
    xh0 = (((qh >> j) << 4) & 0x10).astype(np.uint8)
    xh1 = ((qh >> (j + 12)) & 0x10).astype(np.uint8)
    x0 = ((qs & 0x0F) | xh0).astype(np.int16) - 16
    x1 = ((qs >> 4) | xh1).astype(np.int16) - 16
    q = np.concatenate([x0, x1], axis=1).reshape(rows, k).astype(np.int8)
    return UQTensor(q, d, None, 32, "int8", 0, GGMLType.Q5_0, (rows, k))


def _conv_q5_1(raw: np.ndarray, k: int) -> UQTensor:
    rows = raw.shape[0]
    b = _blocks(raw, 24)
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    m = _f16(b[:, 2:4]).reshape(rows, -1)
    qh = b[:, 4:8].copy().view(np.uint32)
    qs = b[:, 8:24]
    j = np.arange(16, dtype=np.uint32)
    xh0 = (((qh >> j) << 4) & 0x10).astype(np.uint8)
    xh1 = ((qh >> (j + 12)) & 0x10).astype(np.uint8)
    x0 = (qs & 0x0F) | xh0
    x1 = (qs >> 4) | xh1
    q = np.concatenate([x0, x1], axis=1).reshape(rows, k).astype(np.int8)
    return UQTensor(q, d, -m, 32, "int8", 0, GGMLType.Q5_1, (rows, k))


def _conv_q8_0(raw: np.ndarray, k: int) -> UQTensor:
    rows = raw.shape[0]
    b = _blocks(raw, 34)
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    q = b[:, 2:34].copy().view(np.int8).reshape(rows, k)
    return UQTensor(q, d, None, 32, "int8", 0, GGMLType.Q8_0, (rows, k))


def _conv_q4_k(raw: np.ndarray, k: int) -> UQTensor:
    rows = raw.shape[0]
    b = _blocks(raw, 144)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    dmin = _f16(b[:, 2:4]).reshape(rows, -1)
    sc, mn = _get_scale_min_k4(b[:, 4:16])  # (nb, 8) 6-bit codes
    qs4 = b[:, 16:144].reshape(nb, 4, 32)
    q = np.stack([qs4 & 0x0F, qs4 >> 4], axis=2).reshape(nb, 256).reshape(rows, k)
    return UQTensor(_pack_nib4(q.astype(np.uint8)),
                    sc.astype(np.int8).reshape(rows, -1),
                    mn.astype(np.int8).reshape(rows, -1),
                    32, "nib4", 0, GGMLType.Q4_K, (rows, k),
                    d=d, dmin=dmin, gsub=8)


def _conv_q5_k(raw: np.ndarray, k: int) -> UQTensor:
    rows = raw.shape[0]
    b = _blocks(raw, 176)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    dmin = _f16(b[:, 2:4]).reshape(rows, -1)
    sc, mn = _get_scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]
    qs4 = b[:, 48:176].reshape(nb, 4, 32)
    lo = (qs4 & 0x0F).astype(np.int16)
    hi = (qs4 >> 4).astype(np.int16)
    g = np.arange(4)
    u1 = (1 << (2 * g)).astype(np.uint8)[None, :, None]
    u2 = (2 << (2 * g)).astype(np.uint8)[None, :, None]
    hb1 = np.where((qh[:, None, :] & u1) != 0, 16, 0)
    hb2 = np.where((qh[:, None, :] & u2) != 0, 16, 0)
    q = np.stack([lo + hb1, hi + hb2], axis=2).reshape(nb, 256).reshape(rows, k)
    return UQTensor(q.astype(np.int8),
                    sc.astype(np.int8).reshape(rows, -1),
                    mn.astype(np.int8).reshape(rows, -1),
                    32, "int8", 0, GGMLType.Q5_K, (rows, k),
                    d=d, dmin=dmin, gsub=8)


def _conv_q6_k(raw: np.ndarray, k: int) -> UQTensor:
    rows = raw.shape[0]
    b = _blocks(raw, 210)
    nb = b.shape[0]
    ql = b[:, 0:128].reshape(nb, 2, 64)
    qh = b[:, 128:192].reshape(nb, 2, 32)
    sc = b[:, 192:208].copy().view(np.int8)  # (nb, 16) codes, order = scale idx
    d = _f16(b[:, 208:210]).reshape(rows, -1)
    q = np.empty((nb, 2, 128), dtype=np.int8)
    q1 = ((ql[:, :, 0:32] & 0x0F) | (((qh >> 0) & 3) << 4)).astype(np.int8) - 32
    q2 = ((ql[:, :, 32:64] & 0x0F) | (((qh >> 2) & 3) << 4)).astype(np.int8) - 32
    q3 = ((ql[:, :, 0:32] >> 4) | (((qh >> 4) & 3) << 4)).astype(np.int8) - 32
    q4 = ((ql[:, :, 32:64] >> 4) | (((qh >> 6) & 3) << 4)).astype(np.int8) - 32
    q[:, :, 0:32], q[:, :, 32:64], q[:, :, 64:96], q[:, :, 96:128] = q1, q2, q3, q4
    return UQTensor(q.reshape(rows, k), sc.reshape(rows, -1), None,
                    16, "int8", 0, GGMLType.Q6_K, (rows, k), d=d, gsub=16)


def _conv_q2_k(raw: np.ndarray, k: int) -> UQTensor:
    rows = raw.shape[0]
    b = _blocks(raw, 84)
    nb = b.shape[0]
    sc8 = b[:, 0:16]
    d = _f16(b[:, 80:82]).reshape(rows, -1)
    dmin = _f16(b[:, 82:84]).reshape(rows, -1)
    qs = b[:, 16:80].reshape(nb, 2, 32)
    q = np.empty((nb, 2, 128), dtype=np.int8)
    for j in range(4):
        q[:, :, 32 * j : 32 * j + 32] = ((qs >> (2 * j)) & 3).astype(np.int8)
    return UQTensor(q.reshape(rows, k),
                    (sc8 & 0x0F).astype(np.int8).reshape(rows, -1),
                    (sc8 >> 4).astype(np.int8).reshape(rows, -1),
                    16, "int8", 0, GGMLType.Q2_K, (rows, k),
                    d=d, dmin=dmin, gsub=16)


def _conv_q3_k(raw: np.ndarray, k: int) -> UQTensor:
    rows = raw.shape[0]
    b = _blocks(raw, 110)
    nb = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96].reshape(nb, 2, 32)
    s16 = _q3k_scales(b[:, 96:108])
    d = _f16(b[:, 108:110]).reshape(rows, -1)
    q = np.empty((nb, 2, 128), dtype=np.int8)
    for h in range(2):
        for j in range(4):
            mbit = np.uint8(1 << (4 * h + j))
            lo = ((qs[:, h, :] >> (2 * j)) & 3).astype(np.int8)
            sub4 = np.where((hmask & mbit) != 0, 0, 4).astype(np.int8)
            q[:, h, 32 * j : 32 * j + 32] = lo - sub4
    return UQTensor(q.reshape(rows, k),
                    (s16 - 32).astype(np.int8).reshape(rows, -1), None,
                    16, "int8", 0, GGMLType.Q3_K, (rows, k), d=d, gsub=16)


def _conv_iq4_nl(raw: np.ndarray, k: int) -> UQTensor:
    kvalues = _codebook("kvalues_iq4nl")
    rows = raw.shape[0]
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    qs = b[:, 2:18]
    q = np.concatenate([kvalues[qs & 0x0F], kvalues[qs >> 4]], axis=1).reshape(rows, k)
    return UQTensor(q.astype(np.int8), d, None, 32, "int8", 0, GGMLType.IQ4_NL, (rows, k))


def _conv_iq4_xs(raw: np.ndarray, k: int) -> UQTensor:
    kvalues = _codebook("kvalues_iq4nl")
    rows = raw.shape[0]
    b = _blocks(raw, 136)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    scales_h = b[:, 2:4].copy().view(np.uint16).astype(np.int32)
    scales_l = b[:, 4:8].astype(np.int32)
    ib = np.arange(8)
    ls = ((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F) | (((scales_h >> (2 * ib)) & 3) << 4)
    qs = b[:, 8:136].reshape(nb, 8, 16)
    q = np.concatenate([kvalues[qs & 0x0F], kvalues[qs >> 4]], axis=2).reshape(nb, 256)
    return UQTensor(q.reshape(rows, k).astype(np.int8),
                    (ls - 32).astype(np.int8).reshape(rows, -1), None,
                    32, "int8", 0, GGMLType.IQ4_XS, (rows, k), d=d, gsub=8)


def _conv_iq2_xxs(raw: np.ndarray, k: int) -> UQTensor:
    grid = _codebook("iq2xxs_grid").view(np.uint8).reshape(256, 8).astype(np.int16)
    ksigns = _codebook("ksigns_iq2xs")
    rows = raw.shape[0]
    b = _blocks(raw, 66)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    qs = b[:, 2:66].copy().view(np.uint32).reshape(nb, 8, 2)
    aux0, aux1 = qs[:, :, 0], qs[:, :, 1]
    # reference: db = d*(0.5 + aux)*0.25. Equals (d*0.125)*(1 + 2*aux) with a
    # single identically-placed f32 rounding (power-of-two factors are exact),
    # so the grouped form stays bit-exact: d' = d/8, code = 1 + 2*aux <= 31.
    code = (1 + 2 * (aux1 >> 28)).astype(np.int8)
    idx = np.stack([(aux0 >> (8 * l)) & 0xFF for l in range(4)], axis=2)
    sbits = np.stack([(aux1 >> (7 * l)) & 127 for l in range(4)], axis=2)
    mag = grid[idx]  # (nb,8,4,8)
    signs = ksigns[sbits]
    j = np.arange(8, dtype=np.uint8)
    sgn = np.where((signs[..., None] & (1 << j)) != 0, -1, 1).astype(np.int16)
    q = (mag * sgn).reshape(nb, 256)
    assert np.abs(q).max() <= 127
    return UQTensor(q.reshape(rows, k).astype(np.int8),
                    code.reshape(rows, -1), None,
                    32, "int8", 0, GGMLType.IQ2_XXS, (rows, k),
                    d=d * np.float32(0.125), gsub=8)


def _conv_iq2_xs(raw: np.ndarray, k: int) -> UQTensor:
    """IQ2_XS: y = db*g*sign, db = d*(0.5+ls)*0.25 per 16 elems. Stored as
    q = g*sign (|q| <= 43), grouped base d' = d*0.125 (exact power-of-two
    product) and code 1+2*ls <= 31: the device's single f32 multiply d'*code
    reproduces the reference's rounding exactly."""
    grid = _codebook("iq2xs_grid").view(np.uint8).reshape(512, 8).astype(np.int16)
    ksigns = _codebook("ksigns_iq2xs")
    rows = raw.shape[0]
    b = _blocks(raw, 74)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    qs = b[:, 2:66].copy().view(np.uint16).reshape(nb, 8, 4).astype(np.int32)
    sc = b[:, 66:74].astype(np.int32)
    ls = np.stack([sc & 0x0F, sc >> 4], axis=2).reshape(nb, 16)
    code = (1 + 2 * ls).astype(np.int8)
    mag = grid[qs & 511]  # (nb,8,4,8)
    signs = ksigns[qs >> 9]
    j = np.arange(8, dtype=np.uint8)
    sgn = np.where((signs[..., None] & (1 << j)) != 0, -1, 1).astype(np.int16)
    q = (mag * sgn).reshape(nb, 256)
    assert np.abs(q).max() <= 127
    return UQTensor(q.reshape(rows, k).astype(np.int8),
                    code.reshape(rows, -1), None,
                    16, "int8", 0, GGMLType.IQ2_XS, (rows, k),
                    d=d * np.float32(0.125), gsub=16)


def _conv_iq2_s(raw: np.ndarray, k: int) -> UQTensor:
    """IQ2_S: same scale structure as IQ2_XS (d' = d*0.125, code 1+2*ls per
    16 elems); 10-bit grid index from qs + qh, raw sign bytes."""
    grid = _codebook("iq2s_grid").view(np.uint8).reshape(1024, 8).astype(np.int16)
    rows = raw.shape[0]
    b = _blocks(raw, 82)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    qs = b[:, 2:34].reshape(nb, 8, 4).astype(np.int32)
    sbytes = b[:, 34:66].reshape(nb, 8, 4)
    qh = b[:, 66:74].astype(np.int32)
    sc = b[:, 74:82].astype(np.int32)
    ls = np.stack([sc & 0x0F, sc >> 4], axis=2).reshape(nb, 16)
    code = (1 + 2 * ls).astype(np.int8)
    l = np.arange(4)
    idx = qs | ((qh[:, :, None] << (8 - 2 * l)) & 0x300)
    mag = grid[idx]
    j = np.arange(8, dtype=np.uint8)
    sgn = np.where((sbytes[..., None] & (1 << j)) != 0, -1, 1).astype(np.int16)
    q = (mag * sgn).reshape(nb, 256)
    assert np.abs(q).max() <= 127
    return UQTensor(q.reshape(rows, k).astype(np.int8),
                    code.reshape(rows, -1), None,
                    16, "int8", 0, GGMLType.IQ2_S, (rows, k),
                    d=d * np.float32(0.125), gsub=16)


def _conv_iq3_xxs(raw: np.ndarray, k: int) -> UQTensor:
    """IQ3_XXS: db = d*(0.5+s)*0.5 per 32 elems = (d*0.25)*(1+2s)."""
    grid = _codebook("iq3xxs_grid").view(np.uint8).reshape(256, 4).astype(np.int16)
    ksigns = _codebook("ksigns_iq2xs")
    rows = raw.shape[0]
    b = _blocks(raw, 98)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    qs = b[:, 2:66].reshape(nb, 8, 8).astype(np.int32)
    aux = b[:, 66:98].copy().view(np.uint32).reshape(nb, 8)
    code = (1 + 2 * (aux >> 28)).astype(np.int8)
    l = np.arange(4)
    sbits = (aux[:, :, None] >> (7 * l)) & 127
    signs = ksigns[sbits]
    j = np.arange(8, dtype=np.uint8)
    sgn = np.where((signs[..., None] & (1 << j)) != 0, -1, 1).astype(np.int16)
    mag = grid[qs].reshape(nb, 8, 4, 8)
    q = (mag * sgn).reshape(nb, 256)
    assert np.abs(q).max() <= 127
    return UQTensor(q.reshape(rows, k).astype(np.int8),
                    code.reshape(rows, -1), None,
                    32, "int8", 0, GGMLType.IQ3_XXS, (rows, k),
                    d=d * np.float32(0.25), gsub=8)


def _conv_iq3_s(raw: np.ndarray, k: int) -> UQTensor:
    """IQ3_S: db = d*(1+2*ls) per 32 elems — base d' = d unchanged."""
    grid = _codebook("iq3s_grid").view(np.uint8).reshape(512, 4).astype(np.int16)
    rows = raw.shape[0]
    b = _blocks(raw, 110)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    qs = b[:, 2:66].reshape(nb, 8, 8).astype(np.int32)
    qh = b[:, 66:74].astype(np.int32)
    sbytes = b[:, 74:106].reshape(nb, 8, 4)
    sc = b[:, 106:110].astype(np.int32)
    ls = np.stack([sc & 0x0F, sc >> 4], axis=2).reshape(nb, 8)
    code = (1 + 2 * ls).astype(np.int8)
    jbit = np.arange(8)
    idx = qs | (((qh[:, :, None] >> jbit) & 1) << 8)
    mag = grid[idx].reshape(nb, 8, 4, 8)
    j = np.arange(8, dtype=np.uint8)
    sgn = np.where((sbytes[..., None] & (1 << j)) != 0, -1, 1).astype(np.int16)
    q = (mag * sgn).reshape(nb, 256)
    assert np.abs(q).max() <= 127
    return UQTensor(q.reshape(rows, k).astype(np.int8),
                    code.reshape(rows, -1), None,
                    32, "int8", 0, GGMLType.IQ3_S, (rows, k), d=d, gsub=8)


def _conv_iq1_s(raw: np.ndarray, k: int) -> UQTensor:
    """IQ1_S: y = dl*(g + delta), dl = d*(2*sh+1). We store q = 8g + 8delta
    (integer, |q|<=9), grouped base d' = d*0.125 (exact power-of-two product)
    and code 2*sh+1, so the device's single f32 multiply d'*code reproduces
    the reference's rounding exactly."""
    grid = _codebook("iq1s_grid").view(np.uint8).reshape(2048, 8).view(np.int8).astype(np.int16)
    rows = raw.shape[0]
    b = _blocks(raw, 50)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(rows, -1)
    qs = b[:, 2:34].reshape(nb, 8, 4).astype(np.int32)
    qh = b[:, 34:50].copy().view(np.uint16).astype(np.int32)
    code = (2 * ((qh >> 12) & 7) + 1).astype(np.int8)  # <= 15
    delta8 = np.where((qh & 0x8000) != 0, -1, 1).astype(np.int16)  # 8*(+-0.125)
    l = np.arange(4)
    idx = qs | (((qh[:, :, None] >> (3 * l)) & 7) << 8)
    g = grid[idx]  # (nb,8,4,8)
    q = (8 * g + delta8[:, :, None, None]).reshape(nb, 256)
    assert np.abs(q).max() <= 127
    return UQTensor(q.reshape(rows, k).astype(np.int8),
                    code.reshape(rows, -1), None,
                    32, "int8", 0, GGMLType.IQ1_S, (rows, k),
                    d=d * np.float32(0.125), gsub=8)


def _conv_iq1_m(raw: np.ndarray, k: int) -> UQTensor:
    grid = _codebook("iq1s_grid").view(np.uint8).reshape(2048, 8).view(np.int8).astype(np.int16)
    rows = raw.shape[0]
    b = _blocks(raw, 56)
    nb = b.shape[0]
    qs = b[:, 0:32].reshape(nb, 8, 4).astype(np.int32)
    qh = b[:, 32:48].reshape(nb, 8, 2).astype(np.int32)
    sc = b[:, 48:56].copy().view(np.uint16).astype(np.uint32)
    scale_u16 = (
        (sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0) | ((sc[:, 2] >> 4) & 0x0F00) | (sc[:, 3] & 0xF000)
    ).astype(np.uint16)
    d = scale_u16.view(np.float16).astype(F32)[:, None]
    ib = np.arange(8)
    sc32 = sc.astype(np.int32)
    c1 = (2 * ((sc32[:, ib // 2] >> (6 * (ib % 2) + 0)) & 0x7) + 1).astype(np.int8)
    c2 = (2 * ((sc32[:, ib // 2] >> (6 * (ib % 2) + 3)) & 0x7) + 1).astype(np.int8)
    # per half-sub-block (16 elems) scale: [dl1, dl1, dl2, dl2] quarters of 8
    # -> sub must be 16: quarters 0,1 (elems 0..15) use dl1; 2,3 (16..31) dl2
    codes16 = np.stack([c1, c2], axis=2).reshape(nb, 16)
    idx = np.empty((nb, 8, 4), dtype=np.int32)
    idx[:, :, 0] = qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700)
    idx[:, :, 1] = qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700)
    idx[:, :, 2] = qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700)
    idx[:, :, 3] = qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700)
    delta8 = np.empty((nb, 8, 4), dtype=np.int16)
    delta8[:, :, 0] = np.where((qh[:, :, 0] & 0x08) != 0, -1, 1)
    delta8[:, :, 1] = np.where((qh[:, :, 0] & 0x80) != 0, -1, 1)
    delta8[:, :, 2] = np.where((qh[:, :, 1] & 0x08) != 0, -1, 1)
    delta8[:, :, 3] = np.where((qh[:, :, 1] & 0x80) != 0, -1, 1)
    g = grid[idx]
    q = (8 * g + delta8[:, :, :, None]).reshape(nb, 256)
    return UQTensor(q.reshape(rows, k).astype(np.int8),
                    codes16.reshape(rows, -1), None,
                    16, "int8", 0, GGMLType.IQ1_M, (rows, k),
                    d=(d * np.float32(0.125)).reshape(rows, -1), gsub=16)


_CONVERTERS = {
    GGMLType.Q4_0: _conv_q4_0,
    GGMLType.Q4_1: _conv_q4_1,
    GGMLType.Q5_0: _conv_q5_0,
    GGMLType.Q5_1: _conv_q5_1,
    GGMLType.Q8_0: _conv_q8_0,
    GGMLType.Q2_K: _conv_q2_k,
    GGMLType.Q3_K: _conv_q3_k,
    GGMLType.Q4_K: _conv_q4_k,
    GGMLType.Q5_K: _conv_q5_k,
    GGMLType.Q6_K: _conv_q6_k,
    GGMLType.IQ4_NL: _conv_iq4_nl,
    GGMLType.IQ4_XS: _conv_iq4_xs,
    GGMLType.IQ2_XXS: _conv_iq2_xxs,
    GGMLType.IQ2_XS: _conv_iq2_xs,
    GGMLType.IQ2_S: _conv_iq2_s,
    GGMLType.IQ3_XXS: _conv_iq3_xxs,
    GGMLType.IQ3_S: _conv_iq3_s,
    GGMLType.IQ1_S: _conv_iq1_s,
    GGMLType.IQ1_M: _conv_iq1_m,
}

SUPPORTED_TYPES = frozenset(_CONVERTERS)


def to_device_format(raw: np.ndarray, ggml_type: GGMLType, k: int) -> UQTensor:
    """Convert raw GGUF row-blocked bytes (rows, row_bytes) to UQTensor."""
    fn = _CONVERTERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"device format for {ggml_type.name}")
    if raw.ndim == 1:
        raw = raw.reshape(1, -1)
    return fn(np.ascontiguousarray(raw), k)


def uq_full_scales(uq: UQTensor) -> tuple[np.ndarray, np.ndarray | None]:
    """Effective per-sub-block f32 (scales, mins) — expands grouped codes
    with the same single f32 multiply the device performs."""
    if uq.gsub == 1:
        return uq.scales, uq.mins
    sc = np.repeat(uq.d, uq.gsub, axis=1) * uq.scales.astype(F32)
    mn = None
    if uq.mins is not None:
        mn = np.repeat(uq.dmin, uq.gsub, axis=1) * uq.mins.astype(F32)
    return sc, mn


def dequant_uq_np(uq: UQTensor) -> np.ndarray:
    """Host reference dequant of the uniform layout (for tests)."""
    if uq.layout == "nib4":
        q = unpack_nib4(uq.qs, uq.q_offset).astype(F32)
    else:
        q = uq.qs.astype(F32)
    rows, k = uq.shape
    sc, mn = uq_full_scales(uq)
    y = np.repeat(sc, uq.sub, axis=1) * q.reshape(rows, k)
    if mn is not None:
        y = y - np.repeat(mn, uq.sub, axis=1)
    return y
