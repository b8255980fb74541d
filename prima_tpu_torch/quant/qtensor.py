"""Quantized weight tensors on a PyTorch device, in natural column order.

Counterpart of prima_tpu/quant/dequant_jax.py (`qtensor_from_raw` is its
native load path). The JAX package permutes weight columns (sigma order,
`kperm`) so its TPU kernel sees 128-lane tiles; the Hopper GEMV reads a row
as 16-byte chunks in natural order, so the port never permutes.

Layouts (same meaning as the host UQTensor, quant/device_format.py):

  qs      nib4: uint8 (N, K/2), byte i holds col i (low nibble) and col
          i + K/2 (high nibble); int8: int8 (N, K)
  scales  flat (gsub == 1): f32 (N, S) per-sub-block scales
          grouped: int8 codes (N, S) times f32 bases d (N, S // gsub)
          packed (grouped formats with mins, S % 16 == 0):
            scales uint8 (N, S)   = sc_code | (mn_code >> 4) << 6
            mins   uint8 (N, S/2) = mn_lo4[s] | mn_lo4[s + S/2] << 4
            d      int32 (N, G)   = f16_bits(dmin) << 16 | f16_bits(d)
  mins    same representation as scales, or None

Effective weight: y[n, c] = sc[n, s] * (q[n, c] + q_offset) - mn[n, s],
s = c // sub, with sc = d[s // gsub] * code[s] taken as ONE f32 multiply
(the reference's rounding, ggml-quants.c `d * sc`).

Bits per weight: Q4_K packed 4.5, Q4_K grouped 4.75, Q4_0 5, Q5_K packed
8.5, Q6_K 8.625, Q8_0 9.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..native import native_convert
from .device_format import UQTensor


@dataclass
class QTensor:
    qs: torch.Tensor
    scales: torch.Tensor
    mins: torch.Tensor | None
    sub: int
    layout: str
    q_offset: int
    shape: tuple[int, int]
    d: torch.Tensor | None = None
    dmin: torch.Tensor | None = None
    gsub: int = 1
    packed: bool = False

    @classmethod
    def from_host(cls, uq: UQTensor, device) -> "QTensor":
        scales, mins, d, dmin, packed = pack_scales_np(
            uq.scales, uq.mins, uq.d, uq.dmin, uq.gsub)
        put = lambda a: None if a is None else torch.from_numpy(
            np.array(a, order="C")).to(device)  # a writable host copy
        return cls(qs=put(uq.qs), scales=put(scales), mins=put(mins),
                   sub=uq.sub, layout=uq.layout, q_offset=uq.q_offset,
                   shape=tuple(uq.shape), d=put(d), dmin=put(dmin),
                   gsub=uq.gsub, packed=packed)

    @property
    def n_rows(self) -> int:
        return self.qs.shape[0]

    @property
    def n_cols(self) -> int:
        return self.sub * self.scales.shape[-1]

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.qs, self.scales, self.mins, self.d, self.dmin)
                   if a is not None)

    def tensors(self) -> tuple:
        return (self.qs, self.scales, self.mins, self.d, self.dmin)

    def rows(self, r0: int, r1: int) -> "QTensor":
        """Rows [r0, r1) as a QTensor of views (one expert of stacked
        experts)."""
        sl = lambda a: None if a is None else a[r0:r1]
        return QTensor(sl(self.qs), sl(self.scales), sl(self.mins), self.sub, self.layout,
                       self.q_offset, (r1 - r0, self.shape[1]), d=sl(self.d),
                       dmin=sl(self.dmin), gsub=self.gsub, packed=self.packed)


_NATIVE_META = {
    # ggml_type -> (sub, layout, q_offset, gsub)
    12: (32, "nib4", 0, 8),    # Q4_K (grouped superblock codes)
    2: (32, "nib4", -8, 1),    # Q4_0
    14: (16, "int8", 0, 16),   # Q6_K (grouped superblock codes)
    8: (32, "int8", 0, 1),     # Q8_0
}


def qtensor_from_raw(raw: np.ndarray, ggml_type, shape: tuple[int, int],
                     device) -> QTensor | None:
    """GGUF blocks -> QTensor on `device` through the native (C++)
    converter, the fields QTensor.from_host(to_device_format(...)) gives,
    bit for bit. None when the type has no native converter or the library
    is off (the caller takes the numpy route)."""
    meta = _NATIVE_META.get(int(ggml_type))
    if meta is None:
        return None
    sub, layout, q_offset, gsub = meta
    rows, k = shape
    packed = int(ggml_type) == 12 and (k // sub) % 16 == 0  # pack_scales_np's rule
    res = native_convert(raw, ggml_type, k, packed)
    if res is None:
        return None
    qs, scales, mins, d, dmin = (None if a is None else torch.from_numpy(a).to(device)
                                 for a in res)
    return QTensor(qs=qs, scales=scales, mins=mins, sub=sub, layout=layout,
                   q_offset=q_offset, shape=(rows, k), d=d, dmin=dmin, gsub=gsub,
                   packed=packed)


def pack_scales_np(scales, mins, d, dmin, gsub: int):
    """Grouped formats with mins pack to the native footprint (Q4_K 4.5
    bits/weight) when S % 16 == 0 — the same rule as the JAX package's
    host_pack, but in natural sub-block order. Returns
    (scales, mins, d, dmin, packed)."""
    packed = (gsub > 1 and mins is not None and dmin is not None
              and scales.dtype == np.int8 and scales.shape[-1] % 16 == 0)
    if not packed:
        return scales, mins, d, dmin, False
    sc = scales.astype(np.uint8)
    mn = mins.astype(np.uint8)
    s_half = sc.shape[-1] // 2
    a1 = (sc | ((mn >> 4) << 6)).astype(np.uint8)
    a2 = ((mn[:, :s_half] & 0x0F) | ((mn[:, s_half:] & 0x0F) << 4)).astype(np.uint8)
    d16 = d.astype(np.float16).view(np.uint16).astype(np.uint32)
    dm16 = dmin.astype(np.float16).view(np.uint16).astype(np.uint32)
    pair = ((dm16 << 16) | d16).view(np.int32)
    return a1, a2, pair, None, True


def f16_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """Exact f16 bit pattern (int32 in [0, 65536)) -> f32."""
    signed = bits - ((bits & 0x8000) << 1)  # two's-complement 16-bit value
    return signed.to(torch.int16).view(torch.float16).float()


def eff_scales(qt: QTensor, scales, mins, d, dmin):
    """Per-sub-block effective f32 (scales, mins), natural order. The
    d*code product is one f32 multiply (dequant_jax._eff_scales)."""
    if qt.gsub == 1:
        return scales, mins
    if qt.packed:
        a1 = scales.to(torch.int32)
        a2 = mins.to(torch.int32)
        sc_code = (a1 & 63).float()
        mn_code = (((a1 >> 6) << 4)
                   | torch.cat([a2 & 15, a2 >> 4], dim=-1)).float()
        du = d.to(torch.int32)
        scales, mins = sc_code, mn_code
        d = f16_bits_to_f32(du & 0xFFFF)
        dmin = f16_bits_to_f32((du >> 16) & 0xFFFF)
    g = qt.gsub
    sc = d.repeat_interleave(g, dim=-1) * scales.float()
    mn = dmin.repeat_interleave(g, dim=-1) * mins.float() if mins is not None else None
    return sc, mn


def unpack_q(qt: QTensor, qs: torch.Tensor) -> torch.Tensor:
    """Stored quants -> integer values (with q_offset) as f32."""
    if qt.layout == "nib4":
        lo = (qs & 0x0F).to(torch.int32)
        hi = (qs >> 4).to(torch.int32)
        return (torch.cat([lo, hi], dim=-1) + qt.q_offset).float()
    return qs.float()


def _dequant_any(qt: QTensor, qs, scales, mins, d, dmin, dtype) -> torch.Tensor:
    sc, mn = eff_scales(qt, scales, mins, d, dmin)
    y = sc.repeat_interleave(qt.sub, dim=-1) * unpack_q(qt, qs)
    if mn is not None:
        y = y - mn.repeat_interleave(qt.sub, dim=-1)
    return y.to(dtype)


_slices = threading.local()


@contextlib.contextmanager
def dequant_slices(weights: int):
    """Inside the block, `dequant` on this thread works through slices of
    rows of about `weights` weights each, so its f32 temporaries stay a
    slice's size; the bits are those of one pass. A device that streams
    its layers sets it around their forward to bound its memory; every
    other caller keeps one pass."""
    prev = getattr(_slices, "weights", None)
    _slices.weights = weights
    try:
        yield
    finally:
        _slices.weights = prev


def dequant(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """The full weight matrix (N, K) in `dtype`: one pass, or by slices of
    rows inside `dequant_slices` (every op is elementwise along a row)."""
    budget = getattr(_slices, "weights", None)
    rows = qt.n_rows if budget is None else max(1, budget // max(qt.n_cols, 1))
    if qt.n_rows <= rows:
        return _dequant_any(qt, qt.qs, qt.scales, qt.mins, qt.d, qt.dmin, dtype)
    out = torch.empty((qt.n_rows, qt.n_cols), dtype=dtype, device=qt.qs.device)
    for r0 in range(0, qt.n_rows, rows):
        part = qt.rows(r0, min(r0 + rows, qt.n_rows))
        out[r0:r0 + part.n_rows] = _dequant_any(part, *part.tensors(), dtype)
    return out


def dequant_rows(qt: QTensor, row_ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Gather rows then dequantize (embedding lookup): (..., K)."""
    take = lambda a: None if a is None else a[row_ids]
    return _dequant_any(qt, take(qt.qs), take(qt.scales), take(qt.mins),
                        take(qt.d), take(qt.dmin), dtype)


def qmatmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., K) @ dequant(W)(N, K)^T -> (..., N) in x's dtype, accumulated
    in f32 (the counterpart of dequant_jax.qmatmul_xla: half types
    accumulate in f32 inside torch.matmul on either device)."""
    return torch.matmul(x, dequant(qt, x.dtype).t())
