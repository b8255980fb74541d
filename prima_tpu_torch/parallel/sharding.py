"""Sharding of quantized tensors by output rows or input columns.

Counterpart of prima_tpu/parallel/sharding.py. Host UQTensors (the GGUF
blocks in natural column order) split at load time, byte for byte as in
the JAX package (`shard_uq_rows`, `shard_uq_cols`); each shard is a whole
UQTensor, so the GEMV kernel runs on it unchanged. The JAX package then
stacks the shards over a device axis and places them with a NamedSharding
(`put_stacked_*`); here every rank uploads its own shard to its own device
(`put_shard`). Weights made on the card (the seeded full-width layers of
pipeline.synth_layer_seeded) split there, as QTensors, with the same result
as splitting them on the host (`shard_qtensor_rows`, `shard_qtensor_cols`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..quant.device_format import UQTensor, _pack_nib4, unpack_nib4
from ..quant.qtensor import QTensor


def shard_uq_rows(uq: UQTensor, n: int) -> list[UQTensor]:
    """Split along output rows (row-parallel linear: y features sharded)."""
    rows, k = uq.shape
    assert rows % n == 0, f"rows {rows} not divisible by {n}"
    r = rows // n
    out = []
    for i in range(n):
        sl = slice(i * r, (i + 1) * r)
        out.append(UQTensor(
            qs=uq.qs[sl], scales=uq.scales[sl],
            mins=uq.mins[sl] if uq.mins is not None else None, sub=uq.sub,
            layout=uq.layout, q_offset=uq.q_offset, ggml_type=uq.ggml_type, shape=(r, k),
            d=uq.d[sl] if uq.d is not None else None,
            dmin=uq.dmin[sl] if uq.dmin is not None else None, gsub=uq.gsub))
    return out


def shard_uq_cols(uq: UQTensor, n: int) -> list[UQTensor]:
    """Split along input columns (column-parallel linear: summed after),
    at super-block boundaries. nib4 shards are unpacked to raw nibbles,
    column-sliced and re-packed, so every shard is a valid nib4 tensor."""
    rows, k = uq.shape
    kc = k // n
    assert k % n == 0 and kc % (uq.sub * uq.gsub) == 0, (
        f"K {k} not shardable by {n} (sub={uq.sub}, gsub={uq.gsub})")
    sc = kc // uq.sub
    gc = sc // uq.gsub
    if uq.layout == "nib4":
        raw = unpack_nib4(uq.qs, 0).astype(np.uint8)  # (rows, k) natural order
    out = []
    for i in range(n):
        cols = slice(i * kc, (i + 1) * kc)
        if uq.layout == "nib4":
            qs = _pack_nib4(np.ascontiguousarray(raw[:, cols]))
        else:
            qs = np.ascontiguousarray(uq.qs[:, cols])

        def _cut(a, w):
            return (np.ascontiguousarray(a[:, i * w: (i + 1) * w])
                    if a is not None else None)

        out.append(UQTensor(
            qs=qs, scales=_cut(uq.scales, sc), mins=_cut(uq.mins, sc), sub=uq.sub,
            layout=uq.layout, q_offset=uq.q_offset, ggml_type=uq.ggml_type,
            shape=(rows, kc), d=_cut(uq.d, gc), dmin=_cut(uq.dmin, gc), gsub=uq.gsub))
    return out


def put_shard(t, device):
    """This rank's shard on its device: a UQTensor becomes a QTensor, an
    array a f32 tensor, a QTensor or tensor moves there."""
    if t is None:
        return None
    if isinstance(t, UQTensor):
        return QTensor.from_host(t, device)
    if isinstance(t, QTensor):
        return dataclasses.replace(t, **{f: None if getattr(t, f) is None
                                         else getattr(t, f).to(device)
                                         for f in ("qs", "scales", "mins", "d", "dmin")})
    if isinstance(t, torch.Tensor):
        return t.to(device)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(t, np.float32))).to(device)


# ---------------------------------------------------------------------------
# QTensors already on a device
# ---------------------------------------------------------------------------


def shard_qtensor_rows(qt: QTensor, n: int, i: int) -> QTensor:
    """Rows shard i of n, as fresh contiguous tensors."""
    r = qt.n_rows // n
    assert qt.n_rows % n == 0, f"rows {qt.n_rows} not divisible by {n}"
    part = qt.rows(i * r, (i + 1) * r)
    cp = lambda a: None if a is None else a.contiguous().clone()
    return QTensor(cp(part.qs), cp(part.scales), cp(part.mins), qt.sub, qt.layout,
                   qt.q_offset, (r, qt.shape[1]), d=cp(part.d), dmin=cp(part.dmin),
                   gsub=qt.gsub, packed=qt.packed)


def _unpack_scales(qt: QTensor):
    """(codes or f32 scales, mins, d, dmin) in the unpacked representation
    of a host UQTensor."""
    if not qt.packed:
        return qt.scales, qt.mins, qt.d, qt.dmin
    a1, a2 = qt.scales.to(torch.int32), qt.mins.to(torch.int32)
    sc = (a1 & 63).to(torch.int8)
    mn = (((a1 >> 6) << 4) | torch.cat([a2 & 15, a2 >> 4], dim=-1)).to(torch.int8)
    du = qt.d.to(torch.int32)
    f16 = lambda b: (b - ((b & 0x8000) << 1)).to(torch.int16).view(torch.float16).float()
    return sc, mn, f16(du & 0xFFFF), f16((du >> 16) & 0xFFFF)


def _pack_scales(scales, mins, d, dmin, gsub: int):
    """`qtensor.pack_scales_np` on device tensors."""
    if not (gsub > 1 and mins is not None and dmin is not None
            and scales.dtype == torch.int8 and scales.shape[-1] % 16 == 0):
        return scales, mins, d, dmin, False
    sc, mn = scales.to(torch.int32) & 0xFF, mins.to(torch.int32) & 0xFF
    half = sc.shape[-1] // 2
    a1 = (sc | ((mn >> 4) << 6)).to(torch.uint8)
    a2 = ((mn[:, :half] & 15) | ((mn[:, half:] & 15) << 4)).to(torch.uint8)
    bits = lambda v: v.half().view(torch.int16).to(torch.int32) & 0xFFFF
    return a1, a2, ((bits(dmin) << 16) | bits(d)).contiguous(), None, True


def shard_qtensor_cols(qt: QTensor, n: int, i: int) -> QTensor:
    """Input-column shard i of n at super-block boundaries, as
    `shard_uq_cols` would cut the same tensor on the host."""
    rows, k = qt.shape
    kc = k // n
    assert k % n == 0 and kc % (qt.sub * qt.gsub) == 0, (
        f"K {k} not shardable by {n} (sub={qt.sub}, gsub={qt.gsub})")
    sc_n, gc = kc // qt.sub, kc // qt.sub // qt.gsub
    if qt.layout == "nib4":
        raw = torch.cat([qt.qs & 0x0F, qt.qs >> 4], dim=-1)[:, i * kc:(i + 1) * kc]
        qs = (raw[:, :kc // 2] | (raw[:, kc // 2:] << 4)).contiguous()
    else:
        qs = qt.qs[:, i * kc:(i + 1) * kc].contiguous()
    scales, mins, d, dmin = _unpack_scales(qt)
    cut = lambda a, w: None if a is None else a[:, i * w:(i + 1) * w].contiguous()
    scales, mins, d, dmin, packed = _pack_scales(cut(scales, sc_n), cut(mins, sc_n),
                                                 cut(d, gc), cut(dmin, gc), qt.gsub)
    return QTensor(qs, scales, mins, qt.sub, qt.layout, qt.q_offset, (rows, kc), d=d,
                   dmin=dmin, gsub=qt.gsub, packed=packed)
