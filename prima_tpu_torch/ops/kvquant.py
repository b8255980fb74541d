"""Quantized KV-cache storage and cache updates (the -ctk q8_0 / q4_0
analogues). Counterpart of prima_tpu/ops/kvquant.py.

KVQ8 holds int8 codes, KVQ4 packed int4 pairs, each with one f32 scale per
(batch, cell, head) over the head_dim vector: 1 (or 0.5) byte an element
plus 4 / D of scale, against 2 for bf16. Both stand where a dense
(B, T, H, D) cache tensor goes; `to(dtype)` materializes dense values (the
JAX `astype`). The decoder writes a layer's K and V through
`update_kv_pair`, one fused `kv_store` launch that quantizes in the kernel;
`update_kv` writes one cache through the byte-generic `kv_write` kernel
(one quantize in plain PyTorch plus two writes for a quantized cache), in
place.
"""

from __future__ import annotations

import torch

from .kv_write import kv_store, kv_write, kv_write_plain


class KVQ8:
    """int8 codes qs (B, T, H, D) and f32 scales (B, T, H, 1)."""

    materialized = 0  # to() calls on any quantized cache: each is a dense copy

    def __init__(self, qs: torch.Tensor, scale: torch.Tensor):
        self.qs = qs
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.qs.shape)

    def __getitem__(self, idx):  # views: a slot row writes through
        return type(self)(self.qs[idx], self.scale[idx])

    @classmethod
    def zeros(cls, shape, device=None) -> "KVQ8":
        return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(tuple(shape[:-1]) + (1,), dtype=torch.float32,
                               device=device))

    def to(self, dtype) -> torch.Tensor:
        KVQ8.materialized += 1
        return (self.qs.float() * self.scale).to(dtype)

    @staticmethod
    def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return quantize_kv(x)


class KVQ4(KVQ8):
    """Packed int4: byte i of the last axis holds elements i (low nibble)
    and i + D/2 (high nibble), values in [-7, 7] offset by 8."""

    @property
    def shape(self):
        return tuple(self.qs.shape[:-1]) + (2 * self.qs.shape[-1],)

    @classmethod
    def zeros(cls, shape, device=None) -> "KVQ4":
        # 8 encodes 0, so zero-initialized cells dequantize to 0
        return cls(torch.full(tuple(shape[:-1]) + (shape[-1] // 2,), 0x88,
                              dtype=torch.uint8, device=device),
                   torch.zeros(tuple(shape[:-1]) + (1,), dtype=torch.float32,
                               device=device))

    def to(self, dtype) -> torch.Tensor:
        KVQ8.materialized += 1
        lo = (self.qs & 0x0F).to(torch.int32) - 8
        hi = (self.qs >> 4).to(torch.int32) - 8
        return (torch.cat([lo, hi], dim=-1).float() * self.scale).to(dtype)

    @staticmethod
    def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return quantize_kv4(x)


def _scale_inv(x: torch.Tensor, qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # true divisions of two tensors, as XLA's: on CUDA, PyTorch divides by
    # a Python scalar as a multiply by its reciprocal, which rounds
    # differently
    scale = amax / torch.full_like(amax, qmax)
    inv = torch.where(scale > 0, torch.ones_like(scale) / torch.clamp(scale, min=1e-30),
                      torch.zeros((), device=x.device))
    return torch.round(xf * inv), scale  # round half to even, as jnp.round


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> int8 codes + f32 scale over the last axis."""
    q, scale = _scale_inv(x, 127.0)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def quantize_kv4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> packed uint4 pairs + f32 scale over the last axis."""
    q, scale = _scale_inv(x, 7.0)
    q = torch.clamp(q, -7, 7).to(torch.int32) + 8
    half = x.shape[-1] // 2
    return (q[..., :half] | (q[..., half:] << 4)).to(torch.uint8), scale


def is_quantized(cache) -> bool:
    return isinstance(cache, KVQ8)  # KVQ4 is a KVQ8


def _update_kv(cache, new: torch.Tensor, cache_pos: torch.Tensor, write):
    if is_quantized(cache):
        q, s = cache.quantize(new)
        write(cache.qs, q.contiguous(), cache_pos)
        write(cache.scale, s.contiguous(), cache_pos)
        return cache
    return write(cache, new.to(cache.dtype).contiguous(), cache_pos)


def update_kv(cache, new: torch.Tensor, cache_pos: torch.Tensor):
    """Write `new` (B, S, H, D) at per-row positions `cache_pos` (B,) int32
    into a dense, KVQ8 or KVQ4 cache, in place; returns the cache."""
    return _update_kv(cache, new, cache_pos, kv_write)


def update_kv_plain(cache, new: torch.Tensor, cache_pos: torch.Tensor):
    """`update_kv` in plain PyTorch on any device (no kernel)."""
    return _update_kv(cache, new, cache_pos, kv_write_plain)


def update_kv_pair(k_cache, v_cache, k_new: torch.Tensor, v_new: torch.Tensor,
                   cache_pos: torch.Tensor):
    """One layer's K and V rows into both caches, in place, through one
    `kv_store` launch (two `update_kv` calls in the JAX package); returns
    the caches."""
    return kv_store(k_cache, v_cache, k_new, v_new, cache_pos)


def kv_seq_len(cache) -> int:
    return cache.shape[1]
