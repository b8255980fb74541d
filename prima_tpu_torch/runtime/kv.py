"""KV-cache management: sequence ops over per-slot cache buffers.

Counterpart of prima_tpu/runtime/kv.py for per-layer caches. Each layer's
cache is a dense (n_slots, T, kvh, hd) tensor or a KVQ8 / KVQ4 of that
shape, with one sequence per slot row; the host keeps one write index per
slot (`cache_pos`). The JAX package rebuilds the buffers functionally;
here every op writes the slot's row in place.

K is cached after RoPE, so moving a cell by d positions re-rotates its K
by d (rope(p) -> rope(p + d) composes additively). A quantized K row is
materialized to bf16, rotated and requantized, as the JAX package does,
so the codes match it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import init_kv_caches
from ..ops.kvquant import is_quantized
from ..ops.layers import rope_freqs, rotate


def rope_delta(k: torch.Tensor, delta: torch.Tensor, inv_freq: torch.Tensor,
               rope_type: str) -> torch.Tensor:
    """Rotate cached K rows (T, kvh, hd) by per-row `delta` (T,) positions."""
    theta = delta[:, None].float() * inv_freq  # (T, half)
    return rotate(k.float(), torch.cos(theta)[:, None, :],
                  torch.sin(theta)[:, None, :], rope_type).to(k.dtype)


def materialize_row(cache, slot: int) -> torch.Tensor:
    """One slot's dense (T, H, D) values: a view of a dense cache, or a
    quantized cache dequantized to bf16."""
    if is_quantized(cache):
        return cache[slot].to(torch.bfloat16)
    return cache[slot]


def set_row(cache, slot: int, row: torch.Tensor) -> None:
    """Write one slot's dense row back, requantizing a quantized cache."""
    if is_quantized(cache):
        q, s = cache.quantize(row)
        cache.qs[slot].copy_(q)
        cache.scale[slot].copy_(s)
    else:
        cache[slot].copy_(row)


def _parts(cache) -> tuple:
    """The tensors a cache is made of (codes and scales, or itself)."""
    return (cache.qs, cache.scale) if is_quantized(cache) else (cache,)


@dataclass
class KVCache:
    """Per-slot KV cache plus host-side write indices."""

    cfg: ModelConfig
    n_slots: int
    max_seq: int
    dtype: object = torch.bfloat16  # a torch dtype, "q8_0" or "q4_0"
    device: torch.device | None = None
    caches: list = None  # per layer (k, v): (n_slots, T, kvh, hd)
    cache_pos: np.ndarray = None  # (n_slots,) next write index == seq length

    def __post_init__(self):
        if self.caches is None:
            self.caches = init_kv_caches(self.cfg, self.n_slots, self.max_seq,
                                         self.dtype, self.device)
        if self.cache_pos is None:
            self.cache_pos = np.zeros(self.n_slots, dtype=np.int32)
        self._inv_freq, _ = rope_freqs(self.cfg, self.device)

    def _index(self, a: np.ndarray, dtype=np.int64) -> torch.Tensor:
        return torch.from_numpy(a.astype(dtype)).to(self._inv_freq.device)

    def seq_rm(self, slot: int, p0: int = 0, p1: int = -1) -> None:
        """Remove [p0, p1) of a slot. Only the write index moves: the
        causal mask hides every cell at or past it; interior removal
        truncates to p0 (the caller re-decodes the rest)."""
        if p1 < 0 or p1 >= int(self.cache_pos[slot]):
            self.cache_pos[slot] = min(int(self.cache_pos[slot]), max(p0, 0))
        else:
            self.cache_pos[slot] = max(p0, 0)

    def seq_cp(self, dst: int, src: int) -> None:
        for k, v in self.caches:
            for a in _parts(k) + _parts(v):
                a[dst].copy_(a[src])
        self.cache_pos[dst] = self.cache_pos[src]

    def seq_keep(self, slot: int) -> None:
        keep = int(self.cache_pos[slot])
        self.cache_pos[:] = 0
        self.cache_pos[slot] = keep

    def remap(self, slot: int, src: np.ndarray, delta: np.ndarray,
              new_used: int) -> None:
        """Cell i of the slot takes cell src[i], with K re-rotated by
        delta[i] positions: the primitive under context shift. V (codes
        and scales of a quantized cache) moves as it is."""
        idx = self._index(np.minimum(src, self.max_seq - 1))
        d = self._index(delta, np.int32)
        for k, v in self.caches:
            set_row(k, slot, rope_delta(materialize_row(k, slot)[idx], d,
                                        self._inv_freq, self.cfg.rope_type))
            for a in _parts(v):
                a[slot].copy_(a[slot][idx])
        self.cache_pos[slot] = new_used

    def context_shift(self, slot: int, n_keep: int, n_discard: int) -> None:
        """Drop cells [n_keep, n_keep + n_discard), move the rest down and
        re-rotate their K by -n_discard (context shift)."""
        used = int(self.cache_pos[slot])
        if n_keep + n_discard > used:
            raise ValueError("context shift past the used cells")
        move = used - n_keep - n_discard
        idx = np.arange(self.max_seq, dtype=np.int32)
        src = np.where(idx < n_keep, idx, idx + n_discard)
        delta = np.where((idx >= n_keep) & (idx < n_keep + move), -n_discard, 0)
        self.remap(slot, src, delta, n_keep + move)

    def rope_shift(self, slot: int, delta: np.ndarray) -> None:
        """Re-rotate the K of every cell i by delta[i] without moving it
        (Self-Extend: logical positions compress, storage order stays)."""
        if not np.any(delta):
            return
        d = self._index(delta, np.int32)
        for k, _ in self.caches:
            set_row(k, slot, rope_delta(materialize_row(k, slot), d, self._inv_freq,
                                        self.cfg.rope_type))

    def seq_div(self, slot: int, p0: int, p1: int, divisor: int) -> None:
        """Divide the positions of cells [p0, p1) by `divisor` (Self-Extend
        grouped attention), re-rotating their K."""
        if divisor <= 1:
            return
        idx = np.arange(self.max_seq, dtype=np.int32)
        newpos = np.where((idx >= p0) & (idx < p1), idx // divisor, idx)
        self.rope_shift(slot, (newpos - idx).astype(np.int32))

    def used(self, slot: int) -> int:
        return int(self.cache_pos[slot])
