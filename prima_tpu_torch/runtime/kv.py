"""KV-cache management: sequence ops over dense per-slot cache buffers.

Counterpart of prima_tpu/runtime/kv.py for dense caches. Each layer's
cache is a (n_slots, T, kvh, hd) tensor with one sequence per slot row;
the host keeps one write index per slot (`cache_pos`). The JAX package
rebuilds the buffers functionally; here every op writes the slot's row in
place.

K is cached after RoPE, so moving a cell by d positions re-rotates its K
by d (rope(p) -> rope(p + d) composes additively).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import init_kv_caches
from ..ops.layers import rope_freqs, rotate


def rope_delta(k: torch.Tensor, delta: torch.Tensor, inv_freq: torch.Tensor,
               rope_type: str) -> torch.Tensor:
    """Rotate cached K rows (T, kvh, hd) by per-row `delta` (T,) positions."""
    theta = delta[:, None].float() * inv_freq  # (T, half)
    return rotate(k.float(), torch.cos(theta)[:, None, :],
                  torch.sin(theta)[:, None, :], rope_type).to(k.dtype)


@dataclass
class KVCache:
    """Per-slot dense KV cache plus host-side write indices."""

    cfg: ModelConfig
    n_slots: int
    max_seq: int
    dtype: torch.dtype = torch.bfloat16
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
            k[dst].copy_(k[src])
            v[dst].copy_(v[src])
        self.cache_pos[dst] = self.cache_pos[src]

    def seq_keep(self, slot: int) -> None:
        keep = int(self.cache_pos[slot])
        self.cache_pos[:] = 0
        self.cache_pos[slot] = keep

    def remap(self, slot: int, src: np.ndarray, delta: np.ndarray,
              new_used: int) -> None:
        """Cell i of the slot takes cell src[i], with K re-rotated by
        delta[i] positions: the primitive under context shift."""
        idx = torch.from_numpy(np.minimum(src, self.max_seq - 1).astype(np.int64)
                               ).to(self.caches[0][0].device)
        d = torch.from_numpy(delta.astype(np.int32)).to(idx.device)
        for k, v in self.caches:
            k[slot].copy_(rope_delta(k[slot][idx], d, self._inv_freq,
                                     self.cfg.rope_type))
            v[slot].copy_(v[slot][idx])
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
        """Re-rotate the K of every cell i by delta[i] without moving it."""
        if not np.any(delta):
            return
        d = torch.from_numpy(delta.astype(np.int32)).to(self.caches[0][0].device)
        for k, _ in self.caches:
            k[slot].copy_(rope_delta(k[slot], d, self._inv_freq, self.cfg.rope_type))

    def used(self, slot: int) -> int:
        return int(self.cache_pos[slot])
