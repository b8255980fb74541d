"""KV-cache updates (counterpart of prima_tpu/ops/kvquant.py).

This slice ports the dense caches only. The int8 / int4 caches (KVQ8 /
KVQ4, `-ctk q8_0 / q4_0`) and their fused quantize-and-write come later.
"""

from __future__ import annotations

import torch

from .kv_write import kv_write


def update_kv(cache: torch.Tensor, new: torch.Tensor,
              cache_pos: torch.Tensor) -> torch.Tensor:
    """Write `new` (B, S, H, D) at per-row positions `cache_pos` (B,) int32
    into the dense cache (B, T, H, D), in place; returns the cache."""
    if not isinstance(cache, torch.Tensor):
        raise NotImplementedError("quantized KV caches are not ported yet")
    return kv_write(cache, new.to(cache.dtype).contiguous(), cache_pos)
