"""State save/load: session files and per-slot KV serialization.

Counterpart of prima_tpu/runtime/state.py for the per-layer cache (the
port's only layout). A slot's KV rows trimmed to its used length, as f32,
its token history and the model-shape metadata go into one .npz. The
format, STATE_MAGIC and STATE_VERSION are the JAX package's, so a file
saved by either package restores in the other; a model with per-layer KV
heads also records them (`n_kv_heads_arr`, which the JAX package does not
read), and each layer's rows keep that layer's head count. Quantized caches are saved
as their dense values and requantized on restore, as there.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops.kvquant import update_kv
from .kv import materialize_row

STATE_MAGIC = "prima-tpu-state"
STATE_VERSION = 1


def _meta(engine, n_tokens: int) -> dict:
    cfg = engine.cfg
    return {
        "magic": STATE_MAGIC,
        "version": STATE_VERSION,
        "arch": cfg.arch,
        "n_layers": cfg.n_layers,
        "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "n_tokens": n_tokens,
        # per-layer KV heads (openelm); n_kv_heads is then their largest
        **({"n_kv_heads_arr": list(cfg.n_kv_heads_arr)} if cfg.n_kv_heads_arr else {}),
    }


def slot_save(engine, slot_id: int, path: str) -> int:
    """Save one slot's sequence state; returns the tokens saved."""
    used = engine.kv.used(slot_id)
    slot = engine.slots[slot_id]
    tokens = list(slot.prompt + slot.generated)
    for n_keep, n_discard in slot.shifts:
        # replay context shifts: the cache dropped these middle spans
        tokens = tokens[:n_keep] + tokens[n_keep + n_discard:]
    tokens = tokens[: used + 1]
    arrays = {}
    for li, (k, v) in enumerate(engine.kv.caches):
        arrays[f"k{li}"] = materialize_row(k, slot_id)[:used].float().cpu().numpy()
        arrays[f"v{li}"] = materialize_row(v, slot_id)[:used].float().cpu().numpy()
    with open(path, "wb") as f:  # the exact path (np.savez would append .npz)
        np.savez_compressed(f, meta=json.dumps(_meta(engine, used)),
                            tokens=np.asarray(tokens, dtype=np.int32), **arrays)
    return used


def slot_restore(engine, slot_id: int, path: str) -> int:
    """Restore a saved sequence into a slot; returns the tokens restored."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("magic") != STATE_MAGIC:
            raise ValueError(f"{path}: not a prima-tpu state file")
        for key in ("arch", "n_layers", "n_kv_heads", "head_dim"):
            want = getattr(engine.cfg, key)
            if meta.get(key) != want:
                raise ValueError(f"{path}: state {key}={meta.get(key)} != model {want}")
        want = list(engine.cfg.n_kv_heads_arr)
        if want and meta.get("n_kv_heads_arr", want) != want:
            raise ValueError(f"{path}: state n_kv_heads_arr={meta['n_kv_heads_arr']} "
                             f"!= model {want}")
        used = int(meta["n_tokens"])
        if used > engine.max_seq:
            raise ValueError(f"{path}: state length {used} > max_seq {engine.max_seq}")
        tokens = [int(t) for t in z["tokens"]]
        # the saved cells go into the slot's row at cell 0 through the KV
        # write kernel (requantized for a quantized cache); cells past them
        # stay as they are, hidden by the write index
        start = torch.zeros(1, dtype=torch.int32, device=engine.device)
        for li, (k, v) in enumerate(engine.kv.caches):
            for cache, name in ((k, f"k{li}"), (v, f"v{li}")):
                if used:
                    cells = torch.from_numpy(np.asarray(z[name], np.float32))
                    update_kv(cache[slot_id:slot_id + 1], cells[None].to(engine.device), start)
    engine.kv.cache_pos[slot_id] = used
    slot = engine.slots[slot_id]
    slot.prompt = tokens
    slot.generated = []
    slot.n_prompt_done = min(used, max(len(tokens) - 1, 0))
    return used


def session_save(engine, slot_id: int, path: str) -> int:
    """CLI session file (--prompt-cache, main.cpp:268-288)."""
    return slot_save(engine, slot_id, path)


def session_load(engine, slot_id: int, path: str) -> list[int]:
    """Returns the cached token list (the CLI matches it against the new
    prompt and reuses the longest common prefix)."""
    slot_restore(engine, slot_id, path)
    return list(engine.slots[slot_id].prompt)
