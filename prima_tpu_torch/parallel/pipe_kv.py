"""Sequence ops over the piped-ring pipeline's KV cache.

Counterpart of prima_tpu/parallel/pipe_kv.py. There the cache is one
logical array sharded over (pp, dp, sp, tp) and a mutation is one sharded
program. Here every rank holds the cache of its own windows, KV heads,
batch rows and cells (pipeline.init_pipe_kv), and a mutation runs on every
rank at once: rank 0's PipeKV sends the call to the others through `bcast`
(the engine's control plane, the analogue of the reference's
llama_send_kv_cache_* signals, src/llama.cpp:22610-22745), then applies
it to its own part. A rank whose dp replica does not hold the slot's row
leaves its caches alone.

Slot (m, b) is row m * B + b of the flat cache_pos, which rank 0 keeps
(passes carry it to the other ranks). Truncation (seq_rm, clear,
seq_keep) only moves it. remap (context shift, seq_add), seq_cp and
rope_shift (Self-Extend, seq_div) touch the caches; under sequence
parallelism a remap gathers the slot's row over the sp lane, because a
cell may take a cell of another rank's block. materialize_slot gathers a
slot to rank 0 in layer order and restore_slot scatters it from there, so
slot files have the single-device engine's format.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.config import ModelConfig
from ..ops.kvquant import update_kv
from ..ops.layers import rope_freqs
from ..runtime.kv import _parts, materialize_row, rope_delta, set_row
from .mesh import Mesh
from .pipeline import PipeSpec, init_pipe_kv
from .tp import tp_local_config


class PipeKV:
    """KVCache-compatible view of one rank's pipe caches."""

    def __init__(self, cfg: ModelConfig, spec: PipeSpec, mesh: Mesh, batch_per_micro: int,
                 max_seq: int, dtype=torch.bfloat16):
        self.cfg, self.spec, self.mesh = cfg, spec, mesh
        self.batch_per_micro = batch_per_micro
        self.max_seq = max_seq
        self.dtype = dtype
        self.caches = init_pipe_kv(cfg, spec, mesh, batch_per_micro, max_seq, dtype)
        self.cache_pos = np.zeros(self.n_slots, dtype=np.int32)
        self.bcast = None  # rank 0: sends a mutation to the other ranks
        self.t_loc = max_seq // spec.n_sp
        self.offset = mesh.coords["sp"] * self.t_loc
        self.b_loc = batch_per_micro // spec.n_dp
        self._inv_freq, _ = rope_freqs(cfg, mesh.device)
        self._cfg_local = tp_local_config(cfg, spec.n_tp)

    # -- identity ------------------------------------------------------------------

    @property
    def n_slots(self) -> int:
        return self.spec.microbatches * self.batch_per_micro

    def _row(self, slot) -> int:
        if isinstance(slot, tuple):
            return slot[0] * self.batch_per_micro + slot[1]
        return int(slot)

    def _local(self, slot) -> int | None:
        """The slot's row in this rank's caches, None when another dp
        replica holds it."""
        m, b = divmod(self._row(slot), self.batch_per_micro)
        if b // self.b_loc != self.mesh.coords["dp"]:
            return None
        return m * self.b_loc + b % self.b_loc

    def _owned(self) -> list:
        return [kv for kv in self.caches if kv is not None]

    def used(self, slot) -> int:
        return int(self.cache_pos[self._row(slot)])

    def _send(self, name: str, *args) -> None:
        if self.bcast is not None:
            self.bcast(name, args)

    # -- metadata-only mutations ---------------------------------------------------

    def clear(self) -> None:
        self.cache_pos[:] = 0

    def seq_rm(self, slot, p0: int = 0, p1: int = -1) -> None:
        r = self._row(slot)
        if p1 < 0 or p1 >= int(self.cache_pos[r]):
            self.cache_pos[r] = min(int(self.cache_pos[r]), max(p0, 0))
        else:
            self.cache_pos[r] = max(p0, 0)

    def seq_keep(self, slot) -> None:
        r = self._row(slot)
        keep = int(self.cache_pos[r])
        self.cache_pos[:] = 0
        self.cache_pos[r] = keep

    # -- cache mutations (every rank) --------------------------------------------

    def seq_cp(self, dst, src) -> None:
        self._send("seq_cp", dst, src)
        ld, ls = self._local(dst), self._local(src)
        if (ld is None) != (ls is None):
            raise ValueError("seq_cp across dp replicas")
        if ld is not None:
            for k, v in self._owned():
                for a in _parts(k) + _parts(v):
                    a[ld].copy_(a[ls])
        self.cache_pos[self._row(dst)] = self.cache_pos[self._row(src)]

    def _gather_cells(self, part: torch.Tensor) -> torch.Tensor:
        """A slot row's (T_loc, ...) block joined over the sp lane into
        (T, ...): each rank adds its block into zeros (exact)."""
        wide = torch.int32 if not part.is_floating_point() else torch.float32
        full = torch.zeros((self.max_seq,) + tuple(part.shape[1:]), dtype=wide,
                           device=part.device)
        full[self.offset:self.offset + self.t_loc] = part.to(wide)
        return self.mesh.axis("sp").all_reduce(full).to(part.dtype)

    def remap(self, slot, src: np.ndarray, delta: np.ndarray, new_used: int) -> None:
        """Cell i of the slot takes cell src[i], its K re-rotated by
        delta[i] (runtime/kv.KVCache.remap over the whole row)."""
        self._send("remap", slot, src, delta, new_used)
        row = self._local(slot)
        if row is not None:
            dev = self._inv_freq.device
            idx = torch.from_numpy(np.minimum(src, self.max_seq - 1).astype(np.int64)).to(dev)
            d = torch.from_numpy(np.asarray(delta, np.int32)).to(dev)
            mine = slice(self.offset, self.offset + self.t_loc)
            for k, v in self._owned():
                kfull = self._gather_cells(materialize_row(k, row))
                set_row(k, row, rope_delta(kfull[idx], d, self._inv_freq,
                                           self.cfg.rope_type)[mine])
                for a in _parts(v):
                    a[row].copy_(self._gather_cells(a[row])[idx][mine])
        self.cache_pos[self._row(slot)] = new_used

    def rope_shift(self, slot, delta: np.ndarray) -> None:
        """Re-rotate the K of every cell i by delta[i] in place."""
        if not np.any(delta):
            return
        self._send("rope_shift", slot, delta)
        row = self._local(slot)
        if row is None:
            return
        d = torch.from_numpy(np.asarray(delta, np.int32)[self.offset:self.offset + self.t_loc]
                             ).to(self._inv_freq.device)
        for k, _ in self._owned():
            set_row(k, row, rope_delta(materialize_row(k, row), d, self._inv_freq,
                                       self.cfg.rope_type))

    # -- compositions on rank 0 (they send remap / rope_shift) -------------------

    def context_shift(self, slot, n_keep: int, n_discard: int) -> None:
        used = self.used(slot)
        assert n_keep + n_discard <= used
        move = used - n_keep - n_discard
        idx = np.arange(self.max_seq, dtype=np.int32)
        src = np.where(idx < n_keep, idx, idx + n_discard)
        delta = np.where((idx >= n_keep) & (idx < n_keep + move), -n_discard, 0)
        self.remap(slot, src, delta, n_keep + move)

    def seq_add(self, slot, p0: int, p1: int, delta: int, move: bool = True) -> None:
        if delta == 0:
            return
        used = self.used(slot)
        p1 = min(p1, used)
        idx = np.arange(self.max_seq, dtype=np.int32)
        if move:
            inrange = (idx >= p0 + delta) & (idx < p1 + delta)
            src = np.where(inrange, idx - delta, idx)
            d = np.where(inrange, delta, 0)
            self.remap(slot, src, d, max(used + (delta if p1 == used else 0), 0))
        else:
            d = np.where((idx >= p0) & (idx < p1), delta, 0)
            self.remap(slot, idx, d, used)

    def seq_div(self, slot, p0: int, p1: int, divisor: int) -> None:
        if divisor <= 1:
            return
        idx = np.arange(self.max_seq, dtype=np.int32)
        inrange = (idx >= p0) & (idx < p1)
        newpos = np.where(inrange, idx // divisor, idx)
        self.rope_shift(slot, (newpos - idx).astype(np.int32))

    # -- slot files (runtime/state.py) -------------------------------------------

    def _layer_heads(self) -> slice:
        kvh = self._cfg_local.n_kv_heads
        t = self.mesh.coords["tp"]
        return slice(t * kvh, (t + 1) * kvh)

    def materialize_slot(self, slot, used: int):
        """Dense (L, used, kvh, hd) f32 K and V of one slot, in layer order,
        on rank 0 (None elsewhere)."""
        self._send("materialize_slot", slot, used)
        row = self._local(slot)
        lo, hi = self.offset, min(self.offset + self.t_loc, used)
        mine = []
        if row is not None and hi > lo:
            for li, kv in enumerate(self.caches):
                if kv is None:
                    continue
                k, v = (materialize_row(c, row)[:hi - lo].float().cpu().numpy() for c in kv)
                mine.append((li, lo, self._layer_heads(), k, v))
        parts = self.mesh.gather_obj0(mine)
        if parts is None:
            return None
        cfg = self.cfg
        outk = np.zeros((cfg.n_layers, used, cfg.n_kv_heads, cfg.head_dim), np.float32)
        outv = np.zeros_like(outk)
        for rank_parts in parts:
            for li, c0, heads, k, v in rank_parts:
                outk[li, c0:c0 + k.shape[0], heads] = k
                outv[li, c0:c0 + v.shape[0], heads] = v
        return outk, outv

    def restore_slot(self, slot, ks: np.ndarray, vs: np.ndarray, used: int) -> None:
        """Write (L, used, kvh, hd) K and V into the slot from cell 0 on
        every rank that holds part of it (through the KV write kernel,
        requantized for a quantized cache)."""
        self._send("restore_slot", slot, ks, vs, used)
        row = self._local(slot)
        lo, hi = self.offset, min(self.offset + self.t_loc, used)
        if row is not None and hi > lo:
            heads = self._layer_heads()
            start = torch.zeros(1, dtype=torch.int32, device=self.mesh.device)
            for li, kv in enumerate(self.caches):
                if kv is None:
                    continue
                for cache, src in zip(kv, (ks, vs)):
                    cells = torch.from_numpy(np.ascontiguousarray(
                        src[li, lo:hi, heads], np.float32))
                    update_kv(cache[row:row + 1], cells[None].to(self.mesh.device), start)
        self.cache_pos[self._row(slot)] = used
