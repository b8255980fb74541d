"""The distributed engines' slot record and the mesh engine.

Counterpart of prima_tpu/parallel/engine.py. `DSlot` is the slot of both
distributed engines: the TCP ring's (parallel/ring_tcp.py, row b of
ubatch group m) and the mesh's. `DistributedEngine` is continuous
batching over the (dp, pp, sp, tp) mesh pipeline: the slot pool is the
pipeline's microbatch grid, slot (m, b) being row b of microbatch m, and
one step() drives one piped-ring pass for every active slot (a prefill
pass takes each prefilling slot's next prompt chunk, a decode pass one
token of every decoding slot). Parked rows ride along: their writes land
at their own cache_pos and are overwritten before the causal mask admits
them, so with more than one slot a row may not come within n_batch of the
cache's end (`_row_limit`, as in the JAX engine).

SPMD over processes. Rank 0 owns the engine: slots, sampling, HTTP.
Before each pass it broadcasts the pass (tokens, positions, mask
positions, the cache_pos grid) over the mesh's control group, and every
KV mutation (pipe_kv.PipeKV) likewise; every other rank runs
`PipeWorker.serve`, which executes the same commands on its own windows.
A worker leaves when rank 0 sends "stop" or its process ends (the group's
connections close). The engine has the single-device Engine's surface
(n_slots, slots[flat id], kv with seq ops, submit / step / step_fused /
prefill_only / verify_chain / embed, perf), so the server and the
speculative decoder drive it unchanged.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import ForwardOptions, model_norm
from ..runtime.engine import SlotState, StepEvent, apply_self_extend, record_positions
from ..runtime.generate import FusedGenerator, SlotSampleParams, fused_eligible, sample_one
from ..sampling import Sampler, SamplerParams, softmax
from .mesh import Mesh
from .pipe_kv import PipeKV
from .pipeline import PipeForward, PipeSpec, init_pipe_kv


@dataclass
class DSlot:
    m: int
    b: int
    n_slots_b: int = 1  # rows per group (for the flat id)
    state: SlotState = SlotState.IDLE
    prompt: list[int] = field(default_factory=list)
    n_prompt_done: int = 0
    generated: list[int] = field(default_factory=list)
    sampler: Sampler | None = None
    n_predict: int = -1
    request_id: Any = None
    stop_reason: str | None = None
    n_probs: int = 0
    shifts: list = field(default_factory=list)
    # Self-Extend grouped attention (main.cpp:618-640)
    ga_i: int = 0
    pos_delta: int = 0  # logical (RoPE) position - physical write index
    pos_map: Any = None  # per-cell logical positions (lazy)

    @property
    def id(self) -> int:
        """Flat slot id (server-visible, like the reference's slot.id)."""
        return self.m * self.n_slots_b + self.b


def launch_counts(reset: bool = False) -> dict[str, int]:
    """This process's kernel launch counts (zeroed after reading on reset)."""
    from ..ops import attention, kv_write
    from ..quant import qmatmul

    counters = (qmatmul.launches, qmatmul.indexed_launches, kv_write.launches,
                kv_write.store_launches, attention.decode_launches,
                attention.prefill_launches)
    out = {c.name: c.count for c in counters}
    if reset:
        for c in counters:
            c.count = 0
    return out


class PipeRank:
    """One engine's state on one rank: its caches and the pipe forward over
    the rank's params (pipeline.build_pipe_model), and the commands of the
    control plane."""

    def __init__(self, cfg: ModelConfig, params: dict, spec: PipeSpec, mesh: Mesh,
                 batch_per_micro: int, max_seq: int, opts: ForwardOptions | None,
                 kv_dtype, streamer=None):
        self.cfg, self.params, self.spec, self.mesh = cfg, params, spec, mesh
        self.opts = opts or ForwardOptions()
        self.B = batch_per_micro
        self.kv = PipeKV(cfg, spec, mesh, batch_per_micro, max_seq, kv_dtype)
        self.fwd = PipeForward(cfg, spec, mesh, self.opts, streamer=streamer)
        self.fwd_hidden = PipeForward(cfg, spec, mesh, self.opts, return_hidden=True,
                                      streamer=streamer)

    def execute(self, cmd: tuple):
        """Run one command on this rank; rank 0 gets the result."""
        op = cmd[0]
        if op == "pass":
            tokens, positions, cache_pos, mask_positions, head = cmd[1:]
            out, _ = self.fwd(self.params, tokens, positions, cache_pos, self.kv.caches,
                              mask_positions, head)
            return out
        if op == "kv":
            return getattr(self.kv, cmd[1])(*cmd[2])
        if op == "embed":
            tokens, positions = cmd[1:]
            # a scratch cache of the sequence's length, as the JAX engine's
            caches = init_pipe_kv(self.cfg, self.spec, self.mesh, self.B, tokens.shape[-1],
                                  torch.bfloat16)
            out, _ = self.fwd_hidden(self.params, tokens, positions,
                                     np.zeros(tokens.shape[:2], np.int32), caches)
            return out
        if op == "counts":
            return self.mesh.gather_obj0(launch_counts(reset=cmd[1]))
        if op == "stats":
            return self.mesh.gather_obj0(self.stats(reset=cmd[1]))
        raise ValueError(f"unknown mesh command {op!r}")


    def stats(self, reset: bool = False) -> dict:
        """This rank's transport counters (parallel/mesh.Mesh.stats), the
        ring hops it sent and their bytes, and its device's peak memory
        since the last reset."""
        dev = self.mesh.device
        out = {"mesh": {k: list(v) for k, v in self.mesh.stats.items()},
               "hops": self.fwd.hops, "hop_bytes": self.fwd.hop_bytes,
               "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0}
        if reset:
            for v in self.mesh.stats.values():
                v[:] = [0, 0.0, 0]
            self.fwd.hops = self.fwd.hop_bytes = 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
        return out


class PipeWorker:
    """A rank other than 0: executes rank 0's commands until "stop". Each
    DistributedEngine on rank 0 has its own state here (caches, options),
    made by its "init" command, so several engines can share the ranks."""

    def __init__(self, cfg: ModelConfig, params: dict, spec: PipeSpec, mesh: Mesh,
                 streamer=None):
        if mesh.rank == 0:
            raise ValueError("rank 0 runs the DistributedEngine, not a worker")
        self.cfg, self.params, self.spec, self.mesh = cfg, params, spec, mesh
        self.streamer = streamer
        self.engines: dict[int, PipeRank] = {}

    def serve(self) -> None:
        while True:
            eid, *cmd = self.mesh.bcast_cmd()
            if cmd[0] == "stop":
                return
            if cmd[0] == "init":
                self.engines[eid] = PipeRank(self.cfg, self.params, self.spec, self.mesh,
                                             *cmd[1:], streamer=self.streamer)
            else:
                self.engines[eid].execute(tuple(cmd))


class DistributedEngine:
    """Engine-compatible surface over the (dp, pp, sp, tp) mesh pipeline
    (rank 0)."""

    _ids = itertools.count()

    def __init__(self, cfg: ModelConfig, params: dict, spec: PipeSpec, mesh: Mesh,
                 batch_per_micro: int = 1, max_seq: int = 2048, n_batch: int = 64,
                 opts: ForwardOptions | None = None, kv_dtype=torch.bfloat16,
                 eog_ids: set[int] | None = None, ctx_shift: bool = False, n_keep: int = 0,
                 grp_attn_n: int = 1, grp_attn_w: int = 512, streamer=None):
        if mesh.rank != 0:
            raise ValueError("the DistributedEngine runs on rank 0")
        if grp_attn_n < 1:
            raise ValueError("grp_attn_n must be >= 1")
        if grp_attn_n > 1 and grp_attn_w % grp_attn_n:
            raise ValueError("grp_attn_w must be a multiple of grp_attn_n (main.cpp:221)")
        if ctx_shift and grp_attn_n > 1:
            raise ValueError("context shift and Self-Extend are mutually exclusive")
        self.cfg = cfg
        self.params = params
        self.spec = spec
        self.mesh = mesh
        self.device = mesh.device
        self.opts = opts or ForwardOptions()
        self.M, self.B = spec.microbatches, batch_per_micro
        self.max_seq = max_seq
        self.n_batch = n_batch
        self.eog_ids = eog_ids or set()
        self.ctx_shift = ctx_shift
        self.n_keep = n_keep
        self.grp_attn_n = grp_attn_n
        self.grp_attn_w = grp_attn_w
        self._eid = next(DistributedEngine._ids)
        mesh.bcast_cmd((self._eid, "init", batch_per_micro, max_seq, self.opts, kv_dtype))
        self.rank = PipeRank(cfg, params, spec, mesh, batch_per_micro, max_seq, self.opts,
                             kv_dtype, streamer)
        self.kv = self.rank.kv
        self.kv.bcast = lambda name, args: mesh.bcast_cmd((self._eid, "kv", name, args))
        # every grid row writes its padding at its own cache_pos (clamped at
        # the end): with more than one slot a parked row within s_len of the
        # end would shift its write onto real cells, so reserve n_batch; a
        # single slot gets the whole cache
        self._row_limit = max_seq if self.M * self.B == 1 else max_seq - n_batch
        if self._row_limit <= 0:
            raise ValueError("n_batch must be < max_seq")
        self.slots = [DSlot(m, b, batch_per_micro) for m in range(self.M)
                      for b in range(self.B)]
        self.n_decode_calls = 0
        self.perf = {"n_prompt": 0, "n_decode": 0, "t_prompt_s": 0.0, "t_decode_s": 0.0}
        self._fused_gen = FusedGenerator(self._decode_raw_flat, self.device)

    @property
    def n_slots(self) -> int:
        return self.M * self.B

    @property
    def cache_pos(self) -> np.ndarray:
        """(M, B) view of the flat per-slot cache positions."""
        return self.kv.cache_pos.reshape(self.M, self.B)

    def _run(self, cmd: tuple):
        """Send a command to every rank and run it here. Commands go out
        from one thread only (the server runs /props through its worker)."""
        self.mesh.bcast_cmd((self._eid,) + cmd)
        return self.rank.execute(cmd)

    def stop(self) -> None:
        """Release the workers (they return from serve)."""
        self.mesh.bcast_cmd((self._eid, "stop"))

    def kernel_launches(self, reset: bool = False) -> dict:
        """Every rank's kernel launch counts, summed, and by rank."""
        by_rank = self._run(("counts", reset))
        total = {k: sum(r[k] for r in by_rank) for k in by_rank[0]}
        return {"total": total, "by_rank": by_rank}

    def mesh_stats(self, reset: bool = False) -> list:
        """Every rank's PipeRank.stats (zeroed after reading on reset)."""
        return self._run(("stats", reset))

    def _pass(self, tokens: np.ndarray, positions: np.ndarray,
              mask_positions: np.ndarray | None = None, head: bool = True):
        """One piped-ring pass over the grid: logits (M, B, S, V) on rank
        0's device, or None for a pass without the head (prefill)."""
        mp = positions if mask_positions is None else mask_positions
        out = self._run(("pass", np.asarray(tokens, np.int64),
                         np.asarray(positions, np.int32), self.cache_pos.copy(),
                         np.asarray(mp, np.int32), head))
        self.n_decode_calls += 1
        return out

    # -- request management --------------------------------------------------

    def find_idle_slot(self) -> DSlot | None:
        return next((s for s in self.slots if s.state == SlotState.IDLE), None)

    def submit(self, prompt_tokens: list[int], sampler: Sampler | None = None,
               n_predict: int = -1, request_id: Any = None, reuse_prefix: bool = True,
               n_probs: int = 0) -> DSlot:
        if not prompt_tokens:
            raise ValueError("empty prompt")
        if len(prompt_tokens) >= self._row_limit:
            raise ValueError(f"prompt ({len(prompt_tokens)}) exceeds the per-slot "
                             f"context limit ({self._row_limit})")
        slot = self.find_idle_slot()
        if slot is None:
            raise RuntimeError("no idle slot")
        common = 0
        if reuse_prefix and slot.prompt:
            limit = min(len(slot.prompt), len(prompt_tokens) - 1, self.kv.used(slot.id))
            while common < limit and slot.prompt[common] == prompt_tokens[common]:
                common += 1
        self.kv.seq_rm(slot.id, p0=common)
        slot.state = SlotState.PREFILL
        slot.prompt = list(prompt_tokens)
        slot.n_prompt_done = common
        slot.generated = []
        slot.sampler = sampler or Sampler(SamplerParams(temp=0.0))
        slot.n_predict = n_predict
        slot.request_id = request_id
        slot.stop_reason = None
        slot.n_probs = n_probs
        slot.shifts = []
        slot.ga_i = 0
        slot.pos_delta = 0
        slot.pos_map = None
        for t in prompt_tokens:
            slot.sampler.accept(t, accept_grammar=False)
        if slot.n_prompt_done >= len(slot.prompt) - 1:
            slot.state = SlotState.DECODE
        return slot

    def cancel(self, request_id: Any) -> bool:
        for s in self.slots:
            if s.request_id == request_id and s.state != SlotState.IDLE:
                s.state = SlotState.IDLE
                s.stop_reason = "cancelled"
                return True
        return False

    # -- Self-Extend grouped attention ----------------------------------------

    def _rope_delta_grid(self, pool) -> np.ndarray:
        """(M, B) per-slot logical-minus-physical rope offsets."""
        d = np.zeros((self.M, self.B), np.int32)
        for s in pool:
            d[s.m, s.b] = s.pos_delta
        return d

    def _apply_self_extend(self, slot: DSlot) -> None:
        apply_self_extend(slot, self.kv.used(slot.id), self.max_seq, self.grp_attn_n,
                          self.grp_attn_w, lambda d: self.kv.rope_shift(slot.id, d))

    def _record_positions(self, slot: DSlot, pos0: int, n: int) -> None:
        if self.grp_attn_n > 1:
            record_positions(slot, pos0, n, self.max_seq)

    # -- the scheduler tick -----------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill_tick(self, only: list | None = None) -> bool:
        """One batched prefill pass over PREFILL slots (optionally a subset):
        chunks of their exact length, at most n_batch."""
        t0 = time.perf_counter()
        pool = only if only is not None else self.slots
        prefill = [s for s in pool if s.state == SlotState.PREFILL]
        if not prefill:
            return False
        if self.grp_attn_n > 1:
            for s in prefill:
                self._apply_self_extend(s)
        s_len = min(self.n_batch, max(len(s.prompt) - 1 - s.n_prompt_done for s in prefill))
        # every grid row (parked ones too) writes s_len cells at its
        # cache_pos: cap the chunk at the cache tail
        s_len = max(min(s_len, self.max_seq - int(self.kv.cache_pos.max())), 1)
        tokens = np.zeros((self.M, self.B, s_len), np.int64)
        mask_positions = (np.arange(s_len, dtype=np.int32)[None, None]
                          + self.cache_pos[..., None]).astype(np.int32)
        positions = mask_positions + self._rope_delta_grid(prefill)[..., None]
        took = {}
        for s in prefill:
            chunk = s.prompt[s.n_prompt_done: min(s.n_prompt_done + s_len, len(s.prompt) - 1)]
            tokens[s.m, s.b, :len(chunk)] = chunk
            took[s.id] = len(chunk)
        self._pass(tokens, positions, mask_positions, head=False)
        for s in prefill:
            n = took[s.id]
            self._record_positions(s, self.kv.used(s.id), n)
            self.kv.cache_pos[s.id] += n
            s.n_prompt_done += n
            self.perf["n_prompt"] += n
            if s.n_prompt_done >= len(s.prompt) - 1:
                s.state = SlotState.DECODE
        self._sync()
        self.perf["t_prompt_s"] += time.perf_counter() - t0
        return True

    def prefill_only(self, slot: DSlot) -> None:
        while slot.state == SlotState.PREFILL:
            self._prefill_tick(only=[slot])

    def verify_chain(self, slot_id: int, chain: list[int]) -> np.ndarray:
        """Logits at every position of `chain` on one slot (s, V), through
        the distributed pipeline (draft on the host, target verified over
        the mesh, server.cpp:2493-2560). The slot's write index moves by
        len(chain); the caller rolls back."""
        s_len = len(chain)
        m, b = divmod(int(slot_id), self.B)
        pos0 = self.kv.used(slot_id)
        # every grid row writes padding at its own cache_pos: [pos, pos + s_len)
        # must stay inside the cache
        if pos0 + s_len > self.max_seq or (self.M * self.B > 1 and s_len > self.n_batch):
            raise ValueError(f"verify chain of {s_len} does not fit at {pos0}")
        tokens = np.zeros((self.M, self.B, s_len), np.int64)
        tokens[m, b] = chain
        mask_positions = (np.arange(s_len, dtype=np.int32)[None, None]
                          + self.cache_pos[..., None]).astype(np.int32)
        positions = mask_positions.copy()
        slot = self.slots[slot_id]
        positions[m, b] += slot.pos_delta  # Self-Extend's rope offset
        self._record_positions(slot, pos0, s_len)
        logits = self._pass(tokens, positions, mask_positions)
        self.kv.cache_pos[slot_id] = pos0 + s_len
        return logits[m, b].float().cpu().numpy()

    def step(self) -> list[StepEvent]:
        events: list[StepEvent] = []
        self._prefill_tick()
        active = [s for s in self.slots if s.state == SlotState.DECODE]
        if not active:
            return events
        # context shift instead of stopping when a slot's row fills
        # (main.cpp:584-617; PipeKV sends it to every rank)
        if self.ctx_shift:
            for s in active:
                used = self.kv.used(s.id)
                if used >= self._row_limit - 1:
                    n_discard = max((used - self.n_keep) // 2, 1)
                    self.kv.context_shift(s.id, self.n_keep, n_discard)
                    s.shifts.append((self.n_keep, n_discard))
        if self.grp_attn_n > 1:
            for s in active:
                self._apply_self_extend(s)
                self._record_positions(s, self.kv.used(s.id), 1)

        t0 = time.perf_counter()
        tokens = np.zeros((self.M, self.B, 1), np.int64)
        for s in active:
            tokens[s.m, s.b, 0] = s.generated[-1] if s.generated else s.prompt[-1]
        mask_positions = self.cache_pos[..., None].copy()
        positions = mask_positions + self._rope_delta_grid(active)[..., None]
        logits = self._pass(tokens, positions, mask_positions).float().cpu().numpy()
        for s in active:
            self.kv.cache_pos[s.id] += 1
        self.perf["t_decode_s"] += time.perf_counter() - t0
        self.perf["n_decode"] += len(active)

        for s in active:
            row = logits[s.m, s.b, -1]
            # the (seed, token index) draw schedule of step_fused, so streams
            # never depend on the route
            if s.sampler.p.temp > 0 and fused_eligible(s.sampler):
                tok = sample_one(row, SlotSampleParams.from_sampler(s.sampler),
                                 list(s.sampler.prev), len(s.generated),
                                 logit_bias=s.sampler.p.logit_bias, device=self.device)
                s.sampler.accept(tok)
            else:
                tok = s.sampler.sample_and_accept(row)
            s.generated.append(tok)
            lp = None
            if s.n_probs > 0:
                probs = np.log(np.maximum(softmax(row), 1e-30))
                top = np.argsort(-row)[: s.n_probs]
                ids = list(dict.fromkeys([int(t) for t in top] + [tok]))
                lp = [(int(t), float(probs[t])) for t in ids]
            done, reason = self._check_stop(s, tok)
            if done:
                s.state = SlotState.IDLE
                s.stop_reason = reason
            events.append(StepEvent(s.id, s.request_id, tok, done, reason, logprobs=lp))
        return events

    # -- chunked decode + sampling on rank 0's device ---------------------------------

    def _decode_raw_flat(self, params, caches, token, cache_pos, rope_pos):
        """token (F, 1), cache_pos / rope_pos (F,) on the device -> (logits
        (F, V), caches): the FusedGenerator body, one pass of the mesh a
        step (the step's inputs go to the host for the broadcast)."""
        M, B = self.M, self.B
        tok = token.reshape(M, B, 1).cpu().numpy()
        cp = cache_pos.reshape(M, B).cpu().numpy()
        pos = rope_pos.reshape(M, B, 1).cpu().numpy()
        out = self._run(("pass", tok, pos, cp, cp[..., None], True))
        return out[:, :, -1].reshape(M * B, -1), caches

    def _fused_ready(self) -> list | None:
        if any(s.state == SlotState.PREFILL for s in self.slots):
            return None
        active = [s for s in self.slots if s.state == SlotState.DECODE]
        if not active:
            return []
        if not all(fused_eligible(s.sampler) for s in active):
            return None
        bias0 = active[0].sampler.p.logit_bias
        if any(s.sampler.p.logit_bias != bias0 for s in active):
            return None
        # a context shift would trigger mid-chunk: let step() handle it
        if any(self.kv.used(s.id) >= self._row_limit - 1 for s in active):
            return None
        return active

    def step_fused(self, max_chunk: int | None = None) -> list[StepEvent]:
        """Chunked decode with sampling on rank 0's device, the key schedule
        of Engine.step_fused ((seed, token index) draws), the mesh pass as
        the loop body; falls back to step() whenever a slot needs the host
        chain."""
        active = self._fused_ready()
        if active is None:
            return self.step()
        if not active:
            return []
        F = self.n_slots
        chunk = max_chunk or self._fused_gen.chunk
        if self.grp_attn_n > 1:
            for s in active:
                self._apply_self_extend(s)
                n_past = self.kv.used(s.id) + s.pos_delta
                chunk = max(1, min(chunk, int(s.ga_i + self.grp_attn_w - n_past)))
        probs_k = max((s.n_probs for s in active), default=0)
        token = np.zeros((F, 1), np.int64)
        rope_delta = np.zeros(F, np.int32)
        n_left = np.zeros(F, np.int32)
        gen_count = np.zeros(F, np.int32)
        slot_params: list = [None] * F
        recent: list = [[] for _ in range(F)]
        for s in active:
            token[s.id, 0] = s.generated[-1] if s.generated else s.prompt[-1]
            rope_delta[s.id] = s.pos_delta
            room = self._row_limit - self.kv.used(s.id)
            want = s.n_predict - len(s.generated) if s.n_predict >= 0 else chunk
            n_left[s.id] = max(min(want, room, chunk), 1)
            gen_count[s.id] = len(s.generated)
            slot_params[s.id] = SlotSampleParams.from_sampler(s.sampler)
            recent[s.id] = list(s.sampler.prev)
        cache_pos = self.kv.cache_pos.copy()
        for s in self.slots:
            if slot_params[s.id] is None and cache_pos[s.id] >= self.max_seq:
                cache_pos[s.id] = 0
                s.prompt = []

        t0 = time.perf_counter()
        _, toks, new_pos, lp = self._fused_gen.generate(
            self.params, None, token, cache_pos, rope_delta, slot_params, recent, n_left,
            gen_count, logit_bias=active[0].sampler.p.logit_bias, chunk=chunk,
            eog_ids=sorted(self.eog_ids), probs_k=probs_k)
        self.n_decode_calls += 1
        self.perf["t_decode_s"] += time.perf_counter() - t0

        events: list[StepEvent] = []
        for s in active:
            kept = [int(t) for t in toks[s.id] if t >= 0]
            pos_before = int(cache_pos[s.id])
            self.kv.cache_pos[s.id] = int(new_pos[s.id])
            if kept:
                self._record_positions(s, pos_before, len(kept))
            for j, tok_ in enumerate(kept):
                s.generated.append(tok_)
                s.sampler.accept(tok_)
                self.perf["n_decode"] += 1
                lprobs = None
                if s.n_probs > 0 and lp is not None:
                    pv, pi, lse, tl = (lp[0][s.id, j], lp[1][s.id, j], lp[2][s.id, j],
                                       lp[3][s.id, j])
                    pairs = {int(t): float(v - lse) for t, v in zip(pi, pv)}
                    pairs.setdefault(tok_, float(tl - lse))
                    order = list(dict.fromkeys([int(t) for t in pi[: s.n_probs]] + [tok_]))
                    lprobs = [(t, pairs[t]) for t in order]
                done, reason = (self._check_stop(s, tok_) if j == len(kept) - 1
                                else (False, None))
                if done:
                    s.state = SlotState.IDLE
                    s.stop_reason = reason
                events.append(StepEvent(s.id, s.request_id, tok_, done, reason,
                                        logprobs=lprobs))
        return events

    def _check_stop(self, slot: DSlot, tok: int) -> tuple[bool, str | None]:
        if tok in self.eog_ids:
            return True, "eog"
        if slot.n_predict >= 0 and len(slot.generated) >= slot.n_predict:
            return True, "length"
        if not self.ctx_shift and self.kv.used(slot.id) >= self._row_limit:
            return True, "context_full"
        return False, None

    # -- aux surfaces (server parity) ------------------------------------------

    @torch.no_grad()
    def embed(self, prompt_tokens: list[int], pooling: str = "mean") -> np.ndarray:
        """/v1/embeddings through the pipeline (the hidden states of slot
        (0, 0) over a scratch cache)."""
        n = len(prompt_tokens)
        tokens = np.zeros((self.M, self.B, n), np.int64)
        tokens[0, 0] = prompt_tokens
        positions = np.broadcast_to(np.arange(n, dtype=np.int32), (self.M, self.B, n)).copy()
        hidden = self._run(("embed", tokens, positions))
        hidden = model_norm(hidden, self.params.get("output_norm"),
                            self.params.get("output_norm_b"), self.cfg)
        h = hidden[0, 0].float().cpu().numpy()
        if pooling == "last":
            return h[-1]
        if pooling == "cls":
            return h[0]
        return h.mean(axis=0)

    def perf_summary(self) -> str:
        p = self.perf
        pp = p["n_prompt"] / p["t_prompt_s"] if p["t_prompt_s"] > 0 else 0.0
        tg = p["n_decode"] / p["t_decode_s"] if p["t_decode_s"] > 0 else 0.0
        return (f"prompt eval: {p['n_prompt']} tokens in {p['t_prompt_s']:.2f}s "
                f"({pp:.1f} tok/s) | decode: {p['n_decode']} tokens in "
                f"{p['t_decode_s']:.2f}s ({tg:.1f} tok/s) | "
                f"{self.n_decode_calls} decode calls")

    def run_to_completion(self, prompt_tokens: list[int], **kw) -> list[int]:
        slot = self.submit(prompt_tokens, **kw)
        while slot.state != SlotState.IDLE:
            self.step()
        return list(slot.generated)
