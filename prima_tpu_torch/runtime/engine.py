"""Continuous-batching inference engine (single device).

Counterpart of prima_tpu/runtime/engine.py: N slots share one KV cache
(dense, KVQ8 or KVQ4); prompts prefill in chunks of their exact length (the
JAX engine pads them to power-of-two buckets to bound its recompiles, which
an eager forward does not need); each step() decodes one token for every
active slot in one batched forward (inactive rows are parked, their writes
overwritten before they are ever read). Self-Extend (grp_attn_n > 1)
compresses the RoPE positions of a slot's cells while visibility keeps
following the physical cache order.

Uniform decode invariant: prefill ingests prompt[:-1] only; the last
prompt token always enters through the batched decode step.

Not ported yet: speculative verification and forks. PyTorch runs eagerly,
so the JAX engine's scan mode (a compile-time device) has no counterpart.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.llama import ForwardOptions, forward, init_kv_caches, model_norm
from ..sampling import Sampler, SamplerParams, softmax
from .generate import (MAX_TOPK, FusedGenerator, SlotSampleParams,
                       fused_eligible, sample_one, stable_topk)
from .kv import KVCache


def apply_self_extend(slot, used: int, max_seq: int, ga_n: int, ga_w: int,
                      rope_shift) -> None:
    """Self-Extend grouped-attention compression (main.cpp:618-640): once
    the logical position passes ga_i + ga_w, compress the window's RoPE
    positions by ga_n. Cells never move (visibility by index holds);
    `rope_shift(delta)` re-rotates the slot's cached K by the per-cell
    position delta, and later tokens carry slot.pos_delta as a negative
    logical-position offset. Mutates slot.{pos_map, ga_i, pos_delta}."""
    if ga_n <= 1:
        return
    if slot.pos_map is None:
        slot.pos_map = np.arange(max_seq, dtype=np.int64)
    n_past = used + slot.pos_delta  # logical
    while n_past >= slot.ga_i + ga_w:
        ib = (ga_n * slot.ga_i) // ga_w
        bd = (ga_w // ga_n) * (ga_n - 1)
        dd = (ga_w // ga_n) - ib * bd - ga_w
        L = slot.pos_map
        base = slot.ga_i + ib * bd
        L1 = np.where((L >= slot.ga_i) & (L < n_past), L + ib * bd, L)
        L2 = np.where((L1 >= base) & (L1 < base + ga_w), L1 // ga_n, L1)
        L3 = np.where((L2 >= base + ga_w) & (L2 < n_past + ib * bd), L2 + dd, L2)
        live = np.arange(max_seq) < used
        L3 = np.where(live, L3, L)
        rope_shift((L3 - L).astype(np.int32))
        slot.pos_map = L3
        n_past -= bd
        slot.ga_i += ga_w // ga_n
    slot.pos_delta = n_past - used


class SlotState(Enum):
    IDLE = 0
    PREFILL = 1
    DECODE = 2


@dataclass
class Slot:
    id: int
    state: SlotState = SlotState.IDLE
    prompt: list[int] = field(default_factory=list)
    n_prompt_done: int = 0
    generated: list[int] = field(default_factory=list)
    sampler: Sampler | None = None
    n_predict: int = -1
    request_id: Any = None
    stop_reason: str | None = None
    n_probs: int = 0  # top-N logprobs per sampled token
    # Self-Extend state (main.cpp:618-640)
    ga_i: int = 0
    pos_delta: int = 0  # logical (RoPE) position - physical write index
    pos_map: Any = None  # per-cell logical positions (lazy)
    # context-shift history: (n_keep, n_discard) per shift, in order
    shifts: list = field(default_factory=list)


@dataclass
class StepEvent:
    slot_id: int
    request_id: Any
    token: int | None
    done: bool
    reason: str | None = None
    logprobs: list | None = None  # [(token_id, logprob)] top-N + sampled


class Engine:
    def __init__(self, cfg: ModelConfig, params: dict, n_slots: int = 4,
                 max_seq: int = 2048, n_batch: int = 256,
                 opts: ForwardOptions | None = None, kv_dtype=torch.bfloat16,
                 eog_ids: set[int] | None = None, ctx_shift: bool = False,
                 n_keep: int = 0, grp_attn_n: int = 1, grp_attn_w: int = 512,
                 device=None):
        if grp_attn_n < 1:
            raise ValueError("grp_attn_n must be >= 1")
        if grp_attn_n > 1 and grp_attn_w % grp_attn_n:
            raise ValueError("grp_attn_w must be a multiple of grp_attn_n (main.cpp:221)")
        if ctx_shift and grp_attn_n > 1:
            raise ValueError("context shift and Self-Extend are mutually exclusive")
        self.cfg = cfg
        self.opts = opts or ForwardOptions()
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.n_batch = n_batch
        self.params = params
        self.kv = KVCache(cfg, n_slots, max_seq, kv_dtype, self.device)
        self.slots = [Slot(i) for i in range(n_slots)]
        self.eog_ids = eog_ids or set()
        self.n_decode_calls = 0
        self.ctx_shift = ctx_shift  # shift on a full context, else stop
        self.n_keep = n_keep
        self.grp_attn_n = grp_attn_n
        self.grp_attn_w = grp_attn_w
        self.perf = {"n_prompt": 0, "n_decode": 0, "t_prompt_s": 0.0, "t_decode_s": 0.0}
        self._fused_gen = FusedGenerator(self._decode_raw, self.device)

    # -- device programs ---------------------------------------------------------

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.no_grad()
    def _prefill(self, tokens: np.ndarray, pos0: int, rope0: int, slot: int) -> None:
        """Ingest `tokens` on one slot's cache row in place (the JAX engine
        slices the row out and sets it back). pos0 is the physical write
        index, rope0 the logical (RoPE) position; they differ only under
        Self-Extend, and visibility follows the physical one."""
        s_len = len(tokens)
        row = [(k[slot:slot + 1], v[slot:slot + 1]) for k, v in self.kv.caches]
        steps = np.arange(s_len)[None]
        forward(self.params, self.cfg, self._tensor(tokens[None], torch.int64),
                self._tensor(rope0 + steps), row, self._tensor([pos0]), self.opts,
                return_hidden=True, mask_positions=self._tensor(pos0 + steps))

    @torch.no_grad()
    def _decode_raw(self, params, caches, tokens, cache_pos, rope_pos):
        """tokens (B, 1), cache_pos / rope_pos (B,) on the device ->
        (logits (B, V), caches). Causal visibility follows the write index."""
        logits, caches = forward(params, self.cfg, tokens, rope_pos[:, None], caches,
                                 cache_pos, self.opts,
                                 mask_positions=cache_pos[:, None])
        return logits[:, -1], caches

    # -- request management ------------------------------------------------------

    def find_idle_slot(self) -> Slot | None:
        for s in self.slots:
            if s.state == SlotState.IDLE:
                return s
        return None

    def submit(self, prompt_tokens: list[int], sampler: Sampler | None = None,
               n_predict: int = -1, request_id: Any = None,
               reuse_prefix: bool = True, n_probs: int = 0) -> Slot:
        if not prompt_tokens:
            raise ValueError("empty prompt")
        slot = self.find_idle_slot()
        if slot is None:
            raise RuntimeError("no idle slot")
        if len(prompt_tokens) >= self.max_seq:
            raise ValueError(f"prompt ({len(prompt_tokens)}) exceeds max_seq")
        # prompt-prefix reuse against this slot's previous contents
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
        slot.ga_i = 0
        slot.pos_delta = 0
        slot.pos_map = None
        slot.shifts = []
        for t in prompt_tokens:
            slot.sampler.accept(t, accept_grammar=False)
        if slot.n_prompt_done >= len(slot.prompt) - 1:
            slot.state = SlotState.DECODE  # everything but the last token cached
        return slot

    def cancel(self, request_id: Any) -> bool:
        for s in self.slots:
            if s.request_id == request_id and s.state != SlotState.IDLE:
                s.state = SlotState.IDLE
                s.stop_reason = "cancelled"
                return True
        return False

    # -- the decode loop -----------------------------------------------------------

    def _apply_self_extend(self, slot: Slot) -> None:
        apply_self_extend(slot, self.kv.used(slot.id), self.max_seq, self.grp_attn_n,
                          self.grp_attn_w, lambda d: self.kv.rope_shift(slot.id, d))

    def _record_positions(self, slot: Slot, pos0: int, n: int) -> None:
        """Track the logical position of newly written cells (Self-Extend)."""
        if self.grp_attn_n <= 1:
            return
        if slot.pos_map is None:
            slot.pos_map = np.arange(self.max_seq, dtype=np.int64)
        slot.pos_map[pos0:pos0 + n] = pos0 + slot.pos_delta + np.arange(n, dtype=np.int64)

    def _advance_prefill(self, slot: Slot) -> None:
        """Ingest one chunk of prompt[:-1] into the slot's cache row."""
        self._apply_self_extend(slot)
        target = len(slot.prompt) - 1
        chunk = slot.prompt[slot.n_prompt_done: min(slot.n_prompt_done + self.n_batch, target)]
        pos0 = self.kv.used(slot.id)
        self._prefill(np.asarray(chunk, dtype=np.int64), pos0, pos0 + slot.pos_delta,
                      slot.id)
        self._record_positions(slot, pos0, len(chunk))
        self.kv.cache_pos[slot.id] += len(chunk)
        slot.n_prompt_done += len(chunk)
        if slot.n_prompt_done >= target:
            slot.state = SlotState.DECODE

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> list[StepEvent]:
        """One scheduler tick: advance prefills, then one batched decode."""
        events: list[StepEvent] = []
        t0 = time.perf_counter()
        did_prefill = False
        for slot in self.slots:
            if slot.state == SlotState.PREFILL:
                n_before = slot.n_prompt_done
                self._advance_prefill(slot)
                self.perf["n_prompt"] += slot.n_prompt_done - n_before
                did_prefill = True
        if did_prefill:
            self._sync()
            self.perf["t_prompt_s"] += time.perf_counter() - t0

        active = [s for s in self.slots if s.state == SlotState.DECODE]
        if not active:
            return events
        if self.ctx_shift:  # shift instead of stopping when a slot fills
            for slot in active:
                used = self.kv.used(slot.id)
                if used >= self.max_seq - 1:
                    n_discard = max((used - self.n_keep) // 2, 1)
                    self.kv.context_shift(slot.id, self.n_keep, n_discard)
                    slot.shifts.append((self.n_keep, n_discard))
        if self.grp_attn_n > 1:
            for slot in active:
                self._apply_self_extend(slot)
                self._record_positions(slot, self.kv.used(slot.id), 1)
        t0 = time.perf_counter()
        tokens = np.zeros((self.n_slots, 1), dtype=np.int64)
        rope_delta = np.zeros(self.n_slots, dtype=np.int32)
        for slot in active:
            tokens[slot.id, 0] = slot.generated[-1] if slot.generated else slot.prompt[-1]
            rope_delta[slot.id] = slot.pos_delta
        cache_pos = self._tensor(self.kv.cache_pos)  # inactive rows park in place
        # one decode program whatever the transfer mode, so the shortlist
        # and full-row paths see the same logits
        use_sl = all(self._slot_shortlist_ok(s) for s in active)
        with torch.no_grad():
            logits, self.kv.caches = self._decode_raw(
                self.params, self.kv.caches, self._tensor(tokens, torch.int64),
                cache_pos, self._tensor(self.kv.cache_pos + rope_delta))
            lf = logits.float()
            if use_sl:
                vals, idx = stable_topk(lf, min(MAX_TOPK, lf.shape[-1]))
                lse = torch.logsumexp(lf, dim=-1)
                sl_vals, sl_idx, sl_lse = (vals.cpu().numpy(), idx.cpu().numpy(),
                                           lse.cpu().numpy())
                logits_all = None
            else:
                logits_all = lf.cpu().numpy()
        self.n_decode_calls += 1
        self.perf["t_decode_s"] += time.perf_counter() - t0
        self.perf["n_decode"] += len(active)
        for slot in active:
            self.kv.cache_pos[slot.id] += 1

        V = self.cfg.n_vocab
        for slot in active:
            row = logits_all[slot.id] if logits_all is not None else None
            sl = None if row is not None else (sl_vals[slot.id], sl_idx[slot.id])
            if slot.sampler.p.temp > 0 and fused_eligible(slot.sampler):
                # same draw schedule as step_fused: (seed, token index)
                tok = sample_one(
                    row, SlotSampleParams.from_sampler(slot.sampler),
                    list(slot.sampler.prev), len(slot.generated),
                    logit_bias=slot.sampler.p.logit_bias,
                    shortlist=None if sl is None else (sl[0], sl[1], V),
                    device=self.device)
            else:
                if row is None:  # virtual full row from the shortlist
                    row = np.full(V, -1e30, np.float32)
                    row[sl[1]] = sl[0]
                tok = slot.sampler.sample(row)
            slot.sampler.accept(tok)
            slot.generated.append(tok)
            lp = None
            if slot.n_probs > 0:
                if sl is not None:
                    lpv = sl[0] - sl_lse[slot.id]
                    pairs = {int(t): float(lpv[i]) for i, t in enumerate(sl[1])}
                    ids = [int(t) for t in sl[1][: slot.n_probs]]
                    if tok in pairs:
                        ids.append(tok)
                    lp = [(t, pairs[t]) for t in dict.fromkeys(ids)]
                else:
                    probs = np.log(np.maximum(softmax(row), 1e-30))
                    top = np.argsort(-row)[: slot.n_probs]
                    ids = list(dict.fromkeys([int(t) for t in top] + [tok]))
                    lp = [(int(t), float(probs[t])) for t in ids]
            done, reason = self._check_stop(slot, tok)
            if done:
                slot.state = SlotState.IDLE
                slot.stop_reason = reason
            events.append(StepEvent(slot.id, slot.request_id, tok, done, reason,
                                    logprobs=lp))
        return events

    def _slot_shortlist_ok(self, s: Slot) -> bool:
        """True iff this slot's chain is exact on the top-256 shortlist
        (penalties only lower the W window tokens, so the post-penalty
        top-k lies within the pre-penalty top-(k + W))."""
        p = s.sampler.p
        if s.sampler.grammar is not None or p.mirostat != 0:
            return False
        if any(b > 0 for b in p.logit_bias.values()):
            return False  # a positive bias can promote any token
        K = min(MAX_TOPK, self.cfg.n_vocab)
        W = 0
        if p.penalty_last_n != 0 and (p.penalty_repeat != 1.0 or p.penalty_freq != 0.0
                                      or p.penalty_present != 0.0):
            if p.penalty_repeat < 1.0 or p.penalty_freq < 0.0 or p.penalty_present < 0.0:
                return False  # anti-penalties raise logits out of range
            n_prev = len(s.sampler.prev)
            W = n_prev if p.penalty_last_n < 0 else min(p.penalty_last_n, n_prev)
        if p.temp <= 0:
            return W + 1 <= K
        return 0 < p.top_k and p.top_k + W <= K

    # -- fused on-device decode + sample ----------------------------------------

    def _fused_ready(self) -> list | None:
        """The active slots when the chunked device path applies, else
        None (-> step())."""
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
        if any(self.kv.used(s.id) >= self.max_seq - 1 for s in active):
            return None
        return active

    def step_fused(self, max_chunk: int | None = None) -> list[StepEvent]:
        """Chunked decode: up to `max_chunk` tokens per host round trip,
        sampled on the device; falls back to step() whenever a slot needs
        the host chain."""
        active = self._fused_ready()
        if active is None:
            return self.step()
        if not active:
            return []
        B = self.n_slots
        chunk = max_chunk or self._fused_gen.chunk
        # Self-Extend: apply pending compression on the host, then cap the
        # chunk so no slot crosses a ga boundary mid-chunk
        if self.grp_attn_n > 1:
            for s in active:
                self._apply_self_extend(s)
                n_past = self.kv.used(s.id) + s.pos_delta
                chunk = max(1, min(chunk, int(s.ga_i + self.grp_attn_w - n_past)))
        probs_k = max((s.n_probs for s in active), default=0)
        token = np.zeros((B, 1), np.int64)
        rope_delta = np.zeros(B, np.int32)
        n_left = np.zeros(B, np.int32)
        gen_count = np.zeros(B, np.int32)
        slot_params: list = [None] * B
        recent: list = [[] for _ in range(B)]
        for s in active:
            token[s.id, 0] = s.generated[-1] if s.generated else s.prompt[-1]
            rope_delta[s.id] = s.pos_delta
            room = self.max_seq - self.kv.used(s.id)
            want = s.n_predict - len(s.generated) if s.n_predict >= 0 else chunk
            n_left[s.id] = max(min(want, room, chunk), 1)
            gen_count[s.id] = len(s.generated)
            slot_params[s.id] = SlotSampleParams.from_sampler(s.sampler)
            recent[s.id] = list(s.sampler.prev)
        # parked rows write one scratch cell per step: a full idle slot
        # would clamp onto its last valid cell, so drop its reusable prefix
        cache_pos = self.kv.cache_pos.copy()
        for s in self.slots:
            if slot_params[s.id] is None and cache_pos[s.id] >= self.max_seq:
                cache_pos[s.id] = 0
                s.prompt = []

        t0 = time.perf_counter()
        caches, toks, new_pos, lp = self._fused_gen.generate(
            self.params, self.kv.caches, token, cache_pos, rope_delta,
            slot_params, recent, n_left, gen_count,
            logit_bias=active[0].sampler.p.logit_bias, chunk=chunk,
            eog_ids=sorted(self.eog_ids), probs_k=probs_k)
        self.kv.caches = caches
        self.n_decode_calls += 1
        self.perf["t_decode_s"] += time.perf_counter() - t0

        events: list[StepEvent] = []
        for s in active:
            kept = [int(t) for t in toks[s.id] if t >= 0]
            if kept:
                self._record_positions(s, int(cache_pos[s.id]), len(kept))
            self.kv.cache_pos[s.id] = int(new_pos[s.id])
            for j, tok_ in enumerate(kept):
                s.generated.append(tok_)
                s.sampler.accept(tok_)
                self.perf["n_decode"] += 1
                lprobs = None
                if s.n_probs > 0 and lp is not None:
                    pv, pi, lse, tl = (lp[0][s.id, j], lp[1][s.id, j],
                                       lp[2][s.id, j], lp[3][s.id, j])
                    pairs = {int(t): float(v - lse) for t, v in zip(pi, pv)}
                    pairs.setdefault(tok_, float(tl - lse))
                    order = list(dict.fromkeys([int(t) for t in pi[: s.n_probs]] + [tok_]))
                    lprobs = [(t, pairs[t]) for t in order]
                # the device loop stops rows exactly at eog / length / room
                done, reason = (self._check_stop(s, tok_)
                                if j == len(kept) - 1 else (False, None))
                if done:
                    s.state = SlotState.IDLE
                    s.stop_reason = reason
                events.append(StepEvent(s.id, s.request_id, tok_, done, reason,
                                        logprobs=lprobs))
        return events

    def _check_stop(self, slot: Slot, tok: int) -> tuple[bool, str | None]:
        if tok in self.eog_ids:
            return True, "eog"
        if slot.n_predict >= 0 and len(slot.generated) >= slot.n_predict:
            return True, "length"
        if not self.ctx_shift and self.kv.used(slot.id) >= self.max_seq:
            return True, "context_full"
        return False, None

    @torch.no_grad()
    def embed(self, prompt_tokens: list[int], pooling: str = "mean") -> np.ndarray:
        """Sequence embedding (the /v1/embeddings path): pooled final-norm
        hidden states over a scratch one-row cache."""
        n = len(prompt_tokens)
        kv = init_kv_caches(self.cfg, 1, n, self.kv.dtype, self.device)
        hidden, _ = forward(self.params, self.cfg,
                            self._tensor(np.asarray([prompt_tokens]), torch.int64),
                            self._tensor(np.arange(n)[None]), kv,
                            self._tensor([0]), self.opts, return_hidden=True)
        hidden = model_norm(hidden, self.params.get("output_norm"),
                            self.params.get("output_norm_b"), self.cfg)
        h = hidden[0].float().cpu().numpy()
        if pooling == "last":
            return h[-1]
        if pooling == "cls":
            return h[0]
        return h.mean(axis=0)

    def run_to_completion(self, prompt_tokens: list[int], **kw) -> list[int]:
        """Synchronous single-request helper."""
        slot = self.submit(prompt_tokens, **kw)
        while slot.state != SlotState.IDLE:
            self.step()
        return list(slot.generated)

