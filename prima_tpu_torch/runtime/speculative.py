"""Speculative decoding: a draft model proposes, the target verifies.

Counterpart of prima_tpu/runtime/speculative.py (common/speculative.cpp and
the server's per-slot speculative branch, server.cpp:2493-2560). The draft
greedily proposes up to n_draft tokens, stopping once its confidence falls
under p_min; the target verifies the whole chain in one batched forward
and keeps the longest prefix that matches its own sampling. Greedy output
is token-identical to plain decoding whatever the draft's quality.

The target needs only the engine-agnostic protocol {submit, prefill_only,
verify_chain, kv.used / kv.cache_pos}. generate_stream takes a (target,
draft) slot pair per call, so concurrent requests speculate at once. Chains
the on-device decoder supports go to FusedSpeculative
(speculative_fused.py) unless PRIMA_SPEC_FUSED=0.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..sampling import Sampler, SamplerParams, softmax
from .engine import Engine, SlotState


@dataclass
class SpecStats:
    n_target_calls: int = 0
    n_draft_calls: int = 0
    n_drafted: int = 0
    n_accepted: int = 0

    @property
    def acceptance(self) -> float:
        return self.n_accepted / self.n_drafted if self.n_drafted else 0.0


def _decode_one(eng: Engine, slot_id: int, token: int) -> np.ndarray:
    """One batched decode step of `eng` feeding `token` to slot_id (the
    other rows park at their write index); the slot's write index moves by
    one. Returns the slot's logits row (V,) in f32."""
    tokens = np.zeros((eng.n_slots, 1), dtype=np.int64)
    tokens[slot_id, 0] = token
    cache_pos = eng._tensor(eng.kv.cache_pos)
    with torch.no_grad():
        logits, eng.kv.caches = eng._decode_raw(eng.params, eng.kv.caches,
                                                eng._tensor(tokens, torch.int64),
                                                cache_pos, cache_pos)
    eng.kv.cache_pos[slot_id] += 1
    return logits[slot_id].float().cpu().numpy()


class SpeculativeDecoder:
    def __init__(self, target, draft: Engine, n_draft: int = 8, p_min: float = 0.75):
        if target.n_slots < 1 or draft.n_slots < 1:
            raise ValueError("target and draft need a slot each")
        if any(getattr(getattr(e, "cfg", None), "kv_lora_rank", 0) for e in (target, draft)):
            raise NotImplementedError("speculative decoding with a latent attention "
                                      "(deepseek2) model")
        self.target = target
        self.draft = draft
        self.n_draft = n_draft
        self.p_min = p_min
        self._fused_impl = None

    # -- draft proposal (common_speculative_gen_draft) -------------------------

    def _gen_draft(self, stats: SpecStats, d_slot) -> list[int]:
        """Greedy draft continuation from the draft slot's state."""
        d = self.draft
        sid = d_slot.id
        out: list[int] = []
        for _ in range(self.n_draft):
            cur = d_slot.generated[-1] if d_slot.generated else d_slot.prompt[-1]
            probs = softmax(_decode_one(d, sid, cur))
            stats.n_draft_calls += 1
            tok = int(np.argmax(probs))
            if probs[tok] < self.p_min and out:
                d.kv.cache_pos[sid] -= 1  # un-commit the peeked position
                break
            d_slot.generated.append(tok)
            out.append(tok)
        stats.n_drafted += len(out)
        return out

    # -- main loop ---------------------------------------------------------------

    def generate(self, prompt_tokens: list[int], sampler: Sampler | None = None,
                 n_predict: int = 64) -> tuple[list[int], SpecStats]:
        stats = SpecStats()
        out: list[int] = []
        for chunk in self.generate_stream(prompt_tokens, sampler, n_predict, stats=stats):
            out.extend(chunk)
        return out[:n_predict], stats

    def _fused_spec(self, sampler: Sampler):
        """The on-device rounds (speculative_fused.py) when both engines are
        plain Engines and the chain is supported; PRIMA_SPEC_FUSED=0 forces
        the host path."""
        if os.environ.get("PRIMA_SPEC_FUSED", "1") == "0":
            return None
        from .speculative_fused import FusedSpeculative, fused_spec_eligible

        if type(self.target) is not Engine or type(self.draft) is not Engine:
            return None
        if not fused_spec_eligible(sampler):
            return None
        if self._fused_impl is None:
            self._fused_impl = FusedSpeculative(self.target, self.draft,
                                                n_draft=max(self.n_draft, 1),
                                                p_min=self.p_min)
        return self._fused_impl

    def generate_stream(self, prompt_tokens: list[int], sampler: Sampler | None = None,
                        n_predict: int = 64, stats: SpecStats | None = None):
        """Yield the newly accepted tokens of each verify round (the
        streaming server path). The slot pair is released when the
        generator finishes or is closed."""
        sampler = sampler or Sampler(SamplerParams(temp=0.0))
        stats = stats if stats is not None else SpecStats()
        if self.n_draft > 0:
            fused = self._fused_spec(sampler)
            if fused is not None:
                yield from fused.generate_stream(prompt_tokens, sampler, n_predict,
                                                 stats=stats)
                return
        t, d = self.target, self.draft
        # prompt[:-1] into a slot of each engine; submit() feeds the prompt
        # to the sampler (penalty window)
        t_slot = t.submit(prompt_tokens, sampler=sampler, n_predict=-1)
        d_slot = d.submit(prompt_tokens, n_predict=-1)
        tid, did = t_slot.id, d_slot.id
        try:
            t.prefill_only(t_slot)
            d.prefill_only(d_slot)
            n_out = 0
            cur = prompt_tokens[-1]
            while n_out < n_predict:
                d_slot.generated = [cur]  # the draft's next input
                draft = self._gen_draft(stats, d_slot) if self.n_draft > 0 else []
                # the target verifies [cur, draft...] in one forward
                pos0 = t.kv.used(tid)
                logits = t.verify_chain(tid, [cur] + draft)
                stats.n_target_calls += 1
                accepted: list[int] = []
                for j in range(len(draft) + 1):
                    tok = sampler.sample_and_accept(logits[j])
                    accepted.append(tok)
                    if t.eog_ids and tok in t.eog_ids:
                        break  # stop at EOG as plain decoding does
                    if j < len(draft) and tok == draft[j] \
                            and n_out + len(accepted) < n_predict:
                        stats.n_accepted += 1
                        continue
                    break
                n_out += len(accepted)
                cur = accepted[-1]
                # the target consumed the chain; roll back the unaccepted tail
                t.kv.cache_pos[tid] = pos0 + len(accepted)
                # the draft must hold exactly the verified history
                # [prompt .. out[:-1]]; the next round's input is out[-1]
                hist = len(prompt_tokens) + n_out - 1
                if self.n_draft <= 0:
                    pass
                elif d.kv.used(did) > hist:
                    d.kv.cache_pos[did] = hist
                elif d.kv.used(did) < hist:
                    # a round that accepted every draft: the draft never
                    # consumed the last drafted token, feed it (one short)
                    if hist - d.kv.used(did) != 1 or len(accepted) < 2:
                        raise AssertionError("draft history out of step")
                    d_slot.generated = [accepted[-2]]
                    _decode_one(d, did, accepted[-2])
                    stats.n_draft_calls += 1
                yield accepted[: n_predict - (n_out - len(accepted))]
                if t.eog_ids and accepted[-1] in t.eog_ids:
                    break
                if t.kv.used(tid) >= t.max_seq - self.n_draft - 2:
                    break
        finally:
            t_slot.state = SlotState.IDLE
            d_slot.state = SlotState.IDLE
