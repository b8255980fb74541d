"""Speculative decoding on the device: R rounds of draft + verify + accept
per host read-back.

Counterpart of prima_tpu/runtime/speculative_fused.py. The host decoder
(speculative.py) reads the logits back for every draft token and every
verify. Here one call runs up to R rounds with positions, accept counts,
the catch-up token and the output as device tensors, and reads the
tokens back once, as FusedGenerator does for plain decode
(runtime/generate.py). Each round is the draft's catch-up step and n_draft
greedy steps on its slot row, the target's forward over the chain
[cur, d_0 .. d_{k-1}] on its slot row, and the accept step.

Sampling follows the port's draw schedule: Gumbel-max noise from a
generator seeded by (request seed, token index), the noise of every index
a call can reach drawn before its rounds. So for every supported chain
(greedy, and bounded top-k without penalties, bias or grammar) the output
is token-identical to the port's plain fused stream. It differs from the
JAX package's stream, whose RNG differs.

Cache semantics (as speculative.py's host bookkeeping):
  * the target verifies the chain at cells T..T+k; only the accepted
    prefix advances its write index, and the cells past it, stale, are
    hidden by the causal mask (visibility follows the positions);
  * the draft's cells hold exactly the verified history; a round that
    accepts every draft leaves it one token short, fed by the catch-up
    step at the start of the next round (speculative.py);
  * a step that must not count (a draft step past the p_min cut, the
    catch-up step when nothing is missing, a round after the request is
    done) still runs and writes its cell at the unadvanced write index,
    past the valid history, where the next counted step overwrites it
    before anything reads it. The JAX package keeps the old cache row
    there instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sampling import Sampler, SamplerParams
from .engine import Engine, SlotState
from .generate import (MAX_TOPK, SlotSampleParams, batch_params, device_sample, gumbel_noise,
                       to_device)
from .speculative import SpecStats


def fused_spec_eligible(sampler: Sampler) -> bool:
    """Chains the on-device accept step supports draw for draw with the
    plain fused path: greedy, or bounded top-k without penalties, logit
    bias, grammar or mirostat (those take the host SpeculativeDecoder)."""
    p = sampler.p
    if sampler.grammar is not None or p.mirostat != 0 or p.logit_bias:
        return False
    if p.temp <= 0:
        return True
    if p.dynatemp_range > 0 or p.tfs_z < 1.0 or p.typ_p < 1.0:
        return False
    if p.penalty_last_n != 0 and (p.penalty_repeat != 1.0 or p.penalty_freq != 0.0
                                  or p.penalty_present != 0.0):
        return False
    return 0 < p.top_k <= MAX_TOPK


class FusedSpeculative:
    """Single-request on-device speculative rounds over two Engines, on one
    slot of each."""

    def __init__(self, target: Engine, draft: Engine, n_draft: int = 8,
                 p_min: float = 0.75, rounds: int = 8, force_accept: int = -1):
        self.t = target
        self.d = draft
        self.n_draft = int(n_draft)
        self.p_min = float(p_min)
        self.rounds = int(rounds)
        # force_accept >= 0 is a measurement-only mode: exactly
        # min(force_accept, n_valid) drafts count as matched, so the cost of
        # an acceptance level can be measured on random weights. Every
        # forward and sample still runs; the output tokens mean nothing.
        self.force_accept = int(force_accept)

    @torch.no_grad()
    def _rounds(self, sid_t: int, sid_d: int, st: dict, n_rounds: int, n_out0: int,
                p: SlotSampleParams, eog: torch.Tensor) -> torch.Tensor:
        """Run n_rounds rounds on the device from the state `st` (device
        tensors, updated in place of the dict) and return one int64 tensor
        [out (cap), out_n, tpos, dpos, rounds, n_drafted, n_accepted]."""
        t, d = self.t, self.d
        dev = t.device
        k, p_min = self.n_draft, self.p_min
        tc, dc = t.slot_row(sid_t), d.slot_row(sid_d)
        jpos = torch.arange(k + 1, device=dev)
        has_dist = p.temp > 0
        top_k = MAX_TOPK if has_dist else 0
        sp = batch_params([p] * (k + 1), 1, dev)
        recent = torch.full((k + 1, 1), -1, dtype=torch.int32, device=dev)
        cap = n_rounds * (k + 1)
        # the noise of every token index this call can reach, n_out0 + i
        noise = (gumbel_noise([p] * cap, [n_out0 + i for i in range(cap)], top_k, dev)
                 if has_dist else None)
        out = torch.full((cap + k + 1,), -1, dtype=torch.int64, device=dev)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        out_n, n_drafted, n_accepted, n_done = zero.clone(), zero.clone(), zero.clone(), \
            zero.clone()
        cur, tpos, dpos = st["cur"], st["tpos"], st["dpos"]
        ctok, ncatch, nleft = st["ctok"], st["ncatch"], st["nleft"]
        done = nleft <= 0
        for _ in range(n_rounds):
            # -- draft: the catch-up step, then k greedy steps ------------------
            feed, dpos_r, live = cur, dpos, torch.ones(1, dtype=torch.bool, device=dev)
            drafts = []
            for j in range(k + 1):
                x = ctok if j == 0 else feed
                logits, _ = d._fwd_raw(d.params, dc, x[:, None], dpos_r[:, None], dpos_r,
                                       dpos_r[:, None])
                if j == 0:
                    dpos_r = dpos_r + ncatch.int()
                    continue
                row = logits[0, -1].float()
                nxt = torch.argmax(row).reshape(1)
                maxp = torch.softmax(row, -1).max().reshape(1)
                # the first draft is always kept, later ones at >= p_min
                append = live & ((maxp >= p_min) if j > 1 else live)
                dpos_r = dpos_r + append.int()
                feed = torch.where(append, nxt, feed)
                drafts.append(torch.where(append, nxt, -1))
                live = append
            dt = torch.cat(drafts)  # (k,), -1 past the cut
            n_valid = (dt >= 0).sum().reshape(1).int()
            # -- verify: one target forward over the chain ----------------------
            chain = torch.cat([cur, dt.clamp(min=0)])
            positions = (tpos + jpos)[None].int()
            logits, _ = t._fwd_raw(t.params, tc, chain[None], positions, tpos, positions)
            lf = logits[0].float()  # (k + 1, V)
            # -- accept: every position sampled with the plain path's draws -----
            nk = None
            if has_dist:
                idx = (out_n.long() + jpos).clamp(max=cap - 1)
                nk = noise.index_select(0, idx)
            tok = device_sample(lf, recent, sp, top_k=top_k, has_pen=False,
                                has_dist=has_dist, has_free=False, noise_k=nk)
            valid = dt >= 0
            if self.force_accept >= 0:  # measurement only (see __init__)
                match = (jpos[:k] < self.force_accept) & valid
            else:
                match = (tok[:k] == dt) & valid
            can = torch.cat([torch.ones(1, dtype=torch.int64, device=dev),
                             torch.cumprod(match.long(), 0)])
            a = torch.minimum(can.sum().reshape(1).int(), nleft)
            # stop inside the accepted prefix at the first EOG
            eog_in = can.bool() & (tok[:, None] == eog[None, :]).any(-1) & (jpos < a)
            any_eog = eog_in.any().reshape(1)
            a = torch.where(any_eog, torch.argmax(eog_in.int()).reshape(1).int() + 1, a)
            a = torch.where(done, 0, a)
            live_r = ~done
            out.scatter_(0, out_n.long() + jpos, torch.where(jpos < a, tok, -1))
            cur = torch.where(live_r, tok.gather(0, (a.long() - 1).clamp(min=0)), cur)
            tpos = tpos + a
            # the draft needs cells T..T+a-1: one short after full acceptance
            full = (a == n_valid + 1) & live_r
            dpos = torch.where(live_r, torch.where(full, dpos_r, torch.minimum(dpos_r, tpos)),
                               dpos)
            catch = full & (n_valid > 0)
            ctok = torch.where(catch, dt.gather(0, (n_valid.long() - 1).clamp(min=0)),
                               torch.where(live_r, 0, ctok))
            ncatch = torch.where(live_r, catch, ncatch)
            out_n = out_n + a
            nleft = nleft - a
            n_drafted = n_drafted + torch.where(live_r, n_valid, 0)
            n_accepted = n_accepted + torch.where(live_r, a - 1, 0)
            n_done = n_done + live_r.int()
            done = done | any_eog | (nleft <= 0)
        st.update(cur=cur, tpos=tpos, dpos=dpos, ctok=ctok, ncatch=ncatch)
        return torch.cat([out[:cap], out_n.long(), tpos.long(), dpos.long(), n_done.long(),
                          n_drafted.long(), n_accepted.long()])

    def generate_stream(self, prompt_tokens: list[int], sampler: Sampler | None = None,
                        n_predict: int = 64, stats: SpecStats | None = None):
        """Yield the accepted tokens of each call (up to R rounds)."""
        sampler = sampler or Sampler(SamplerParams(temp=0.0))
        if not fused_spec_eligible(sampler):
            raise ValueError("this sampler chain takes the host SpeculativeDecoder")
        stats = stats if stats is not None else SpecStats()
        t, d = self.t, self.d
        t_slot = t.submit(prompt_tokens, sampler=sampler, n_predict=-1)
        d_slot = d.submit(prompt_tokens, n_predict=-1)
        sid_t, sid_d = t_slot.id, d_slot.id
        try:
            t.prefill_only(t_slot)
            d.prefill_only(d_slot)
            p = SlotSampleParams.from_sampler(sampler)
            dev = t.device
            eog = to_device(np.asarray(sorted(t.eog_ids) or [-2], np.int64), dev)
            st = {"cur": to_device(np.asarray(prompt_tokens[-1:], np.int64), dev),
                  "ctok": torch.zeros(1, dtype=torch.int64, device=dev),
                  "ncatch": torch.zeros(1, dtype=torch.bool, device=dev)}
            n_out = 0
            while n_out < n_predict:
                room = t.max_seq - t.kv.used(sid_t) - self.n_draft - 2
                if room <= 0:
                    break
                n_left = min(n_predict - n_out, room)
                st["tpos"], st["dpos"], st["nleft"] = to_device(
                    np.asarray([[t.kv.used(sid_t)], [d.kv.used(sid_d)], [n_left]], np.int32),
                    dev)
                # every live round yields a token: no more rounds than n_left
                n_rounds = min(self.rounds, n_left)
                res = self._rounds(sid_t, sid_d, st, n_rounds, n_out, p, eog).cpu().numpy()
                out_n, tpos, dpos, rounds, drafted, accepted = (int(v) for v in res[-6:])
                toks = [int(x) for x in res[:out_n]]
                t.kv.cache_pos[sid_t] = tpos
                d.kv.cache_pos[sid_d] = dpos
                stats.n_target_calls += rounds
                stats.n_draft_calls += rounds * self.n_draft
                stats.n_drafted += drafted
                stats.n_accepted += accepted
                for tk in toks:
                    sampler.accept(tk)
                    t_slot.generated.append(tk)
                n_out += len(toks)
                yield toks
                if not toks or (t.eog_ids and toks[-1] in t.eog_ids):
                    break
        finally:
            t_slot.state = SlotState.IDLE
            d_slot.state = SlotState.IDLE

    def generate(self, prompt_tokens: list[int], sampler: Sampler | None = None,
                 n_predict: int = 64) -> tuple[list[int], SpecStats]:
        stats = SpecStats()
        out: list[int] = []
        for chunk in self.generate_stream(prompt_tokens, sampler, n_predict, stats=stats):
            out.extend(chunk)
        return out[:n_predict], stats
