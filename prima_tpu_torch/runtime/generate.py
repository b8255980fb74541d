"""On-device sampling and the chunked decode loop.

Counterpart of prima_tpu/runtime/generate.py. The chunk loop decodes and
samples on the device and reads the tokens back once per chunk.

Covered on the device (see `fused_eligible`): logit bias, the repeat /
frequency / presence penalties over the last-n window, top-k, top-p,
min-p, temperature, greedy and the final draw. The kept-candidate set is
the host Sampler chain's (sampling/__init__.py). The draw is a Gumbel-max
over noise from a torch.Generator seeded by (request seed, token index)
only, so a request's stream never depends on which path or which other
slots a step went through; it differs from the JAX package's PRNG.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..sampling import Sampler

MAX_TOPK = 256  # device top-k bound
NEG_INF = -1e30


def fused_eligible(sampler: Sampler) -> bool:
    """True iff this slot's chain runs on the device with the host chain's
    candidate set (grammar, mirostat, dynatemp, tail-free, typical and
    unbounded top-k with filters stay on the host)."""
    p = sampler.p
    if sampler.grammar is not None or p.mirostat != 0:
        return False
    if p.temp <= 0:
        return True
    if p.dynatemp_range > 0 or p.tfs_z < 1.0 or p.typ_p < 1.0:
        return False
    if 0 < p.top_k <= MAX_TOPK:
        return True
    return p.top_p >= 1.0 and p.min_p <= 0.0


@dataclass
class SlotSampleParams:
    """Per-slot sampler parameters, batched into device tensors."""

    temp: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    min_keep: int = 1
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    seed: int = 0

    @classmethod
    def from_sampler(cls, s: Sampler) -> "SlotSampleParams":
        p = s.p
        return cls(temp=p.temp, top_k=p.top_k, top_p=p.top_p, min_p=p.min_p,
                   min_keep=max(p.min_keep, 1), penalty_last_n=p.penalty_last_n,
                   penalty_repeat=p.penalty_repeat, penalty_freq=p.penalty_freq,
                   penalty_present=p.penalty_present, seed=s.seed)

    def penalties_active(self) -> bool:
        return self.penalty_last_n != 0 and (
            self.penalty_repeat != 1.0 or self.penalty_freq != 0.0
            or self.penalty_present != 0.0)

    def bounded(self) -> bool:
        return 0 < self.top_k <= MAX_TOPK


def batch_params(params: list, recent_cap: int, device) -> dict:
    """(B,) device tensors of the per-slot parameters; None rows are
    parked and get neutral values."""
    rows = [p or SlotSampleParams(temp=0.0) for p in params]
    f32 = lambda name: torch.tensor([getattr(p, name) for p in rows],
                                    dtype=torch.float32, device=device)
    i32 = lambda vals: torch.tensor(vals, dtype=torch.int32, device=device)
    sp = {n: f32(n) for n in ("temp", "top_p", "min_p", "penalty_repeat",
                              "penalty_freq", "penalty_present")}
    sp["top_k"] = i32([p.top_k if p.bounded() else MAX_TOPK + 1 for p in rows])
    sp["min_keep"] = i32([max(p.min_keep, 1) for p in rows])
    sp["eff_last_n"] = i32([eff_last_n(p, recent_cap) for p in rows])
    return sp


def eff_last_n(p: SlotSampleParams, recent_cap: int) -> int:
    """The penalty window length the device ring holds."""
    ln = p.penalty_last_n
    return max(recent_cap if ln < 0 else min(ln, recent_cap), 1)


def gumbel_noise(params: list, counts, width: int, device) -> torch.Tensor:
    """(B, width) Gumbel noise; row b comes from a generator seeded by
    (seed, counts[b]) alone, zeros for rows that do not draw."""
    out = torch.zeros((len(params), width), dtype=torch.float32, device=device)
    for b, p in enumerate(params):
        if p is None or p.temp <= 0:
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed(((p.seed & 0xFFFFFFFF) << 31) | (int(counts[b]) & 0x7FFFFFFF))
        u = torch.rand(width, generator=gen, device=device)
        out[b] = -torch.log(-torch.log(u))
    return out


def penalize(logits: torch.Tensor, recent: torch.Tensor, sp: dict) -> torch.Tensor:
    """Repeat / frequency / presence penalties over the window `recent`
    (B, P) int32, -1 marking empty cells (llama_sampler_penalties)."""
    valid = recent >= 0
    counts = torch.zeros_like(logits).scatter_add_(
        1, torch.where(valid, recent, 0).long(), valid.float())
    rep = sp["penalty_repeat"][:, None]
    hit = counts > 0
    logits = torch.where(hit, torch.where(logits > 0, logits / rep, logits * rep), logits)
    logits = logits - counts * sp["penalty_freq"][:, None]
    return logits - hit.float() * sp["penalty_present"][:, None]


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties broken by the lower index (the host
    chain's apply_top_k order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def candidates(logits: torch.Tensor, sp: dict, top_k: int):
    """(vals, ids, keep) of the top-k / top-p / min-p chain over the
    already biased and penalized logits (B, V); vals sorted descending."""
    vals, idx = stable_topk(logits, min(top_k, logits.shape[-1]))
    rank = torch.arange(vals.shape[-1], device=logits.device)[None, :]
    in_k = rank < sp["top_k"][:, None]
    vals = torch.where(in_k, vals, NEG_INF)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # top-p keeps position i iff cum[i-1] < p; min_keep first always
    keep_tp = ((cum - probs) < sp["top_p"][:, None]) & in_k
    keep_tp |= (rank < sp["min_keep"][:, None]) & in_k
    # min-p: the ratio to the max prob is invariant to renormalization
    keep_mp = probs >= sp["min_p"][:, None] * probs[:, :1]
    keep = keep_tp & keep_mp
    # fewer than min_keep survivors: the first min_keep top-p survivors
    tp_rank = torch.cumsum(keep_tp.int(), dim=-1)
    fallback = keep_tp & (tp_rank <= sp["min_keep"][:, None])
    enough = keep.sum(dim=-1, keepdim=True) >= sp["min_keep"][:, None]
    return vals, idx, torch.where(enough, keep, fallback)


def device_sample(logits: torch.Tensor, recent: torch.Tensor, sp: dict, *,
                  top_k: int, has_pen: bool, has_dist: bool, has_free: bool,
                  noise_k: torch.Tensor | None = None,
                  noise_v: torch.Tensor | None = None,
                  bias: tuple | None = None) -> torch.Tensor:
    """One batched sample step: logits (B, V) -> (B,) int64 tokens.
    top_k is the static draw width (MAX_TOPK when any row is bounded);
    noise_k (B, top_k) / noise_v (B, V) are the rows' Gumbel noise."""
    logits = logits.float()
    if bias is not None:
        logits = logits.clone()
        logits[:, bias[0]] += bias[1]
    if has_pen:
        logits = penalize(logits, recent, sp)
    greedy_tok = torch.argmax(logits, dim=-1)
    if not has_dist:
        return greedy_tok
    temp = torch.clamp(sp["temp"], min=1e-6)[:, None]
    dist_tok = None
    if top_k > 0:
        vals, idx, keep = candidates(logits, sp, top_k)
        masked = torch.where(keep, vals / temp, NEG_INF)
        j = torch.argmax(masked + noise_k, dim=-1, keepdim=True)
        dist_tok = idx.gather(1, j)[:, 0]
    if has_free or top_k == 0:
        free_tok = torch.argmax(logits / temp + noise_v, dim=-1)
        free_row = sp["top_k"] > MAX_TOPK
        dist_tok = free_tok if dist_tok is None else torch.where(free_row, free_tok, dist_tok)
    return torch.where(sp["temp"] <= 0, greedy_tok, dist_tok)


def fill_recent_ring(row: np.ndarray, toks, ln: int) -> None:
    """Last-`ln` history in ring order: token a lives at a % ln, so the
    next write (at recent_n % ln) evicts the oldest entry."""
    n = len(toks)
    for a in range(max(0, n - ln), n):
        row[a % ln] = toks[a]


def _bias(logit_bias: dict | None, device):
    if not logit_bias:
        return None
    return (torch.tensor(list(logit_bias.keys()), dtype=torch.long, device=device),
            torch.tensor([float(v) for v in logit_bias.values()], dtype=torch.float32,
                         device=device))


def _flags(params: list) -> tuple[int, bool, bool, bool]:
    """(top_k draw width, has_pen, has_dist, has_free) of a batch."""
    live = [p for p in params if p is not None]
    dist = [p for p in live if p.temp > 0]
    top_k = MAX_TOPK if any(p.bounded() for p in dist) else 0
    return (top_k, any(p.penalties_active() for p in live), bool(dist),
            any(not p.bounded() for p in dist))


def sample_one(row, p: SlotSampleParams, recent_tokens, gen_count: int,
               logit_bias: dict | None = None, recent_cap: int = 256,
               shortlist=None, device="cpu") -> int:
    """Draw one token for one slot with the chunk loop's semantics and
    noise, from a logits row or a top-k shortlist (vals, ids, n_vocab) —
    so Engine.step and Engine.step_fused give one stream per seed."""
    if shortlist is None:
        logits = torch.as_tensor(np.asarray(row, np.float32), device=device)[None]
    else:
        vals, ids, v = shortlist
        logits = torch.full((1, int(v)), NEG_INF, dtype=torch.float32, device=device)
        logits[0, torch.as_tensor(np.asarray(ids, np.int64), device=device)] = \
            torch.as_tensor(np.asarray(vals, np.float32), device=device)
    v = logits.shape[-1]
    top_k, has_pen, has_dist, has_free = _flags([p])
    sp = batch_params([p], recent_cap, device)
    recent = np.full((1, recent_cap), -1, np.int32)
    if has_pen and recent_tokens:
        fill_recent_ring(recent[0], list(recent_tokens), eff_last_n(p, recent_cap))
    tok = device_sample(
        logits, torch.as_tensor(recent, device=device), sp, top_k=top_k,
        has_pen=has_pen, has_dist=has_dist, has_free=has_free,
        noise_k=gumbel_noise([p], [gen_count], MAX_TOPK, device) if top_k else None,
        noise_v=gumbel_noise([p], [gen_count], v, device) if has_free else None,
        bias=_bias(logit_bias, device))
    return int(tok[0])


class FusedGenerator:
    """Chunked decode bound to a batched decode step.

    fwd(params, caches, token (B,1), cache_pos (B,), rope_pos (B,)) ->
    (logits (B, V), caches), the Engine's decode body. Parked rows
    (slot_params[b] is None) keep their token and write position: their KV
    write lands in one unused cell per step, so the caller must hand them
    in with cache_pos[b] < max_seq.
    """

    def __init__(self, fwd, device, chunk: int = 16, recent_cap: int = 256):
        self.fwd = fwd
        self.device = device
        self.chunk = chunk
        self.recent_cap = recent_cap

    def generate(self, params, caches, token: np.ndarray, cache_pos: np.ndarray,
                 rope_delta: np.ndarray, slot_params: list, recent_tokens: list,
                 n_left: np.ndarray, gen_count: np.ndarray,
                 logit_bias: dict | None = None, chunk: int | None = None,
                 eog_ids=(), probs_k: int = 0):
        """Run up to `chunk` decode + sample steps on the device. Returns
        (caches, tokens (B, chunk) with -1 on parked steps, new cache_pos
        (B,), lp) where lp is None or (top vals, top ids, logsumexp,
        sampled-token logit) as numpy arrays for logprobs."""
        dev = self.device
        b = token.shape[0]
        chunk = chunk or self.chunk
        top_k, has_pen, has_dist, has_free = _flags(slot_params)
        sp = batch_params(slot_params, self.recent_cap, dev)
        recent = np.full((b, self.recent_cap), -1, np.int32)
        recent_n = np.zeros((b,), np.int32)
        if has_pen:
            for i, toks in enumerate(recent_tokens):
                p = slot_params[i]
                if p is not None and toks and p.penalties_active():
                    fill_recent_ring(recent[i], toks, eff_last_n(p, self.recent_cap))
                    recent_n[i] = len(toks)
        recent_t = torch.as_tensor(recent, device=dev)
        recent_n_t = torch.as_tensor(recent_n, device=dev)
        bias = _bias(logit_bias, dev)
        eog = torch.as_tensor(np.fromiter(eog_ids, np.int64) if len(eog_ids)
                              else np.asarray([-2], np.int64), device=dev)
        live0 = np.asarray([p is not None for p in slot_params])
        done = torch.as_tensor(~live0, device=dev)
        tok_t = torch.as_tensor(token.astype(np.int64), device=dev)
        pos_t = torch.as_tensor(cache_pos.astype(np.int32), device=dev)
        delta_t = torch.as_tensor(rope_delta.astype(np.int32), device=dev)
        left_t = torch.as_tensor(n_left.astype(np.int32), device=dev)
        out = torch.full((b, chunk), -1, dtype=torch.int64, device=dev)
        lp = ((torch.zeros((b, chunk, probs_k), device=dev),
               torch.zeros((b, chunk, probs_k), dtype=torch.int64, device=dev),
               torch.zeros((b, chunk), device=dev), torch.zeros((b, chunk), device=dev))
              if probs_k else None)
        # no row outlives its n_left; an eog stop only parks its row, so
        # the loop needs no host sync per step
        steps = min(chunk, int(max(n_left[live0], default=0)))
        for i in range(steps):
            logits, caches = self.fwd(params, caches, tok_t, pos_t, pos_t + delta_t)
            counts = gen_count + i  # each live row's absolute draw index
            tok = device_sample(
                logits, recent_t, sp, top_k=top_k, has_pen=has_pen,
                has_dist=has_dist, has_free=has_free, bias=bias,
                noise_k=gumbel_noise(slot_params, counts, top_k, dev) if top_k else None,
                noise_v=(gumbel_noise(slot_params, counts, logits.shape[-1], dev)
                         if has_free else None))
            if probs_k:
                lf = logits.float()
                pv, pi = torch.topk(lf, probs_k, dim=-1)
                lp[0][:, i], lp[1][:, i] = pv, pi
                lp[2][:, i] = torch.logsumexp(lf, dim=-1)
                lp[3][:, i] = lf.gather(1, tok[:, None])[:, 0]
            live = ~done
            tok_t = torch.where(live[:, None], tok[:, None], tok_t)
            out[:, i] = torch.where(live, tok, -1)
            if has_pen:
                ln = sp["eff_last_n"]
                wix = (recent_n_t % ln).long()
                new_rec = recent_t.scatter(1, wix[:, None], tok[:, None].to(torch.int32))
                recent_t = torch.where(live[:, None], new_rec, recent_t)
                recent_n_t = recent_n_t + live.int()
            pos_t = pos_t + live.int()
            left_t = left_t - live.int()
            is_eog = (tok[:, None] == eog[None, :]).any(dim=-1)
            done = done | (left_t <= 0) | (live & is_eog)
        toks = out.cpu().numpy()
        new_pos = pos_t.cpu().numpy()
        if probs_k:
            lp = tuple(a.cpu().numpy() for a in lp)
        return caches, toks, new_pos, lp
