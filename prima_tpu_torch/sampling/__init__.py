"""Sampling stack: the full chain from the reference.

Semantics follow src/llama-sampling.cpp (samplers) and common/sampling.cpp
(gpt_sampler chain). Default chain order (common/common.h:129-136):
penalties -> top_k -> tail_free -> typical_p -> top_p -> min_p -> temperature
-> dist/greedy, with logit-bias applied first and an optional grammar
constraint between the chain and acceptance.

Samplers run on the host over a single token's logits (f32 vocab array) —
the same split as the reference (device computes logits, CPU samples).
A fused on-device path for common configs lives in runtime/generate.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

__all__ = ["SamplerParams", "Sampler", "softmax"]


@dataclass
class SamplerParams:
    """Mirror of gpt_sampler_params (common/common.h:107-158)."""

    seed: int = 0xFFFFFFFF  # LLAMA_DEFAULT_SEED = random
    n_prev: int = 64
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    tfs_z: float = 1.00
    typ_p: float = 1.00
    temp: float = 0.80
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    mirostat: int = 0  # 0 off, 1 v1, 2 v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    ignore_eos: bool = False
    min_keep: int = 1
    logit_bias: dict[int, float] = field(default_factory=dict)
    grammar: str = ""
    grammar_root: str = "root"


def softmax(logits: np.ndarray) -> np.ndarray:
    m = logits.max()
    e = np.exp(logits - m)
    return e / e.sum()


# -- individual samplers (operate in place on a (logits, candidate-ids) view) -


def apply_top_k(logits: np.ndarray, k: int) -> np.ndarray:
    """Returns candidate indices kept, sorted descending with ties broken
    by LOWER INDEX FIRST (stable sort) — the same tie order as
    jax.lax.top_k. Deterministic tie-breaking is load-bearing: the
    engine's device-shortlist path must select the identical candidate set
    whether it ranks the full row or the top-256 virtual row
    (np.argpartition would pick an arbitrary member of a tied boundary
    group depending on the rest of the array)."""
    n = logits.shape[0]
    order = np.argsort(-logits, kind="stable")
    if k <= 0 or k >= n:
        return order
    return order[:k]


def apply_top_p(logits: np.ndarray, ids: np.ndarray, p: float, min_keep: int) -> np.ndarray:
    if p >= 1.0:
        return ids
    probs = softmax(logits[ids])
    cum = np.cumsum(probs)
    # keep up to and including the token that crosses p
    cut = int(np.searchsorted(cum, p) + 1)
    cut = max(cut, min_keep)
    return ids[:cut]


def apply_min_p(logits: np.ndarray, ids: np.ndarray, p: float, min_keep: int) -> np.ndarray:
    if p <= 0.0 or len(ids) == 0:
        return ids
    probs = softmax(logits[ids])
    keep = probs >= p * probs[0]  # ids sorted desc -> probs[0] is max
    if keep.sum() < min_keep:
        return ids[:min_keep]
    return ids[keep]


def apply_tail_free(logits: np.ndarray, ids: np.ndarray, z: float, min_keep: int) -> np.ndarray:
    """Tail-free sampling (reference llama_sampler_tail_free): drop the
    low-curvature tail of the sorted probability distribution."""
    if z >= 1.0 or len(ids) <= 2:
        return ids
    probs = softmax(logits[ids])
    d2 = np.abs(np.diff(probs, n=2))
    s = d2.sum()
    if s > 1e-6:
        d2 = d2 / s
    else:
        d2 = np.full_like(d2, 1.0 / max(len(d2), 1))
    cum = np.cumsum(d2)
    cut = int(np.searchsorted(cum, z) + 1)
    cut = max(min(cut, len(ids)), min_keep)
    return ids[:cut]


def apply_typical(logits: np.ndarray, ids: np.ndarray, p: float, min_keep: int) -> np.ndarray:
    if p >= 1.0:
        return ids
    probs = softmax(logits[ids])
    ent = -np.sum(probs * np.log(np.maximum(probs, 1e-30)))
    shifted = np.abs(-np.log(np.maximum(probs, 1e-30)) - ent)
    order = np.argsort(shifted, kind="stable")
    cum = np.cumsum(probs[order])
    cut = int(np.searchsorted(cum, p) + 1)
    cut = max(cut, min_keep)
    return ids[order[:cut]]


def apply_temp(logits: np.ndarray, temp: float) -> np.ndarray:
    return logits / temp


def apply_temp_ext(logits: np.ndarray, ids: np.ndarray, temp: float,
                   delta: float, exponent: float) -> np.ndarray:
    """Dynamic-entropy temperature (llama_sampler_temp_ext)."""
    if delta <= 0 or len(ids) <= 1:
        return logits / max(temp, 1e-6)
    tmin, tmax = max(0.0, temp - delta), temp + delta
    probs = softmax(logits[ids])
    ent = -np.sum(probs * np.log(np.maximum(probs, 1e-30)))
    max_ent = np.log(len(ids))
    norm = ent / max_ent if max_ent > 0 else 0.0
    dyn = tmin + (tmax - tmin) * (norm ** exponent)
    return logits / max(dyn, 1e-6)


def apply_penalties(
    logits: np.ndarray,
    prev: Sequence[int],
    last_n: int,
    repeat: float,
    freq: float,
    present: float,
) -> None:
    """In place; mirrors llama_sampler_penalties."""
    if last_n == 0 or (repeat == 1.0 and freq == 0.0 and present == 0.0):
        return
    window = list(prev)[-last_n:] if last_n > 0 else list(prev)
    if not window:
        return
    counts: dict[int, int] = {}
    for t in window:
        counts[t] = counts.get(t, 0) + 1
    for t, c in counts.items():
        if logits[t] > 0:
            logits[t] /= repeat
        else:
            logits[t] *= repeat
        logits[t] -= freq * c + present


class Sampler:
    """The gpt_sampler analogue: chain + prev-token ring + RNG (+ grammar)."""

    def __init__(self, params: SamplerParams | None = None, n_vocab: int | None = None,
                 grammar=None):
        self.p = params or SamplerParams()
        seed = self.p.seed
        if seed == 0xFFFFFFFF:
            seed = np.random.SeedSequence().entropy & 0xFFFFFFFF
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.prev: list[int] = []
        self.n_vocab = n_vocab
        self.mu = 2.0 * self.p.mirostat_tau  # mirostat state
        self.grammar = grammar  # GrammarSampler or None

    def reset(self) -> None:
        self.rng = np.random.default_rng(self.seed)
        self.prev.clear()
        self.mu = 2.0 * self.p.mirostat_tau
        if self.grammar is not None:
            self.grammar.reset()

    def accept(self, token: int, accept_grammar: bool = True) -> None:
        self.prev.append(token)
        if len(self.prev) > max(self.p.n_prev, self.p.penalty_last_n, 1):
            self.prev.pop(0)
        if accept_grammar and self.grammar is not None:
            self.grammar.accept(token)

    def _dist(self, logits: np.ndarray, ids: np.ndarray) -> int:
        # float64 renormalize: Generator.choice rejects float32 rounding
        # residue in the sum-to-1 check
        probs = softmax(logits[ids]).astype(np.float64)
        probs /= probs.sum()
        return int(ids[self.rng.choice(len(ids), p=probs)])

    def sample(self, logits: np.ndarray) -> int:
        p = self.p
        logits = np.asarray(logits, dtype=np.float32).copy()
        for t, b in p.logit_bias.items():
            logits[t] += b

        apply_penalties(logits, self.prev, p.penalty_last_n,
                        p.penalty_repeat, p.penalty_freq, p.penalty_present)

        if self.grammar is not None:
            # fast path (gpt_sampler_sample, common/sampling.cpp): sample
            # unconstrained first; only build the grammar mask on rejection
            tok = self._sample_chain(logits.copy())
            if self.grammar.accepts(tok):
                return tok
            self.grammar.apply(logits)

        return self._sample_chain(logits)

    def _sample_chain(self, logits: np.ndarray) -> int:
        p = self.p
        if p.mirostat == 2:
            return self._mirostat_v2(logits)
        if p.mirostat == 1:
            return self._mirostat_v1(logits)

        if p.temp <= 0:
            return int(np.argmax(logits))

        ids = apply_top_k(logits, p.top_k)
        ids = apply_tail_free(logits, ids, p.tfs_z, p.min_keep)
        ids = apply_typical(logits, ids, p.typ_p, p.min_keep)
        # typical may reorder; re-sort descending for top_p/min_p semantics
        ids = ids[np.argsort(-logits[ids], kind="stable")]
        ids = apply_top_p(logits, ids, p.top_p, p.min_keep)
        ids = apply_min_p(logits, ids, p.min_p, p.min_keep)
        logits = apply_temp_ext(logits, ids, p.temp, p.dynatemp_range, p.dynatemp_exponent)
        return self._dist(logits, ids)

    def sample_and_accept(self, logits: np.ndarray) -> int:
        tok = self.sample(logits)
        self.accept(tok)
        return tok

    def _mirostat_v2(self, logits: np.ndarray) -> int:
        p = self.p
        logits = logits / max(p.temp, 1e-6)
        ids = np.argsort(-logits, kind="stable")
        probs = softmax(logits[ids])
        surprise = -np.log2(np.maximum(probs, 1e-30))
        keep = surprise <= self.mu
        if not keep.any():
            keep[0] = True
        ids, probs = ids[keep], probs[keep]
        probs = probs.astype(np.float64)
        probs = probs / probs.sum()
        j = int(self.rng.choice(len(ids), p=probs))
        tok = int(ids[j])
        observed = -np.log2(max(probs[j], 1e-30))
        self.mu -= p.mirostat_eta * (observed - p.mirostat_tau)
        return tok

    def _mirostat_v1(self, logits: np.ndarray, m: int = 100) -> int:
        p = self.p
        n_vocab = self.n_vocab or logits.shape[0]
        logits = logits / max(p.temp, 1e-6)
        ids = np.argsort(-logits, kind="stable")
        probs = softmax(logits[ids])
        # estimate Zipf exponent s_hat from the top-m tokens
        num = den = 0.0
        for i in range(min(m - 1, len(probs) - 1)):
            t_i = np.log((i + 2) / (i + 1))
            b_i = np.log(max(probs[i], 1e-30) / max(probs[i + 1], 1e-30))
            num += t_i * b_i
            den += t_i * t_i
        s_hat = num / den if den > 0 else 1.0
        eps = s_hat - 1.0
        k = ((eps * (2 ** self.mu)) / (1 - float(n_vocab) ** -eps)) ** (1 / s_hat) \
            if abs(eps) > 1e-9 else float(len(ids))
        k = int(np.clip(k, 1, len(ids)))
        ids, probs = ids[:k], probs[:k]
        probs = probs.astype(np.float64)
        probs = probs / probs.sum()
        j = int(self.rng.choice(len(ids), p=probs))
        tok = int(ids[j])
        observed = -np.log2(max(probs[j], 1e-30))
        self.mu -= p.mirostat_eta * (observed - p.mirostat_tau)
        return tok
