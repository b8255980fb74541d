"""Open-loop traffic from a mix file (traffic/<mix>.json) and a seed.

Arrivals are an open loop: exponential gaps at the mix's rate, prompt and
output lengths lognormal around their medians and clipped. Every seed
draws the same multiset of gaps and of lengths (each distribution's
quantiles at evenly spaced points); the seed only shuffles their order,
within bands so that every four consecutive requests hold one length and
one gap from each quartile (`balanced`), picks the prompt tokens and seeds
each request's sampler. So the seeds' tails rest on the same work, spread
alike over the window.

A lead-in of arrivals before the window fills the slots; the window's
requests are due inside [lead_in_s, lead_in_s + seconds).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

BANDS = 4  # the quartiles: every four consecutive requests hold one of each


@dataclass
class Request:
    index: int
    due: float  # seconds after the first request of the run was due
    prompt: list[int]
    n_out: int
    greedy: bool
    seed: int  # the sampler's seed
    in_window: bool


def quantiles_lognormal(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """n lengths: the lognormal's quantiles at (i + 0.5) / n, rounded and
    clipped to [lo, hi]."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def quantiles_exponential(n: int, rate: float) -> np.ndarray:
    """n gaps: the exponential's quantiles at (i + 0.5) / n."""
    return np.array([-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)])


def balanced(values: np.ndarray, rng, bands: int = BANDS) -> np.ndarray:
    """`values` in an order drawn from `rng` in which every run of `bands`
    consecutive entries holds one from each band of the sorted values
    (its quartiles, for four bands): the same multiset on every seed,
    shuffled without the bursts of long or short ones that a free
    permutation makes, which would make one seed's window far heavier
    than another's."""
    v = np.sort(values)
    groups = -(-len(v) // bands)
    strata = [rng.permutation(v[j * len(v) // bands:(j + 1) * len(v) // bands])
              for j in range(bands)]
    out = []
    for g in range(groups):
        row = [s[g] for s in strata if g < len(s)]
        out += [row[i] for i in rng.permutation(len(row))]
    return np.asarray(out)


def schedule(mix: dict, seed: int, seconds: float, n_vocab: int) -> list[Request]:
    """Every request of one run, in due order: the lead-in's, then the
    window's. The gaps of each part are rescaled to fill it exactly, so the
    window holds round(rate * seconds) requests on every seed."""
    rate, lead = mix["rate_rps"], mix["lead_in_s"]
    n_lead = max(1, round(rate * lead))
    n_win = max(1, round(rate * seconds))
    rng = np.random.default_rng(seed)
    due = []
    for n, span, t0 in ((n_lead, lead, 0.0), (n_win, seconds, lead)):
        gaps = balanced(quantiles_exponential(n, rate), rng)
        gaps = gaps * (span / gaps.sum())
        # the first request is due at the start of its part
        due += list(t0 + np.concatenate([[0.0], np.cumsum(gaps)[:-1]]))
    n = n_lead + n_win
    p, o = mix["prompt"], mix["output"]
    plen = balanced(quantiles_lognormal(n, p["median"], p["sigma"], p["min"], p["max"]), rng)
    olen = balanced(quantiles_lognormal(n, o["median"], o["sigma"], o["min"], o["max"]), rng)
    greedy = np.zeros(n, bool)
    greedy[rng.permutation(n)[: round(n * mix["greedy_share"])]] = True
    seeds = rng.integers(0, 2 ** 31 - 1, n)
    return [Request(i, float(due[i]), rng.integers(0, n_vocab, int(plen[i])).tolist(),
                    int(olen[i]), bool(greedy[i]), int(seeds[i]), i >= n_lead)
            for i in range(n)]


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between closest
    ranks (numpy's default)."""
    if not values:
        raise ValueError("percentile of nothing")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def tpot(first: float, last: float, n_tokens: int) -> float | None:
    """Time per output token after the first: (last - first) / (n - 1);
    None for a one-token answer."""
    return None if n_tokens < 2 else (last - first) / (n_tokens - 1)
