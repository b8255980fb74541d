"""The traffic generator: one multiset of gaps and lengths for every seed,
its clips, its due times."""

import numpy as np
import pytest

from benchmark.traffic import (percentile, quantiles_exponential, quantiles_lognormal,
                               schedule, tpot)

MIX = {"rate_rps": 2.0, "lead_in_s": 3.0, "prompt": {"median": 100, "sigma": 0.9, "min": 16,
                                                    "max": 400},
       "output": {"median": 40, "sigma": 0.7, "min": 8, "max": 90}, "greedy_share": 0.25}


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 12345, 987654321987])
def test_same_multiset_for_every_seed(seed):
    base = schedule(MIX, 5, 20.0, 1000)
    reqs = schedule(MIX, seed, 20.0, 1000)
    assert len(reqs) == len(base) == 6 + 40
    for f in (lambda r: len(r.prompt), lambda r: r.n_out):
        assert sorted(map(f, reqs)) == sorted(map(f, base))
    assert sum(r.greedy for r in reqs) == sum(r.greedy for r in base) == round(46 * 0.25)
    assert sum(r.in_window for r in reqs) == 40


def test_seeds_differ_and_repeat():
    a, b, c = (schedule(MIX, s, 20.0, 1000) for s in (1, 2, 1))
    assert [r.prompt for r in a] == [r.prompt for r in c]
    assert [r.due for r in a] == [r.due for r in c]
    assert [r.prompt for r in a] != [r.prompt for r in b]


def test_clips_and_token_range():
    reqs = schedule(MIX, 3, 20.0, 1000)
    assert all(16 <= len(r.prompt) <= 400 and 8 <= r.n_out <= 90 for r in reqs)
    assert all(0 <= t < 1000 for r in reqs for t in r.prompt)
    big = quantiles_lognormal(1000, 100, 0.9, 16, 400)
    assert big.min() == 16 and big.max() == 400
    assert abs(np.median(big) - 100) <= 1


def test_due_times_fill_lead_in_and_window():
    reqs = schedule(MIX, 4, 20.0, 1000)
    lead = [r.due for r in reqs if not r.in_window]
    win = [r.due for r in reqs if r.in_window]
    assert lead[0] == 0.0 and win[0] == 3.0
    assert all(0.0 <= t < 3.0 for t in lead) and all(3.0 <= t < 23.0 for t in win)
    assert lead == sorted(lead) and win == sorted(win)
    # the window's gaps, with the one to its end, fill its 20 s exactly
    gaps = np.diff(win + [23.0])
    assert np.isclose(gaps.sum(), 20.0)
    want = quantiles_exponential(40, 2.0)
    assert np.allclose(np.sort(gaps), np.sort(want * 20.0 / want.sum()))


@pytest.mark.parametrize("n", [4, 9, 22, 41])
def test_balanced_order_keeps_the_multiset_in_bands(n):
    from benchmark.traffic import balanced

    v = quantiles_lognormal(n, 100, 0.9, 16, 400)
    b = balanced(v, np.random.default_rng(n))
    assert sorted(b) == sorted(v)
    band = np.searchsorted(np.sort(v), b, side="right") - 1
    edges = [j * n // 4 for j in range(5)]
    for g in range(n // 4):  # each full group of four holds one of each quartile
        got = sorted(int(np.searchsorted(edges, i, side="right") - 1) for i in band[4 * g:4 * g + 4])
        assert got == [0, 1, 2, 3] or len(set(v)) < n


def test_exponential_quantiles():
    q = quantiles_exponential(4, 2.0)
    assert np.allclose(q, [-np.log(1 - p) / 2.0 for p in (0.125, 0.375, 0.625, 0.875)])


def test_p90_and_tpot_hand_worked():
    # ten values 1..10: rank 0.9 * 9 = 8.1 -> 9 + 0.1 * (10 - 9)
    assert percentile(list(range(1, 11)), 90) == pytest.approx(9.1)
    assert percentile([5.0], 90) == 5.0
    # first token at 2.0 s, fifth at 3.0 s: four gaps of 0.25 s
    assert tpot(2.0, 3.0, 5) == pytest.approx(0.25)
    assert tpot(2.0, 2.0, 1) is None
