"""What the metric readers (metrics/<name>.py) read from a run.

End-to-end readings come from the host's clock: a request's due time and
the times its events were put on its queue. Per-layer readings come from
the benchmark's spans, the program's counters (Engine.perf, the kernel
LaunchCounters) and the device trace. A request that errors or is not
finished when the run stops draining counts in each tail with the time
it waited until then.
"""

from __future__ import annotations

import bisect
from collections import Counter

from .roofline import (device_ops, gemv_weight_bytes, gemv_work, kind_of, least_time,
                       union_seconds)
from .serve import Run, Served, finished, token_stamps
from .traffic import percentile, tpot


def ttft_s(run: Run, s: Served) -> float:
    st = token_stamps(s)
    return (st[0] if st and finished(s) else run.t_end) - s.due


def tpot_s(run: Run, s: Served) -> float:
    st = token_stamps(s)
    if not finished(s):
        return run.t_end - s.due
    return tpot(st[0], st[-1], len(st)) or 0.0


def window_p90_ms(run: Run, fn) -> float:
    return window_pct_ms(run, fn, 90)


def window_pct_ms(run: Run, fn, q: float) -> float:
    """The q-th percentile of fn over the requests due in the window, in ms."""
    return 1e3 * percentile([fn(run, s) for s in run.window()], q)


def itl_gaps_s(run: Run) -> list[float]:
    """Every gap between two token events of a request due in the window;
    a request that did not finish adds the gap from its last event to the
    run's end."""
    out = []
    for s in run.window():
        st = token_stamps(s)
        out += [b - a for a, b in zip(st, st[1:])]
        if not finished(s):
            out.append(run.t_end - (st[-1] if st else s.due))
    return out


def itl_mean_ms(run: Run) -> float:
    """The mean of every inter-token gap of the window's requests, in ms."""
    gaps = itl_gaps_s(run)
    return 1e3 * sum(gaps) / len(gaps)


def latencies(run: Run) -> dict:
    """The latency statistics a run can give beside its metrics, in ms."""
    gaps = itl_gaps_s(run)
    return {"ttft_p50_ms": window_pct_ms(run, ttft_s, 50),
            "ttft_p90_ms": window_pct_ms(run, ttft_s, 90),
            "tpot_p50_ms": window_pct_ms(run, tpot_s, 50),
            "tpot_p90_ms": window_pct_ms(run, tpot_s, 90),
            "itl_mean_ms": itl_mean_ms(run) if gaps else None,
            "itl_p90_ms": 1e3 * percentile(gaps, 90) if gaps else None,
            "itl_p99_ms": 1e3 * percentile(gaps, 99) if gaps else None}


def output_tok_s(run: Run) -> float:
    n = sum(1 for s in run.served for t in token_stamps(s) if run.w0 <= t < run.w1)
    return n / run.seconds


def spans_in_window(run: Run, name: str) -> list:
    return [s for s in run.rec.spans if s.name == name and run.w0 <= s.t0 < run.w1]


def launch_bytes(span) -> float | None:
    """The weight bytes the span's GEMV launches read, or None where it
    made none (the dense route)."""
    if not span.launches:
        return None
    return sum(gemv_weight_bytes(l.n, l.k, l.ggml_type, l.distinct) for l in span.launches)


def decode_calls(run: Run) -> list:
    return [s for s in spans_in_window(run, "decode call") if s.info["steps"] > 0]


def decode_step_ms(run: Run) -> float | None:
    calls = decode_calls(run)
    steps = sum(s.info["steps"] for s in calls)
    if not steps:
        return None
    return 1e3 * sum(s.t1 - s.t0 - s.info["prompt_s"] for s in calls) / steps


def decode_mfu(run: Run) -> float | None:
    calls = decode_calls(run)
    wall = sum(s.t1 - s.t0 - s.info["prompt_s"] for s in calls)
    if not calls or wall <= 0:
        return None
    least = sum(run.cost.decode_steps(s.info["visible"], s.info["steps"], launch_bytes(s))
                for s in calls)
    return 100.0 * least / wall


def prefill_tok_s(run: Run) -> float | None:
    dt = run.perf1["t_prompt_s"] - run.perf0["t_prompt_s"]
    return None if dt <= 0 else (run.perf1["n_prompt"] - run.perf0["n_prompt"]) / dt


def prefill_mfu(run: Run) -> float | None:
    dt = run.perf1["t_prompt_s"] - run.perf0["t_prompt_s"]
    chunks = [s for s in spans_in_window(run, "prefill") if s.t1 < run.w1]
    if dt <= 0 or not chunks:
        return None
    least = sum(run.cost.prefill_chunk(s.info["rows"], s.info["pos0"], launch_bytes(s))
                for s in chunks)
    return 100.0 * least / dt


def kernel_roofline(run: Run, kind: str) -> float | None:
    """Least seconds of the profiled launches of `kind` over the profiled
    device seconds of its kernels, in percent."""
    prof = run.rec.profile if run.rec else None
    if prof is None:
        return None
    t = sum(e - s for n, s, e in prof.events if kind_of(n) == kind)
    launches = [l for l in run.rec.launches if l.profiled and l.kind == kind]
    if t <= 0 or not launches:
        return None
    return 100.0 * sum(least_time(*gemv_work(l.b, l.n, l.k, l.ggml_type, l.distinct))
                       for l in launches) / t


def device_busy(run: Run) -> tuple[float, float, list] | None:
    """(busy seconds, window seconds, merged busy intervals) of the
    profiled sub-window."""
    prof = run.rec.profile if run.rec else None
    if prof is None or not prof.events:
        return None
    clip = [(max(s, prof.t_start), min(e, prof.t_stop)) for _, s, e in prof.events]
    busy, merged = union_seconds([(s, e) for s, e in clip if e > s])
    return busy, prof.t_stop - prof.t_start, merged


def idle_share(run: Run) -> float | None:
    b = device_busy(run)
    return None if b is None else 100.0 * (1.0 - b[0] / b[1])


# what the host was inside while the device idled: the innermost span
LABELS = {"admit": "admit", "prefill": "prefill", "decode issue": "decode issue",
          "read-back": "read-back", "step": "decode host", "decode call": "decode host",
          "emit": "emit"}


def breakdown(run: Run) -> dict | None:
    b = device_busy(run)
    if b is None:
        return None
    prof = run.rec.profile
    _, _, merged = b
    edges = [prof.t_start] + [t for iv in merged for t in iv] + [prof.t_stop]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = sorted((s for s in run.rec.spans if s.t1 >= prof.t_start and s.t0 <= prof.t_stop),
                   key=lambda s: s.t0)
    starts = [s.t0 for s in spans]
    idle: Counter = Counter()
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label = "worker loop"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if spans[i].t1 >= mid:
                label = LABELS[spans[i].name]
                break
        idle[label] += g1 - g0
    return {"device_ops": device_ops(prof.events),
            "idle_gaps": [[n, t] for n, t in idle.most_common(10)]}
