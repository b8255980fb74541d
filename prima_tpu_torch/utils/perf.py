"""Scoped timers (the reference's `timer(name)` RAII macro, src/llama.cpp:
105-118): disabled unless PRIMA_TIMER=1, accumulate per-name totals, print
on demand or at exit."""

from __future__ import annotations

import atexit
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

ENABLED = os.environ.get("PRIMA_TIMER", "0") == "1"

_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


@contextmanager
def timer(name: str):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _totals[name] += dt
        _counts[name] += 1


def report(file=sys.stderr) -> None:
    if not _totals:
        return
    width = max(len(n) for n in _totals)
    for name in sorted(_totals, key=lambda n: -_totals[n]):
        t, c = _totals[name], _counts[name]
        print(f"[timer] {name:<{width}} total {t*1e3:10.2f} ms  "
              f"calls {c:6d}  avg {t/c*1e3:8.3f} ms", file=file)


if ENABLED:
    atexit.register(report)
