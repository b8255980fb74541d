"""The port's span and counter recorder, with the reference's scoped
`timer(name)` (its RAII macro, src/llama.cpp:105-118) as one kind of span.

Off unless PRIMA_TIMER=1 or `enable()`: then `span()` returns one shared
no-op after a single flag test, and `count()` returns at once. On, every
span adds to its name's totals (`report()` prints them, at exit too under
PRIMA_TIMER=1), and while a consumer holds a `recording()` open each ended
span is kept there with its start and end, its parent and its attributes,
and each `count()` adds to the recording's counters.
Nothing is kept once the last recording closes, so a long-running server
under PRIMA_TIMER=1 does not grow.

Stamps are `time.perf_counter_ns()`; a recording measures the offset to
the Unix-ns clock when it opens (`Recording.unix_ns`), which is the base
of torch.profiler's events (`kineto_results.events()`: the CUDA runtime
calls and the kernels alike), so spans and device events share one clock
with no marker kernel.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

ENABLED = os.environ.get("PRIMA_TIMER", "0") == "1"

RECORDING_LIMIT = 2_000_000  # spans a recording keeps; later ones are only counted
OFFSET_SAMPLES = 7  # bracketed clock readings behind unix_offset_ns()

_totals: dict[str, float] = defaultdict(float)  # seconds per span name
_counts: dict[str, int] = defaultdict(int)  # ended spans per name
_recordings: tuple = ()  # the open Recordings (replaced, never mutated)
_local = threading.local()  # this thread's stack of open spans


def enable(on: bool = True) -> bool:
    """Turn the recorder on or off; returns the previous setting."""
    global ENABLED
    was, ENABLED = ENABLED, on
    return was


class Span:
    """One span: name, start and end (perf_counter ns), the span open
    around it on its thread (or None), and attributes."""

    __slots__ = ("name", "attrs", "parent", "t0", "t1")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.parent, self.t0, self.t1 = None, 0, 0

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent = stack[-1]
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        _local.stack.pop()
        _totals[self.name] += (self.t1 - self.t0) / 1e9
        _counts[self.name] += 1
        for r in _recordings:
            r.add(self)
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)


class _Off:
    """The span handed out while the recorder is off: does nothing, and is
    false, so a caller can skip computing attributes."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass

    def __bool__(self) -> bool:
        return False


OFF = _Off()


def span(name: str, **attrs):
    """`with span("engine.decode", rows=4) as s: ...`: a span called
    `name` with small attributes (ints), or OFF while the recorder is off.
    A hot path gives its attributes as `if s: s.set(rows=4)` instead, so
    that the off path builds no dict of them."""
    if not ENABLED:
        return OFF
    return Span(name, attrs)


def timer(name: str):
    """The reference's scoped timer: a span without attributes."""
    return span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of each open recording."""
    if not ENABLED:
        return
    for r in _recordings:
        r.counts[name] += n


def unix_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the tightest of
    OFFSET_SAMPLES bracketed readings."""
    best = None
    for _ in range(OFFSET_SAMPLES):
        p0 = time.perf_counter_ns()
        u = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, u - (p0 + p1) // 2)
    return best[1]


class Recording:
    """The spans that ended and the counts added while it was open, at
    most RECORDING_LIMIT spans (later ones are counted in `dropped`, and a
    reader of a recording that dropped any must not trust its spans)."""

    def __init__(self):
        self.limit = RECORDING_LIMIT
        self.spans: list[Span] = []
        self.dropped = 0
        self.counts: dict[str, int] = defaultdict(int)
        self.offset_ns = unix_offset_ns()

    def add(self, s: Span) -> None:
        if len(self.spans) < self.limit:
            self.spans.append(s)
        else:
            self.dropped += 1

    def unix_ns(self, t_ns: int) -> int:
        """A span's stamp on the Unix-ns clock of torch.profiler's events."""
        return t_ns + self.offset_ns


@contextmanager
def recording():
    """Keep the spans that end (and the counts added) until the block
    exits; the recorder must be on for anything to be recorded."""
    global _recordings
    rec = Recording()
    _recordings = _recordings + (rec,)
    try:
        yield rec
    finally:
        _recordings = tuple(r for r in _recordings if r is not rec)


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
