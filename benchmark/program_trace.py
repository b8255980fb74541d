"""The program's own spans and the profiled sub-window's raw events: what
host.issue_ms, device.step_busy_ms, host.launches_per_step and
host.syncs_per_step read, and the breakdown's idle_by_span.

The program records spans at its layer boundaries (prima_tpu_torch/utils/
perf.py: worker.*, engine.*, decode.*, fwd.*) on the perf_counter clock,
and a recording converts them to the Unix-ns clock of torch.profiler's
events by the one offset it measured when it opened. Importing this
module (the readers of those metrics do) hooks the harness for traced
runs only:

- serve.serve turns the program's recorder on and keeps a recording of
  the run on `run.program` (then turns it back off), and once the run is
  over keeps the sub-window's raw events on the Profile (`raw`: kernels,
  copies and the CUDA API calls (cuda* and cu*), in Unix ns with their
  correlation ids) and the marker kernel's start (`base_ns`), which maps
  the harness's host seconds to Unix ns;
- serve._device_events hands the profiler's events on to it;
- measure.breakdown gains `idle_by_span`.

install() is a stopgap: a `benchmark` PR folds these three hooks into
serve.py (its Profiling thread and _device_events, in the one walk over
the profiler's events made there) and measure.py, and deletes them here.

An untraced run goes through unchanged. A program without the recorder
records nothing, and a recording that dropped spans is not read: the
readers return None and the breakdown has no idle_by_span.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import NamedTuple

from . import measure, serve

# CUDA API calls (cuda* and cu*) that put work on the device
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                   "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
# calls that hold the host until the device (or a stream or event) catches up
SYNC_CALLS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize", "cudaMemcpy",
              "cudaMemcpy2D", "cuMemcpy", "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2"}


class Event(NamedTuple):
    name: str
    t0: int  # Unix ns
    t1: int
    corr: int  # correlation id: a runtime call and the device work it enqueued
    device: str  # "cuda" (kernels, copies, sets) or "cpu" (the CUDA API calls)


def raw_events(events, stop_unix: int) -> tuple[list, int]:
    """(the profiler's `events` that start by `stop_unix`, the first device
    event's start), all in Unix ns."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        s = e.start_ns()
        if s > stop_unix:  # the drain's, most of the trace: one call each
            continue
        cuda = e.device_type() == DeviceType.CUDA
        name = e.name()
        if cuda or name.startswith("cu"):
            out.append(Event(name, s, s + e.duration_ns(), e.correlation_id(),
                             "cuda" if cuda else "cpu"))
    base = min((e.t0 for e in out if e.device == "cuda"), default=0)
    return out, base


def attach_raw(run) -> None:
    """The profiler's events that _device_events handed on (`kineto`), cut
    at the sub-window's end by the run's recording and kept as `raw` and
    `base_ns` on the Profile."""
    prof = run.rec.profile if run.rec is not None else None
    events = getattr(prof, "kineto", None)
    if events is None:
        return
    del prof.kineto
    prof.raw, prof.base_ns = raw_events(events,
                                        run.program.unix_ns(int(prof.t_stop * 1e9)))


# -- the hooks -------------------------------------------------------------------


def _program_perf():
    """The program's recorder module, or None where it has no recordings."""
    try:
        from prima_tpu_torch.utils import perf
    except ImportError:
        return None
    return perf if hasattr(perf, "recording") and hasattr(perf, "enable") else None


def install() -> None:
    if getattr(serve.serve, "program_trace", False):
        return
    orig_serve, orig_events, orig_breakdown = serve.serve, serve._device_events, \
        measure.breakdown

    def traced_serve(run, engine, tok, seed, trace, device, profile=True):
        perf = _program_perf() if trace else None
        if perf is None:
            return orig_serve(run, engine, tok, seed, trace, device, profile)
        was = perf.enable(True)
        try:
            with perf.recording() as rec:
                run.program = rec
                orig_serve(run, engine, tok, seed, trace, device, profile)
        finally:
            perf.enable(was)
        attach_raw(run)

    def device_events(prof, t_mark, t_stop):
        out = orig_events(prof, t_mark, t_stop)
        out.kineto = prof.profiler.kineto_results.events()
        return out

    def breakdown(run):
        out = orig_breakdown(run)
        if out is not None and _recording(run) is not None:
            out["idle_by_span"] = idle_by_span(run)
        return out

    traced_serve.program_trace = True
    serve.serve, serve._device_events, measure.breakdown = traced_serve, device_events, \
        breakdown


# -- the readings ----------------------------------------------------------------


def _recording(run):
    """The run's recording of the program's spans, None where there is none
    or it dropped spans (their readings would be of a part of the run)."""
    rec = getattr(run, "program", None)
    return None if rec is None or rec.dropped else rec


def _sub_window(run):
    """(recording, profile) of a traced run that has both, else None."""
    rec = _recording(run)
    prof = run.rec.profile if run.rec is not None else None
    if rec is None or prof is None or getattr(prof, "raw", None) is None:
        return None
    return rec, prof


def spans_in(rec, prof, name: str) -> list:
    """The sub-window's spans called `name` (it opens and closes between
    two of the worker's steps, so a span is in it whole or not at all)."""
    lo, hi = prof.t_start * 1e9, prof.t_stop * 1e9
    return [s for s in rec.spans if s.name == name and s.t0 >= lo and s.t1 <= hi]


def calls_inside(rec, calls: list, starts: list, span) -> list:
    """The runtime calls (sorted, `starts` their starts) that start inside
    `span`."""
    a, b = rec.unix_ns(span.t0), rec.unix_ns(span.t1)
    return calls[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]


def _runtime(prof) -> tuple[list, list]:
    calls = sorted((e for e in prof.raw if e.device == "cpu"), key=lambda e: e.t0)
    return calls, [c.t0 for c in calls]


def issue_ms(run) -> float | None:
    """host.issue_ms: the mean duration of the window's decode.issue spans."""
    rec = _recording(run)
    if rec is None:
        return None
    lo, hi = run.w0 * 1e9, run.w1 * 1e9
    d = [s.t1 - s.t0 for s in rec.spans if s.name == "decode.issue" and lo <= s.t0 < hi]
    return 1e-6 * sum(d) / len(d) if d else None


def issue_work(run) -> dict | None:
    """Per decode step of the sub-window: the device ms of the work whose
    runtime call lies inside a decode.issue span, those calls that launch
    work, and the kernels by name. None where no step fell in it."""
    sw = _sub_window(run)
    if sw is None:
        return None
    rec, prof = sw
    issue = spans_in(rec, prof, "decode.issue")
    if not issue:
        return None
    calls, starts = _runtime(prof)
    device = defaultdict(list)
    for e in prof.raw:
        if e.device == "cuda":
            device[e.corr].append(e)
    busy_ns, launches, kernels = 0, 0, Counter()
    for s in issue:
        for c in calls_inside(rec, calls, starts, s):
            launches += c.name.startswith(LAUNCH_PREFIXES)
            for k in device.get(c.corr, ()):
                busy_ns += k.t1 - k.t0
                kernels[k.name] += 1
    n = len(issue)
    return {"steps": n, "device_ms": 1e-6 * busy_ns / n, "launches": launches / n,
            "kernels": {k: v / n for k, v in kernels.items()}}


def step_busy_ms(run) -> float | None:
    w = issue_work(run)
    return None if w is None else w["device_ms"]


def launches_per_step(run) -> float | None:
    w = issue_work(run)
    return None if w is None else w["launches"]


def is_sync(calls: list, i: int, copies: dict) -> bool:
    """calls[i] holds the host: a synchronize, a blocking copy, or an
    asynchronous copy into pageable memory (which returns only once it is
    done) unless the next call is the synchronize that ends it."""
    name = calls[i].name
    if name in SYNC_CALLS:
        return True
    if name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" in name \
            and "Pageable" in copies.get(calls[i].corr, ""):
        return i + 1 == len(calls) or calls[i + 1].name not in SYNC_CALLS
    return False


def syncs_per_step(run) -> float | None:
    """host.syncs_per_step: the calls that hold the host inside the
    sub-window's engine.decode spans, over the decode steps they ran."""
    sw = _sub_window(run)
    if sw is None:
        return None
    rec, prof = sw
    decode = spans_in(rec, prof, "engine.decode")
    ids = {id(s) for s in decode}
    steps = sum(id(s.parent) in ids for s in spans_in(rec, prof, "decode.issue"))
    if not steps:
        return None
    calls, starts = _runtime(prof)
    copies = {e.corr: e.name for e in prof.raw if e.device == "cuda" and "Memcpy" in e.name}
    n = 0
    for s in decode:
        inside = calls_inside(rec, calls, starts, s)
        n += sum(is_sync(inside, i, copies) for i in range(len(inside)))
    return n / steps


def innermost(spans: list, times: list) -> list:
    """For each of the sorted `times`, the name of the innermost span
    covering it, or "outside" (the program's spans nest, one thread)."""
    spans = sorted(spans, key=lambda s: (s.t0, -s.t1))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i].t0 <= t:
            while stack and stack[-1].t1 < spans[i].t0:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].t1 < t:
            stack.pop()
        out.append(stack[-1].name if stack else "outside")
    return out


def idle_by_span(run) -> list | None:
    """The breakdown's idle gaps, each put to the innermost program span
    covering its midpoint: the top 10 [name, seconds]."""
    b = measure.device_busy(run)
    sw = _sub_window(run)
    if b is None or sw is None:
        return None
    rec, prof = sw
    _, _, merged = b
    edges = [prof.t_start] + [t for iv in merged for t in iv] + [prof.t_stop]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    # the gaps' host seconds are the marker's clock: back to Unix ns, then
    # to the spans' perf_counter ns
    base = prof.base_ns - rec.offset_ns  # the marker's start on the spans' clock
    to_span = lambda t: base + (t - prof.t_start) * 1e9
    mids = [to_span(0.5 * (g0 + g1)) for g0, g1 in gaps]
    order = sorted(range(len(gaps)), key=lambda i: mids[i])
    names = innermost(rec.spans, [mids[i] for i in order])
    idle: Counter = Counter()
    for i, name in zip(order, names):
        idle[name] += gaps[i][1] - gaps[i][0]
    return [[n, t] for n, t in idle.most_common(10)]


install()
