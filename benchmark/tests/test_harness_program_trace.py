"""The readers of the program's own spans on hand-made span and event lists:
host.issue_ms, device.step_busy_ms (attribution by correlation id),
host.launches_per_step, host.syncs_per_step (a copy and the synchronize
that ends it count once), the breakdown's idle_by_span (innermost span of
each gap, `outside` where none covers it), a sub-window without a decode
step and a recording that dropped spans (None), the profiler's events cut
at the sub-window's end, and a traced run on the CPU with and without the
program's recorder."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import measure, program_trace as pt, serve, spec
from benchmark.program_trace import Event
from benchmark.run import run_cell
from benchmark.serve import Profile, Recorder, Run

OFF = 10 ** 12  # the spans' clock to Unix ns
T = 10 * 10 ** 9  # the sub-window's start, perf_counter ns
MS = 10 ** 6


class Rec:
    """A recording as the program keeps one."""

    def __init__(self, spans):
        self.spans, self.offset_ns, self.dropped = spans, OFF, 0

    def unix_ns(self, t):
        return t + OFF


def _span(name, a_ms, b_ms, parent=None, **attrs):
    return SimpleNamespace(name=name, t0=T + int(a_ms * MS), t1=T + int(b_ms * MS),
                           parent=parent, attrs=attrs)


def _call(name, at_ms, corr):
    t = T + OFF + int(at_ms * MS)
    return Event(name, t, t + 5_000, corr, "cpu")


def _dev(name, a_ms, b_ms, corr):
    return Event(name, T + OFF + int(a_ms * MS), T + OFF + int(b_ms * MS), corr, "cuda")


def _run(spans, raw, w=(9.0, 11.0)):
    run = Run({}, {}, 2.0, None, 0.0, w0=w[0], w1=w[1])
    run.rec = Recorder()
    marker = raw[0]
    events = [(e.name, 10.0 + (e.t0 - marker.t0) / 1e9, 10.0 + (e.t1 - marker.t0) / 1e9)
              for e in raw[1:] if e.device == "cuda"]
    prof = Profile(10.0, 10.010, events)
    prof.raw, prof.base_ns = raw, marker.t0
    run.rec.profile = prof
    run.program = Rec(spans)
    return run


def _scene():
    dec = _span("engine.decode", 1, 7, rows=2, steps=2, cells=10)
    i0 = _span("decode.issue", 1.1, 3.0, dec, step=0)
    i1 = _span("decode.issue", 3.0, 5.0, dec, step=1)
    spans = [dec, i0, i1, _span("fwd.attn", 1.2, 2.4, i0, layer=0),
             _span("decode.sample", 2.5, 2.95, i0), _span("decode.readback", 5.5, 6.8, dec),
             _span("worker.emit", 7.1, 7.5)]
    raw = [_dev("fill", 0, 0.001, 100),  # the marker
           _call("cudaLaunchKernel", 1.3, 1), _dev("qgemv_mma<1>", 1.4, 1.5, 1),
           _call("cudaLaunchKernel", 2.52, 2), _dev("elementwise", 2.55, 2.6, 2),
           _call("cudaLaunchKernel", 3.2, 3), _dev("qgemv_mma<1>", 3.25, 3.55, 3),
           _call("cudaStreamIsCapturing", 3.3, 4),
           _call("cudaMemcpyAsync", 3.4, 5), _dev("Memcpy HtoD (Pageable -> Device)", 3.41,
                                                  3.42, 5),
           _call("cudaStreamSynchronize", 3.43, 6),
           _call("cudaMemcpyAsync", 5.6, 7), _dev("Memcpy DtoH (Device -> Pageable)", 5.65,
                                                  5.66, 7),
           _call("cudaStreamSynchronize", 5.7, 8),
           _call("cudaMemcpyAsync", 6.0, 9), _dev("Memcpy DtoH (Device -> Pageable)", 6.05,
                                                  6.06, 9),
           _call("cudaLaunchKernel", 6.5, 10), _dev("elementwise", 6.55, 6.6, 10),
           # launched outside every span, run while nothing decodes
           _call("cudaLaunchKernel", 8.0, 11), _dev("qgemv_mma<1>", 8.1, 8.15, 11)]
    return _run(spans, raw)


def test_issue_ms_is_the_mean_issue_span_in_the_window():
    run = _scene()
    assert pt.issue_ms(run) == pytest.approx(1.95)
    run.w0, run.w1 = 10.0 + 0.002, 11.0  # only the second step starts in it
    assert pt.issue_ms(run) == pytest.approx(2.0)
    run.w0 = 10.5
    assert pt.issue_ms(run) is None


def test_device_work_of_a_step_by_correlation_id():
    run = _scene()
    w = pt.issue_work(run)
    # kernels 0.1, 0.05 and 0.3 ms and a 0.01 ms copy over 2 steps; the
    # kernel launched outside the spans is not a step's
    assert w["steps"] == 2 and pt.step_busy_ms(run) == pytest.approx(0.23)
    assert w["kernels"] == {"qgemv_mma<1>": 1.0, "elementwise": 0.5, "Memcpy HtoD "
                            "(Pageable -> Device)": 0.5}
    # three kernel launches and the copy; cudaStreamIsCapturing launches nothing
    assert pt.launches_per_step(run) == 2.0


def test_syncs_per_step_counts_a_copy_and_its_synchronize_once():
    # the H2D copy's synchronize, the DtoH copy with its synchronize, the
    # DtoH copy into pageable memory that returns only once it is done
    assert pt.syncs_per_step(_scene()) == pytest.approx(1.5)


def test_idle_by_span_puts_each_gap_to_its_innermost_span():
    run = _scene()
    got = dict(pt.idle_by_span(run))
    want = {"outside": 3.25e-3, "decode.issue": 2.1e-3, "worker.emit": 1.5e-3,
            "fwd.attn": 1.05e-3, "decode.readback": 0.88e-3, "decode.sample": 0.65e-3}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9)
    # the same gaps the breakdown labels with the benchmark's own spans
    _, window, merged = measure.device_busy(run)
    assert sum(got.values()) == pytest.approx(window - sum(b - a for a, b in merged))
    out = measure.breakdown(run)
    assert out["idle_by_span"] == pt.idle_by_span(run)
    assert set(out) == {"device_ops", "idle_gaps", "idle_by_span"}


def test_innermost_of_nested_spans():
    a = _span("a", 0, 10)
    b = _span("b", 1, 5, a)
    c = _span("c", 2, 3, b)
    d = _span("d", 6, 7, a)
    times = [T + int(x * MS) for x in (0.5, 2.5, 4, 5.5, 6.5, 11)]
    assert pt.innermost([d, c, a, b], times) == ["a", "c", "b", "a", "d", "outside"]


def test_no_decode_step_or_no_program_reads_none():
    run = _scene()
    run.program.spans = [s for s in run.program.spans if not s.name.startswith("decode")
                         and s.name != "engine.decode"]
    for read in (pt.issue_ms, pt.step_busy_ms, pt.launches_per_step, pt.syncs_per_step):
        assert read(run) is None
    assert dict(pt.idle_by_span(run))["outside"] > 0
    run.program = None  # an older program: no recorder
    for read in (pt.issue_ms, pt.step_busy_ms, pt.launches_per_step, pt.syncs_per_step):
        assert read(run) is None
    assert "idle_by_span" not in measure.breakdown(run)
    run = _scene()
    run.rec.profile = None  # no profiled sub-window (the CPU)
    assert pt.step_busy_ms(run) is None and pt.syncs_per_step(run) is None
    assert pt.issue_ms(run) == pytest.approx(1.95)


def test_recording_that_dropped_spans_reads_none():
    run = _scene()
    run.program.dropped = 1
    for read in (pt.issue_ms, pt.step_busy_ms, pt.launches_per_step, pt.syncs_per_step,
                 pt.idle_by_span):
        assert read(run) is None
    assert "idle_by_span" not in measure.breakdown(run)


class _Kineto:
    """One of torch.profiler's events, as kineto_results.events() gives it."""

    def __init__(self, name, start, dur, corr, cuda):
        from torch.autograd import DeviceType

        self._v = name, start, dur, corr, DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


def test_attach_raw_cuts_the_profiler_events_at_the_sub_window_end():
    run = _scene()
    prof = run.rec.profile
    del prof.raw, prof.base_ns
    stop = OFF + int(prof.t_stop * 1e9)  # the sub-window's end in Unix ns
    prof.kineto = [_Kineto("cudaLaunchKernel", stop - 900, 10, 2, False),
                   _Kineto("fill", stop - 1000, 5, 1, True),  # the marker, listed second
                   _Kineto("aten::add", stop - 800, 10, 0, False),  # not a runtime call
                   _Kineto("qgemv_mma<1>", stop - 700, 50, 2, True),
                   _Kineto("cudaLaunchKernel", stop + 1, 10, 3, False),  # the drain's
                   _Kineto("qgemv_mma<1>", stop + 5, 50, 3, True)]
    pt.attach_raw(run)
    assert not hasattr(prof, "kineto") and prof.base_ns == stop - 1000
    assert prof.raw == [Event("cudaLaunchKernel", stop - 900, stop - 890, 2, "cpu"),
                        Event("fill", stop - 1000, stop - 995, 1, "cuda"),
                        Event("qgemv_mma<1>", stop - 700, stop - 650, 2, "cuda")]
    pt.attach_raw(run)  # nothing handed on: the Profile stays as it is
    assert len(prof.raw) == 3


def test_install_is_idempotent():
    hooked = serve.serve, serve._device_events, measure.breakdown
    pt.install()
    assert (serve.serve, serve._device_events, measure.breakdown) == hooked
    assert serve.serve.program_trace


NEW = ("host.issue_ms", "device.step_busy_ms", "host.launches_per_step", "host.syncs_per_step")


@pytest.mark.parametrize("recorder", [True, False])
def test_traced_cpu_run_reads_the_program_spans(tiny_root, monkeypatch, recorder):
    from prima_tpu_torch.utils import perf

    if not recorder:  # a program without the recorder
        monkeypatch.setattr(pt, "_program_perf", lambda: None)
    cell = spec.cell("tiny.dense", root=tiny_root, base=tiny_root)
    assert set(NEW) <= {m.name for m in cell.per_layer}
    r = run_cell(cell, 2 ** 33 + 5, 2.0, True, torch.device("cpu"), time.perf_counter())
    assert r["correct"] and perf.ENABLED is False  # the recorder is off again
    got = set(r["metrics"]) & set(NEW)
    # no profiled sub-window on the CPU: only the span reading
    assert got == ({"host.issue_ms"} if recorder else set())
    if recorder:
        assert 0 < r["metrics"]["host.issue_ms"]["value"] < 1e4


def test_trace_check_on_the_cpu(tiny_root):
    """benchmark/trace_check.py's phases that need no card, on a tiny cell."""
    from benchmark import trace_check as tc

    cell = spec.cell("tiny.dense", root=tiny_root, base=tiny_root)
    device = torch.device("cpu")
    engine, tok = serve.build(cell.cfg, cell.mix, 2 ** 33 + 7, device)
    serve.warm_up(engine, 2 ** 33 + 7)
    c = tc.cost(engine, 3, device, pairs=4)
    assert c["spans_per_step"] > 0 and c["span_ns_off"] < c["span_ns_on"]
    s = tc.served(engine, tok, cell, 3, 2.0, device)
    assert s["off"]["host.issue_ms"] is None and s["on"]["host.issue_ms"] > 0
    assert s["off"]["failed"] == s["on"]["failed"] == 0
