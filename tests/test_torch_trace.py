"""The port's span and counter recorder (prima_tpu_torch/utils/perf.py) and
the spans at the served path's layer boundaries: nothing is recorded with
the switch off, spans nest with their parents, a forward emits fwd.embed,
two spans a layer and fwd.head, the decode paths emit one decode.issue and
one decode.sample a step and one decode.readback a call, a recording keeps
only what ends while it is open (and at most its limit), the switch off
keeps no memory, and a span's
stamps converted to Unix ns bound the torch.profiler events inside it."""

import os
import time

import numpy as np
import pytest
import torch

from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.runtime.engine import Engine, SlotState
from prima_tpu_torch.sampling import Sampler, SamplerParams
from prima_tpu_torch.server.scheduler import EngineWorker, GenerationRequest
from prima_tpu_torch.utils import perf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(ROOT, "models_tiny_pair", "target.gguf")


@pytest.fixture(scope="module")
def model():
    return load_model(PAIR, device="cpu")


@pytest.fixture
def on(monkeypatch):
    monkeypatch.setattr(perf, "ENABLED", True)


def _engine(model, n_slots=2):
    return Engine(model.cfg, model.params, n_slots=n_slots, max_seq=64, n_batch=16,
                  opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                  eog_ids=set(), device="cpu")


def _names(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_switch_off_records_nothing(monkeypatch):
    monkeypatch.setattr(perf, "ENABLED", False)
    totals = dict(perf._totals)
    with perf.recording() as rec:
        with perf.span("a", rows=1) as s:
            s.set(steps=2)
            perf.count("c", 3)
        assert s is perf.OFF and not s
    assert rec.spans == [] and dict(rec.counts) == {} and dict(perf._totals) == totals


def test_switch_off_costs_no_memory(monkeypatch):
    import tracemalloc

    monkeypatch.setattr(perf, "ENABLED", False)

    def hot(n):  # a hot path's span, its attributes given only when on
        for i in range(n):
            with perf.span("fwd.attn") as sp:
                if sp:
                    sp.set(layer=i)
            perf.count("c")

    hot(100)
    tracemalloc.start()
    try:
        hot(100)
        small = tracemalloc.get_traced_memory()[0]
        hot(20_000)
        large = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert large - small < 4096  # nothing kept a span


def test_spans_nest_with_their_parents(on):
    with perf.recording() as rec:
        with perf.span("outer", rows=2) as outer:
            with perf.span("mid") as mid:
                with perf.span("inner", layer=3):
                    pass
            with perf.span("sibling"):
                pass
            outer.set(steps=5)
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["inner", "mid", "sibling", "outer"]  # by end
    assert by["outer"].parent is None
    assert by["mid"].parent is outer and by["sibling"].parent is outer
    assert by["inner"].parent is mid
    assert by["outer"].attrs == {"rows": 2, "steps": 5} and by["inner"].attrs == {"layer": 3}
    assert by["outer"].t0 <= by["mid"].t0 <= by["inner"].t0 <= by["inner"].t1 \
        <= by["mid"].t1 <= by["sibling"].t0 <= by["sibling"].t1 <= by["outer"].t1


def test_forward_emits_embed_two_spans_a_layer_and_head(model, on):
    cfg = model.cfg
    kv = init_kv_caches(cfg, 1, 16, torch.float32, "cpu")
    tokens = torch.tensor([[1, 2, 3]])
    with perf.recording() as rec:
        with perf.span("call"):
            forward(model.params, cfg, tokens, torch.arange(3)[None], kv,
                    torch.tensor([0], dtype=torch.int32), ForwardOptions(dtype=torch.float32))
    names = [s.name for s in sorted(rec.spans, key=lambda s: s.t0)]
    assert names == (["call", "fwd.embed"] + ["fwd.attn", "fwd.ffn"] * cfg.n_layers
                     + ["fwd.head"])
    layers = [s.attrs["layer"] for s in sorted(rec.spans, key=lambda s: s.t0)
              if s.name in ("fwd.attn", "fwd.ffn")]
    assert layers == [i for i in range(cfg.n_layers) for _ in range(2)]
    assert all(s.parent.name == "call" for s in rec.spans if s.name != "call")


def _submit(eng, n, temp):
    rng = np.random.default_rng(n)
    return eng.submit(rng.integers(3, eng.cfg.n_vocab, 10 + n).tolist(), n_predict=5,
                      sampler=Sampler(SamplerParams(temp=temp, seed=n)))


def test_fused_generate_spans_a_step_and_a_call(model, on):
    eng = _engine(model)
    slots = [_submit(eng, 0, 0.0), _submit(eng, 1, 0.8)]
    while any(s.state == SlotState.PREFILL for s in slots):
        eng.step()  # the prefill chunks, then one step() decode
    before = eng.kv.cache_pos.copy()
    with perf.recording() as rec:
        eng.step_fused(max_chunk=3)
    (call,) = _names(rec, "engine.decode")
    issue, sample = _names(rec, "decode.issue"), _names(rec, "decode.sample")
    assert len(issue) == len(sample) == 3 and len(_names(rec, "decode.readback")) == 1
    assert [s.attrs["step"] for s in issue] == [0, 1, 2]
    assert all(s.parent.name == "decode.issue" for s in sample)
    assert all(s.parent is call for s in issue + _names(rec, "decode.readback"))
    assert len(_names(rec, "fwd.embed")) == 3 and len(_names(rec, "fwd.head")) == 3
    # each slot's 3 tokens at cells p0, p0 + 1, p0 + 2 see p0 + 1 ... p0 + 3
    assert call.attrs == {"rows": 2, "steps": 3,
                          "cells": sum(3 * int(p) + 6 for p in before[:2])}


def test_engine_step_emits_the_same_names(model, on):
    eng = _engine(model)
    with perf.recording() as rec:
        slots = [_submit(eng, 0, 0.0), _submit(eng, 1, 0.8)]
        eng.step()
    prefill = _names(rec, "engine.prefill")
    assert sorted((s.attrs["slot"], s.attrs["rows"], s.attrs["pos0"]) for s in prefill) \
        == [(0, 9, 0), (1, 10, 0)]
    (call,) = _names(rec, "engine.decode")
    assert call.attrs == {"rows": 2, "steps": 1, "cells": 10 + 11}
    for name in ("decode.issue", "decode.sample", "decode.readback"):
        (s,) = _names(rec, name)
        assert s.parent is call
    assert [len(s.generated) for s in slots] == [1, 1]


def test_worker_spans(model, on):
    eng = _engine(model)
    worker = EngineWorker(eng, model.tokenizer)
    worker.start()
    try:
        with perf.recording() as rec:
            req = GenerationRequest(prompt_tokens=[1, 5, 9], n_predict=4,
                                    sampler=Sampler(SamplerParams(temp=0.0)))
            events = list(worker.generate(req, timeout=60))
    finally:
        worker.shutdown()
    assert events[-1].done and len(req.tokens_out) == 4
    assert _names(rec, "worker.admit") and _names(rec, "worker.emit")
    assert sum(s.attrs["steps"] for s in _names(rec, "engine.decode")) == 4
    assert all(s.parent is None for s in _names(rec, "engine.decode"))


def test_recording_bounds_what_is_kept(on, monkeypatch):
    with perf.span("before"):
        pass
    monkeypatch.setattr(perf, "RECORDING_LIMIT", 3)
    with perf.recording() as rec:
        monkeypatch.setattr(perf, "RECORDING_LIMIT", 1000)
        with perf.recording() as inner:
            for i in range(5):
                with perf.span("x", layer=i):
                    pass
            perf.count("n", 2)
        with perf.span("after inner"):
            pass
    with perf.span("after"):
        pass
    assert [s.attrs["layer"] for s in rec.spans] == [0, 1, 2] and rec.dropped == 3
    assert [s.attrs.get("layer") for s in inner.spans] == [0, 1, 2, 3, 4]
    assert inner.dropped == 0 and rec.counts["n"] == inner.counts["n"] == 2
    assert perf._recordings == ()
    assert perf._counts["before"] >= 1 and perf._counts["after"] >= 1  # totals always


def test_timer_is_a_span_and_report_keeps_its_format(on, monkeypatch):
    import io

    monkeypatch.setattr(perf, "_totals", type(perf._totals)(float))
    monkeypatch.setattr(perf, "_counts", type(perf._counts)(int))
    with perf.recording() as rec:
        with perf.timer("load"):
            pass
    assert [s.name for s in rec.spans] == ["load"]
    out = io.StringIO()
    perf.report(file=out)
    assert out.getvalue().startswith("[timer] load total ") and "calls      1" in out.getvalue()


def test_enable_returns_the_previous_setting(monkeypatch):
    monkeypatch.setattr(perf, "ENABLED", False)
    assert perf.enable() is False and perf.ENABLED is True
    assert perf.enable(False) is True and perf.ENABLED is False


def test_span_bounds_hold_the_profiler_events_inside(on):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(128, 128)
    with perf.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with perf.span("mm"):
                x @ x
            time.sleep(0.001)
    spans = sorted(_names(rec, "mm"), key=lambda s: s.t0)
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm")
    assert len(ops) == len(spans) == 20
    for s, (e0, e1) in zip(spans, ops):
        assert rec.unix_ns(s.t0) <= e0 <= e1 <= rec.unix_ns(s.t1)
