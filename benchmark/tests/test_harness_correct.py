"""`correct` on the CPU at a size a test can hold: a sound run passes; the
control (the reference at float8) reads beyond the limit the program
keeps; and a run with the timed path broken underneath comes out not
correct, once for each fault a served cell can have (a step that leaves
its state unchanged, half the batch left out, a token altered where it is
produced, and for a mixture of experts a router wrong for one slot). The
cells have one chip, so there is no exchange to leave out. The same
control at the cells' own sizes runs on the card."""

import os
import time

import pytest
import torch

from benchmark import spec
from benchmark.control import control_readings
from benchmark.run import run_cell

SEED = 2 ** 33 + 17


def _run(root, workload="tiny.dense", seed=SEED):
    cell = spec.cell(workload, root=root, base=root)
    return run_cell(cell, seed, 2.0, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("workload", ["tiny.dense", "tiny.moe"])
def test_sound_run_is_correct(tiny_root, workload):
    r = _run(tiny_root, workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["tokens_compared"]["value"] >= 40
    assert list(r)[-1] == "checks" and set(r["metrics"]) == {
        "tpot_p90_ms", "itl_mean_ms", "output_tok_s", "setup_s"}


@pytest.mark.parametrize("workload,seed", [("tiny.dense", 1), ("tiny.dense", 3),
                                           ("tiny.moe", 2), ("tiny.moe", 4)])
def test_control_fails_the_limit(tiny_root, workload, seed):
    cell = spec.cell(workload, root=tiny_root, base=tiny_root)
    number, limit = cell.cfg["correct"]["number"], cell.cfg["correct"]["limit"]
    r = control_readings(cell, seed, 2.0, torch.device("cpu"), time.perf_counter())
    assert r["program"][number] <= limit < r["fp8"][number]
    for name, lim in cell.cfg["correct"].get("route_limits", {}).items():
        assert r["program"][name] <= lim < r["fp8"][name], (name, r)


def test_state_left_unchanged(tiny_root, monkeypatch):
    from prima_tpu_torch.models import llama

    monkeypatch.setattr(llama, "update_kv_pair", lambda *a, **kw: None)
    assert not _run(tiny_root)["correct"]


def test_half_the_batch_left_out(tiny_root, monkeypatch):
    from prima_tpu_torch.runtime.engine import Engine

    decode = Engine._decode_raw

    def half(self, params, caches, tokens, cache_pos, rope_pos):
        """Every second row of the batch takes its neighbour's output."""
        logits, caches = decode(self, params, caches, tokens, cache_pos, rope_pos)
        return logits[torch.arange(logits.shape[0]) // 2 * 2], caches

    monkeypatch.setattr(Engine, "_decode_raw", half)
    assert not _run(tiny_root)["correct"]


def test_token_altered(tiny_root, monkeypatch):
    from prima_tpu_torch.runtime.engine import Engine

    step = Engine.step_fused

    def altered(self, *a, **kw):
        events = step(self, *a, **kw)
        if events and events[0].token is not None:
            events[0].token = (events[0].token + 1) % self.cfg.n_vocab
        return events

    monkeypatch.setattr(Engine, "step_fused", altered)
    assert not _run(tiny_root)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["qwen2.5-7b.sharegpt", "mixtral-8x7b.alpaca"])
def test_control_at_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control at a cell's size runs on the card")
    cell = spec.cell(workload)
    number, limit = cell.cfg["correct"]["number"], cell.cfg["correct"]["limit"]
    for seed in (101, 202, 303):
        r = control_readings(cell, seed, 10.0, torch.device("cuda", 0), time.perf_counter())
        assert r["program"][number] <= limit < r["fp8"][number], r
        for name, lim in cell.cfg["correct"].get("route_limits", {}).items():
            assert r["program"][name] <= lim < r["fp8"][name], (name, r)


def test_router_wrong_for_one_slot(tiny_root, monkeypatch):
    """The router's scores of the first slot's decode row reversed in
    every layer: the gap follows the program's experts and stays small,
    the router's share over the first layers does not."""
    from prima_tpu_torch.models import llama

    moe, linear = llama.moe_ffn, llama.linear

    def wrong(layer, cfg, x, opts):
        def lin(a, w, *args, **kw):
            y = linear(a, w, *args, **kw)
            if w is layer["ffn_gate_inp"] and y.shape[0] > 1:  # a decode batch
                y = y.clone()
                y[0] = -y[0]
            return y

        llama.linear = lin
        try:
            return moe(layer, cfg, x, opts)
        finally:
            llama.linear = linear

    monkeypatch.setattr(llama, "moe_ffn", wrong)
    r = _run(tiny_root, "tiny.moe")
    lead = r["checks"]["route_mismatch_lead"]
    assert not r["correct"] and lead["value"] > lead["limit"], r["checks"]


def test_no_chip_no_result(monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "qwen2.5-7b.sharegpt", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
    assert os.path.exists(os.path.join(spec.ROOT, "BENCHMARK.json"))
