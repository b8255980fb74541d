"""A configuration's block comes from its architecture file
(archs/<arch>.py): the two configurations of the benchmark read exactly
as they did when the llama block lived in the harness itself (their
tensor tables and costs at full size, the reference's logits on the tiny
cells, with and without forced routes); the program's routes are kept
over the MoE layers only; and a block the harness has no file for (a
qwen2moe with a dense first layer, a shared expert and raw top-k
weights) joins as added files, where a fault planted in its file fails
the check."""

import hashlib
import json
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.layout import tensor_table
from benchmark.reference import Reference
from benchmark.roofline import ModelCost
from benchmark.run import run_cell

from .conftest import BENCH, HERE

# the parent's figures: the table as [name, shape, ggml type, dense kind]
# rows in order (its sha256 over their JSON), and ModelCost's
FULL_SIZE = {
    "qwen2.5-7b-q4km": {
        "rows": 339, "sha256": "54fddc9a87335bbf97dba8002cac3be87afd89a18acba3ea67f0d690703dfd99",
        "ends": [["token_embd.weight", [152064, 3584], 12, None],
                 ["blk.0.attn_norm.weight", [3584], 0, "norm"],
                 ["output_norm.weight", [3584], 0, "norm"],
                 ["output.weight", [152064, 3584], 14, None]],
        "weight_bytes": 3922157568, "head_bytes": 447068160, "embd_row_bytes": 2016,
        "kv_bytes_cell": 57344,
        "token_flops": {(1, False): 13050978304, (1, True): 14140973056,
                        (128, False): 13101957120, (128, True): 14191951872,
                        (2048, False): 13872660480, (2048, True): 14962655232}},
    "mixtral-8x7b-q4km": {
        "rows": 323, "sha256": "93ff3e6324a50713e83344f68d0784290a6753fcf0a24a38e220988c6c2b4bb6",
        "ends": [["token_embd.weight", [32000, 4096], 12, None],
                 ["blk.0.attn_norm.weight", [4096], 0, "norm"],
                 ["output_norm.weight", [4096], 0, "norm"],
                 ["output.weight", [32000, 4096], 14, None]],
        "weight_bytes": 28261220352, "head_bytes": 107520000, "embd_row_bytes": 2304,
        "kv_bytes_cell": 131072,
        "token_flops": {(1, False): 25235554304, (1, True): 25497698304,
                        (128, False): 25302138880, (128, True): 25564282880,
                        (2048, False): 26308771840, (2048, True): 26570915840}},
}


@pytest.mark.parametrize("name", sorted(FULL_SIZE))
def test_full_size_table_and_cost_as_at_the_parent(name):
    want = FULL_SIZE[name]
    cfg = spec.load_json(os.path.join(BENCH, "configs", name + ".json"))
    table = tensor_table(cfg["model"], cfg["types"])
    rows = [[t.name, list(t.shape), t.ggml_type, t.dense] for t in table]
    assert len(rows) == want["rows"] and rows[:2] + rows[-2:] == want["ends"]
    assert hashlib.sha256(json.dumps(rows).encode()).hexdigest() == want["sha256"]
    cost = ModelCost(cfg["model"], table)
    for key in ("weight_bytes", "head_bytes", "embd_row_bytes", "kv_bytes_cell"):
        assert getattr(cost, key) == want[key], key
    for (visible, head), flops in want["token_flops"].items():
        assert cost.token_flops(visible, head) == flops, (visible, head)


# the parent reference's logits (seed 11) over two sequences, at rows
# (0, 0), (3, 100), (11, 511) of the 12 compared positions, and their sum;
# for tiny-moe also with each row's own experts moved up by one (forced),
# where every row of both MoE layers differs
LOGITS = {
    "tiny-qwen2": ([0.22752328217029572, -0.5925127863883972, -0.08678865432739258],
                   21.75727484440722),
    "tiny-moe": ([0.29425951838493347, 0.1779436618089676, -0.0190515648573637],
                 51.331087807702716),
    "tiny-moe forced": ([0.37227582931518555, 0.2207774966955185, -0.3055916130542755],
                        33.280170276295394),
}


@pytest.mark.parametrize("case", sorted(LOGITS))
def test_reference_logits_as_at_the_parent(case):
    cfg = spec.load_json(os.path.join(HERE, "data", case.split()[0] + ".json"))
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 512, 7).tolist(), rng.integers(0, 512, 12).tolist()]
    ref = Reference(cfg, 11, "cpu")
    logits = torch.cat(ref.logits(seqs, [2, 5]))
    if case.endswith("forced"):
        forced = [(r + 1) % cfg["model"]["n_expert"] for r in ref.chosen]
        logits = torch.cat(ref.logits(seqs, [2, 5], forced))
        assert ref.route_differ == ref.route_rows == [19, 19]
        assert ref.route_margins == pytest.approx([0.1065475344657898, 0.06565672159194946],
                                                  rel=1e-5)
        assert [c.tolist() for c in ref.chosen] == [f.tolist() for f in forced]
    picks, total = LOGITS[case]
    assert logits.shape == (12, 512)
    got = [float(logits[r, c]) for r, c in ((0, 0), (3, 100), (11, 511))]
    assert got == pytest.approx(picks, rel=1e-5, abs=1e-6)
    assert float(logits.double().sum()) == pytest.approx(total, rel=1e-5)


def test_route_log_keeps_moe_layers_only(monkeypatch):
    """A dense layer between two MoE layers: the routes of a request are
    its two MoE layers' ids, and a MoE layer that was not seen leaves
    none."""
    from prima_tpu_torch.models import llama

    from benchmark.routes import RouteLog

    def moe_ffn(layer, cfg, x, opts):
        torch.topk(x, 2, dim=-1)  # the router's choice, as moe_ffn makes it
        return x

    monkeypatch.setattr(llama, "moe_ffn", moe_ffn)
    layers = [{"ffn_gate_inp": 1}, {"w_gate": 1}, {"ffn_gate_inp": 1}]
    scores = torch.randn(3, 5, 4, generator=torch.Generator().manual_seed(0))
    skip = set()

    def prefill(tokens, pos0, caches, slot):
        for j, layer in enumerate(engine.params["layers"]):
            if layer.get("ffn_gate_inp") is not None and j not in skip:
                llama.moe_ffn(layer, None, scores[j], None)

    engine = SimpleNamespace(params={"layers": layers}, slots=[SimpleNamespace(request_id="r")],
                             _prefill=prefill, _decode_raw=None,
                             _fused_gen=SimpleNamespace(fwd=None, generate=None))
    log = RouteLog(engine)
    try:
        engine._prefill([1] * 5, 0, None, 0)
        routes = log.routes("r", 5, 2)
        assert routes.shape == (5, 2, 2)
        for j, layer in enumerate((0, 2)):
            assert torch.equal(routes[:, j], torch.topk(scores[layer], 2, dim=-1).indices)
        skip.add(2)
        engine._prefill([1] * 5, 5, None, 0)
        assert log.routes("r", 10, 2) is None
    finally:
        log.restore()
    assert llama.moe_ffn is moe_ffn


def _qwen2moe_root(root, shared: bool = True) -> str:
    """The tiny root with a qwen2moe configuration and its architecture
    file added; without `shared`, the file leaves out the shared expert."""
    shutil.copy(os.path.join(HERE, "data", "tiny-qwen2moe.json"), os.path.join(root, "configs"))
    src = open(os.path.join(HERE, "data", "qwen2moe.py")).read()
    if not shared:
        faulty = src.replace("x + (ref.experts(i, f, norm=False) + shared)",
                             "x + ref.experts(i, f, norm=False)")
        assert faulty != src
        src = faulty
    with open(os.path.join(root, "archs", "qwen2moe.py"), "w") as f:
        f.write(src)
    path = os.path.join(root, "BENCHMARK.json")
    bench = spec.load_json(path)
    bench["configs"].append({"name": "tiny-qwen2moe", "source": "test",
                             "file": "configs/tiny-qwen2moe.json", "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "tiny.qwen2moe", "config": "tiny-qwen2moe",
                               "traffic": "tiny", "chips": 1, "why": "t"})
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


@pytest.mark.parametrize("shared", [True, False])
def test_new_architecture_as_files(tiny_root, shared):
    root = _qwen2moe_root(tiny_root, shared)
    assert not os.path.exists(os.path.join(BENCH, "archs", "qwen2moe.py"))
    cell = spec.cell("tiny.qwen2moe", root=root, base=root)
    r = run_cell(cell, 2 ** 35 + 9, 2.0, False, torch.device("cpu"), time.perf_counter())
    checks, readings = r["checks"], r["diagnostics"]["readings"]
    # routes followed over the two MoE layers; layer 0 has no router
    assert len(readings["route_share_by_layer"]) == 2
    assert r["failed"] == 0 and checks["tokens_compared"]["value"] >= 40
    gap = checks["max_logit_gap"]
    if shared:
        assert r["correct"], checks
    else:
        assert not r["correct"] and gap["value"] > gap["limit"], checks
