"""deepseek2 (DeepSeek-V2-Lite) joins the benchmark as files: its
architecture file (archs/deepseek2.py), its configuration and its mix. A
tiny deepseek2 cell added as files to a tiny root is correct through
run_cell on the CPU, and the same cell with a fault planted in its
architecture file (the shared experts left out) is not; at full size its
tensor table and ModelCost are pinned."""

import hashlib
import json
import os
import shutil
import time

import pytest
import torch

from benchmark import spec
from benchmark.layout import tensor_table
from benchmark.roofline import ModelCost
from benchmark.run import run_cell

from .conftest import BENCH, HERE

# the table as [name, shape, ggml type, dense kind] rows in order (its
# sha256 over their JSON), and ModelCost's figures: about 10.3 GB of GGUF
# blocks in all (9.6 GiB), a cell 1152 bytes a layer (512 latent and 64
# RoPE-key values in bf16)
FULL_SIZE = {
    "rows": 377, "sha256": "348b87c32370de240e328f0eeb938d42cf19aa2d35db2cc73ec88da510523767",
    "ends": [["token_embd.weight", [102400, 2048], 12, None],
             ["blk.0.attn_norm.weight", [2048], 0, "norm"],
             ["output_norm.weight", [2048], 0, "norm"],
             ["output.weight", [102400, 2048], 14, None]],
    "weight_bytes": 10056286208, "head_bytes": 172032000, "embd_row_bytes": 1152,
    "kv_bytes_cell": 27 * 1152,
    "token_flops": {(1, False): 4484126720, (1, True): 4903557120,
                    (128, False): 4603510784, (128, True): 5022941184,
                    (2048, False): 6408372224, (2048, True): 6827802624}}


def test_full_size_table_and_cost():
    want = FULL_SIZE
    cfg = spec.load_json(os.path.join(BENCH, "configs", "deepseek-v2-lite-q4km.json"))
    table = tensor_table(cfg["model"], cfg["types"])
    rows = [[t.name, list(t.shape), t.ggml_type, t.dense] for t in table]
    assert len(rows) == want["rows"] and rows[:2] + rows[-2:] == want["ends"]
    assert hashlib.sha256(json.dumps(rows).encode()).hexdigest() == want["sha256"]
    # the MoE layers' expert down projections: rows of 1408 are no whole
    # blocks of 256, so Q5_0 (Q4_K's fallback) or Q8_0 (Q6_K's)
    down = {r[2] for r in rows if r[0].endswith("ffn_down_exps.weight")}
    assert down == {6, 8} and sum(r[0].endswith("ffn_gate_inp.weight") for r in rows) == 26
    cost = ModelCost(cfg["model"], table)
    for key in ("weight_bytes", "head_bytes", "embd_row_bytes", "kv_bytes_cell"):
        assert getattr(cost, key) == want[key], key
    for (visible, head), flops in want["token_flops"].items():
        assert cost.token_flops(visible, head) == flops, (visible, head)


def _deepseek2_root(root, shared: bool = True) -> str:
    """The tiny root with a tiny deepseek2 configuration added; without
    `shared`, its architecture file leaves out the shared experts."""
    shutil.copy(os.path.join(HERE, "data", "tiny-deepseek2.json"), os.path.join(root, "configs"))
    if not shared:
        path = os.path.join(root, "archs", "deepseek2.py")
        src = open(path).read()
        faulty = src.replace('x + (routed + dense_ffn(ref, p, f, "_shexp"))', "x + routed")
        assert faulty != src
        with open(path, "w") as f:
            f.write(faulty)
    path = os.path.join(root, "BENCHMARK.json")
    bench = spec.load_json(path)
    bench["configs"].append({"name": "tiny-deepseek2", "source": "test",
                             "file": "configs/tiny-deepseek2.json", "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "tiny.deepseek2", "config": "tiny-deepseek2",
                               "traffic": "tiny", "chips": 1, "why": "t"})
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


@pytest.mark.parametrize("shared", [True, False])
def test_deepseek2_cell_as_files(tiny_root, shared):
    root = _deepseek2_root(tiny_root, shared)
    cell = spec.cell("tiny.deepseek2", root=root, base=root)
    r = run_cell(cell, 2 ** 35 + 13, 2.0, False, torch.device("cpu"), time.perf_counter())
    checks, readings = r["checks"], r["diagnostics"]["readings"]
    print(checks)
    # routes followed over the two MoE layers; layer 0 has no router
    assert len(readings["route_share_by_layer"]) == 2
    assert r["failed"] == 0 and checks["tokens_compared"]["value"] >= 40
    gap = checks["max_logit_gap"]
    if shared:
        assert r["correct"], checks
    else:
        assert not r["correct"] and gap["value"] > gap["limit"], checks
