"""Fixtures of the benchmark's CPU tests: a checkout-like directory with a
BENCHMARK.json of tiny cells, run on the CPU at sizes a test can hold."""

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


def write_root(path, per_layer: bool = True) -> str:
    """BENCHMARK.json with the tiny cells `tiny.dense` (qwen2 with biases)
    and `tiny.moe` (llama with 4 experts, top-2) under one tiny mix, and
    the benchmark's own metric readers and architecture files."""
    root = str(path)
    for d in ("configs", "traffic", "metrics", "archs"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for name in ("tiny-qwen2", "tiny-moe"):
        shutil.copy(os.path.join(HERE, "data", name + ".json"),
                    os.path.join(root, "configs", name + ".json"))
    shutil.copy(os.path.join(HERE, "data", "tiny.json"), os.path.join(root, "traffic"))
    for d in ("metrics", "archs"):
        for f in os.listdir(os.path.join(BENCH, d)):
            if f.endswith(".py"):
                shutil.copy(os.path.join(BENCH, d, f), os.path.join(root, d))
    with open(os.path.join(BENCH, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": n, "source": "test", "file": f"configs/{n}.json",
                         "reduced": [], "why": "test"} for n in ("tiny-qwen2", "tiny-moe")]
    bench["workloads"] = [
        {"name": "tiny.dense", "config": "tiny-qwen2", "traffic": "tiny", "chips": 1, "why": "t"},
        {"name": "tiny.moe", "config": "tiny-moe", "traffic": "tiny", "chips": 1, "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(tmp_path)
