"""The port's benchmark tools on the CPU: bench_tool prints the JAX
tool's keys in its md, csv, json and jsonl formats (from a GGUF and from
--synth), batched_bench its table, profile_tool the device table and the
one-device plan; without a GPU every tool raises unless given --device
cpu. The rates themselves come only from the card (chip_smoke.py)."""

import json
import os

import pytest

from prima_tpu_torch.tools import batched_bench, bench_tool, gritlm, profile_tool, simple
from test_torch_speculative import torch_one_thread  # noqa: F401
from test_torch_tools import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")


BENCH_KEYS = {"model", "size_gib", "n_params_b", "backend", "matmul", "host", "n_batch",
              "test", "avg_ts", "stddev_ts", "max_ts", "n_tokens"}


def test_bench_tool_json(capsys):
    out, _ = run(bench_tool.main, ["-m", TARGET, "-p", "16", "-n", "4", "-b", "1", "-r", "2",
                                   "-c", "64", "-o", "json", "--device", "cpu"], capsys)
    rows = json.loads(out)
    assert {r["test"] for r in rows} == {"pp16", "tg4"}
    for r in rows:
        assert set(r) == BENCH_KEYS
        assert r["avg_ts"] > 0 and r["stddev_ts"] >= 0 and r["n_batch"] == 1
        assert r["backend"] == "cpu" and r["matmul"] == "kernel"


def test_bench_tool_markdown_csv_jsonl(capsys):
    out, _ = run(bench_tool.main, ["-m", TARGET, "-p", "0", "-n", "4", "-b", "1,2", "-r", "1",
                                   "-c", "64", "-o", "md", "--device", "cpu"], capsys)
    assert out.startswith("| model | size | params | backend | n_batch | test | t/s |")
    assert "tg4" in out and out.count("\n") >= 4
    out, _ = run(bench_tool.main, ["-m", TARGET, "-p", "8", "-n", "0", "-b", "1", "-r", "1",
                                   "-c", "64", "-o", "csv", "--device", "cpu"], capsys)
    assert out.splitlines()[0].split(",")[:6] == ["model", "size_gib", "n_params_b", "backend",
                                                  "matmul", "host"]
    assert "pp8" in out
    out, _ = run(bench_tool.main, ["--synth", "tiny", "-p", "8", "-n", "2", "-r", "1",
                                   "-c", "32", "-o", "jsonl", "--device", "cpu"], capsys)
    rows = [json.loads(ln) for ln in out.splitlines()]
    assert [r["test"] for r in rows] == ["pp8", "tg2"]
    assert rows[0]["model"] == "synth-tiny-Q4_K" and rows[0]["size_gib"] > 0


def test_batched_bench_tool(capsys):
    out, _ = run(batched_bench.main, ["-m", TARGET, "-npp", "8", "-ntg", "4", "-npl", "1,2",
                                      "-c", "64", "--device", "cpu"], capsys)
    assert "S_TG t/s" in out
    assert len([ln for ln in out.splitlines() if ln.startswith("|     8 |")]) == 2


def test_profile_tool(capsys):
    out, _ = run(profile_tool.main, ["-m", TARGET, "--no-disk", "--device", "cpu"], capsys)
    assert "single-device plan: w=" in out and "model: 4 layers" in out
    out, _ = run(profile_tool.main, ["--json", "--no-disk", "--device", "cpu"], capsys)
    assert json.loads(out)["platform"] == "cpu"


def test_tools_refuse_a_missing_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, args in ((simple.main, ["-m", TARGET]), (bench_tool.main, ["--synth", "tiny"]),
                       (gritlm.main, ["-m", TARGET]), (profile_tool.main, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)
