"""The benchmark is found by names: a configuration, a traffic mix and a
metric dropped in as new files run without an edit to the harness (an
architecture too: test_harness_archs.py); and no module of the benchmark
imports JAX or the JAX package, nor the reference, with every
architecture file it loads, anything of the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from benchmark import spec
from benchmark.run import FORBIDDEN, run_cell

from .conftest import BENCH, HERE

ROOT = os.path.dirname(BENCH)


def test_new_config_mix_and_metric_as_files(tiny_root):
    root = tiny_root
    shutil.copy(os.path.join(HERE, "data", "tiny-qwen2.json"),
                os.path.join(root, "configs", "tiny-new.json"))
    with open(os.path.join(HERE, "data", "tiny.json")) as f:
        mix = json.load(f)
    mix.update(rate_rps=6.0, output={"median": 4, "sigma": 0.3, "min": 3, "max": 6})
    with open(os.path.join(root, "traffic", "burst.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "metrics", "requests_done_per_s.py"), "w") as f:
        f.write("def read(run):\n"
                "    return sum(s.gen.done_reason == 'length' for s in run.window())"
                " / run.seconds\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-new", "source": "test", "file": "configs/tiny-new.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "tiny-new.burst", "config": "tiny-new",
                               "traffic": "burst", "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "requests_done_per_s", "unit": "req/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-new.burst"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = spec.cell("tiny-new.burst", root=root, base=root)
    assert cell.mix["rate_rps"] == 6.0 and cell.cfg["model"]["n_layers"] == 2
    assert [m.name for m in cell.end_to_end][-1] == "requests_done_per_s"
    r = run_cell(cell, 2 ** 40 + 3, 2.0, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"] and r["attempted"] == 12
    assert r["metrics"]["requests_done_per_s"]["value"] == 6.0
    # the metric is only the new cell's
    assert "requests_done_per_s" not in [m.name for m in spec.cell("tiny.dense", root=root,
                                                                   base=root).end_to_end]


def _imports(path: str) -> tuple[set, set]:
    """(top-level names of absolute imports, relative module names)."""
    tree = ast.parse(open(path).read())
    absolute, relative = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            absolute |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # from . import x, or from .x import y
                relative |= {node.module} if node.module else {a.name for a in node.names}
            else:
                absolute.add(node.module.split(".")[0])
                if node.module == "benchmark":
                    relative |= {a.name for a in node.names}
                elif node.module.startswith("benchmark."):
                    relative.add(node.module.split(".", 1)[1])
    return absolute, relative


def _sources():
    for d, _, files in os.walk(BENCH):
        if os.path.relpath(d, BENCH).split(os.sep)[0] == "tests":
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


# the architecture files: the benchmark's own and the one a test adds
ARCHS = sorted([os.path.join(BENCH, "archs", f) for f in os.listdir(os.path.join(BENCH, "archs"))
                if f.endswith(".py")] + [os.path.join(HERE, "data", "qwen2moe.py")])


def test_no_jax_or_jax_package():
    found = {p: _imports(p)[0] & set(FORBIDDEN) for p in [*_sources(), *ARCHS]}
    assert not any(found.values()), found
    assert "prima_tpu" in FORBIDDEN and "prima_tpu_torch" not in FORBIDDEN
    assert {os.path.join(BENCH, "archs", "llama.py")} <= set(_sources())


def test_reference_imports_nothing_of_the_program():
    """The reference's modules, and every architecture file with what it
    imports, import nothing of the program, by their sources and once
    loaded: a reference over a tiny mixture of experts leaves neither the
    program nor JAX in sys.modules."""
    seen, todo = set(), ["reference", *ARCHS]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = mod if mod.endswith(".py") else os.path.join(BENCH, *mod.split(".")) + ".py"
        absolute, relative = _imports(path)
        assert not absolute & {"prima_tpu_torch", *FORBIDDEN}, (mod, absolute)
        todo += list(relative)
    assert {m for m in seen if not m.endswith(".py")} == {
        "reference", "blocks", "layout", "spec", "roofline", "archs.llama"}
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from benchmark import spec; from benchmark.reference import Reference; "
         "Reference(spec.load_json(sys.argv[2]), 1, 'cpu').logits([[1, 2, 3]], [0]); "
         "print(sorted({m.split('.')[0] for m in sys.modules}))",
         ROOT, os.path.join(HERE, "data", "tiny-moe.json")],
        capture_output=True, text=True, check=True, timeout=120)
    loaded = set(ast.literal_eval(out.stdout.strip()))
    assert not loaded & {"prima_tpu_torch", *FORBIDDEN}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "prima_tpu_torch_fake", sys)
    assert run.forbidden_modules() == sorted({m.split(".")[0] for m in sys.modules}
                                             & set(FORBIDDEN))
    monkeypatch.setitem(sys.modules, "prima_tpu.fake", sys)
    assert "prima_tpu" in run.forbidden_modules()
