"""Finding a cell's files by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix; the configuration names
its file; the mix is traffic/<traffic>.json; each metric is read by
metrics/<metric>.py, whose `read(run)` returns the number or None where
the run holds nothing for it to read. Adding a configuration, a mix or a
metric is adding its file and its entry. A configuration's block is
archs/<model.arch>.py (see `arch`), found under the same base as the
metrics, so a configuration of a new architecture adds that file too.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Metric:
    name: str
    unit: str
    read: object  # read(run) -> float | None


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    end_to_end: list
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str, base: str = HERE):
    """metrics/<name>.py's read function."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def arch(model: dict):
    """The architecture module of a configuration's "model": the file
    <arch_dir>/<arch>.py, where `cell` sets arch_dir to the archs/ beside
    the metrics it reads (the benchmark's own where the model names none).
    It gives `tensors(model, types)`, the tensor table in GGUF order;
    `block(ref, i, x, pos, lens)`, layer i of the plain reference; and
    `cost(model)`, a roofline.BlockCost."""
    path = os.path.join(model.get("arch_dir", os.path.join(HERE, "archs")), model["arch"] + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_arch_{model['arch']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, bench_path: str | None = None, root: str = ROOT,
         base: str = HERE) -> Cell:
    """The cell `workload` of BENCHMARK.json (at the checkout's root)."""
    bench = load_json(bench_path or os.path.join(root, "BENCHMARK.json"))
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = load_json(os.path.join(root, conf["file"]))
    cfg["model"]["arch_dir"] = os.path.join(base, "archs")
    mix = load_json(os.path.join(base, "traffic", w["traffic"] + ".json"))

    def metrics(entries):
        return [Metric(m["name"], m["unit"], reader(m["name"], base)) for m in entries
                if "workloads" not in m or workload in m["workloads"]]

    return Cell(workload, w["chips"], cfg, mix, metrics(bench["end_to_end"]),
                metrics(bench["per_layer"]))
