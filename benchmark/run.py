"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and metrics are found by the names
in BENCHMARK.json (spec.py). The weights and the traffic are made from
--seed; the program is built and warmed up (set-up), serves the mix
open-loop for --seconds after a lead-in, drains the window's requests,
and is checked against the plain reference. The last line on standard
output is one JSON object; with --trace 0 its metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics and a breakdown.
The numbers compared, each with its limit, are the last lines on
standard error and the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every kernel and build cache of the program stays inside the checkout, at
# fixed paths, so only a checkout's first run builds (the program's own
# nvcc and g++ builds already go to build/prima_tpu_torch/)
for _var, _dir in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", "bench_cache", _dir)

# modules that may not be loaded once the window has closed: the JAX
# package and JAX itself (top-level names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "prima_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of `cell` on `device`: the result object, `checks` last."""
    import torch

    from benchmark import check, measure, serve
    from benchmark.layout import tensor_table
    from benchmark.roofline import ModelCost

    engine, tok = serve.build(cell.cfg, cell.mix, seed, device)
    serve.warm_up(engine, seed)
    run = serve.Run(cell.cfg, cell.mix, seconds,
                    ModelCost(cell.cfg["model"], tensor_table(cell.cfg["model"],
                                                               cell.cfg["types"])), t_start)
    serve.serve(run, engine, tok, seed, trace, device)
    serve.free(engine)
    del engine
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    window = run.window()
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"attempted": len(window), "failed": sum(not serve.finished(s) for s in window),
              "metrics": metrics, "device": dev}
    if trace:
        busy = measure.device_busy(run)
        if busy is not None:
            dev["busy_s"], dev["window_s"] = busy[0], busy[1]
            result["breakdown"] = measure.breakdown(run)
    if cuda:
        dev["power_limit"] = power_limit()
    late = [s.t_submit - s.due for s in run.served]
    result["diagnostics"] = {"submit_late_max_ms": 1e3 * max(late, default=0.0),
                             "launches": run.launch_counts,
                             "setup_s": run.setup_s,
                             "latencies": measure.latencies(run)}
    t = time.perf_counter()
    verdict = check.check(run, seed, device)
    result["diagnostics"]["readings"] = verdict["readings"]
    result["diagnostics"]["check_s"] = time.perf_counter() - t
    result = {"correct": verdict["correct"], **result, "checks": verdict["checks"]}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
