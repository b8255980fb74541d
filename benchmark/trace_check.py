"""Cross-checks of the program's span recorder on the card, for one cell:

- cost: a span's own time off and on, and `step_fused` calls with the
  recorder off and on alternated call by call (no profiler);
- clock: single kernel launches bracketed by perf_counter_ns against
  their CUDA runtime calls in torch.profiler's trace, through the
  recording's offset (the residual of the spans' Unix-ns conversion);
- correlation: the qgemv (and qgemv_indexed) kernels the trace attributes
  to decode.issue spans a step, by correlation id, against the program's
  LaunchCounters a step; with the four readings of program_trace.py and
  the host-holding calls by the span they were made in;
- serve: a served window with the recorder off, then on (no profiler):
  engine.decode_step_ms, itl_mean_ms, tpot_p90_ms, output_tok_s.

    python3 benchmark/trace_check.py --workload qwen2.5-7b.sharegpt --seed 7

The result is one JSON object, printed last and written to
chiprun_out/trace_check_<workload>.json.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run as _run  # noqa: E402,F401  (the build caches inside the checkout)

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import time  # noqa: E402
from collections import Counter  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import measure, program_trace as pt, serve, spec  # noqa: E402
from benchmark.layout import tensor_table  # noqa: E402
from benchmark.roofline import ModelCost  # noqa: E402
from prima_tpu_torch.quant import qmatmul as qm  # noqa: E402
from prima_tpu_torch.runtime.engine import SlotState  # noqa: E402
from prima_tpu_torch.utils import perf  # noqa: E402

PHASES = ("cost", "clock", "serve")


def fill(engine, seed: int, device) -> None:
    """Every slot decoding a long request, three in four sampled."""
    rng = np.random.default_rng(seed)
    for i in range(engine.n_slots):
        body = {"seed": i} if i % 4 else {"seed": i, "temperature": 0}
        engine.submit(rng.integers(0, engine.cfg.n_vocab, min(100, engine.max_seq // 8)).tolist(),
                      sampler=serve.make_sampler(engine.cfg, body),
                      n_predict=engine.max_seq - 200, request_id=f"x{i}")
    while any(s.state == SlotState.PREFILL for s in engine.slots):
        engine.step()
    engine.step_fused(max_chunk=8)
    sync(device)


def sync(device) -> None:
    if device.type == "cuda":  # the CPU test of cost() and served()
        torch.cuda.synchronize(device)


def clear(engine) -> None:
    for s in engine.slots:
        if s.state != SlotState.IDLE:
            engine.cancel(s.request_id)
        s.prompt = []


def quartiles(v: list) -> dict:
    q = statistics.quantiles(v, n=4)
    return {"median": statistics.median(v), "q1": q[0], "q3": q[2], "n": len(v)}


def span_ns(on: bool, n: int = 200_000) -> float:
    """The mean time of one `with span(...)` with an attribute."""
    was = perf.enable(on)
    try:
        with perf.recording():
            t0 = time.perf_counter_ns()
            for i in range(n):
                with perf.span("x") as sp:
                    if sp:
                        sp.set(layer=i)
            return (time.perf_counter_ns() - t0) / n
    finally:
        perf.enable(was)


def cost(engine, seed: int, device, pairs: int = 60) -> dict:
    """step_fused's ms a step, recorder off and on alternated (ABBA)."""
    fill(engine, seed, device)
    times = {False: [], True: []}
    with perf.recording() as rec:
        for i in range(2 * pairs):
            on = bool(i % 2) if (i // 2) % 2 == 0 else not (i % 2)
            was = perf.enable(on)
            t0 = time.perf_counter()
            engine.step_fused(max_chunk=8)
            times[on].append((time.perf_counter() - t0) * 1e3 / 8)
            perf.enable(was)
    clear(engine)
    diff = [b - a for a, b in zip(times[False], times[True])]
    off = quartiles(times[False])
    return {"span_ns_off": min(span_ns(False) for _ in range(3)),
            "span_ns_on": min(span_ns(True) for _ in range(3)),
            "spans_per_step": len(rec.spans) / (pairs * 8),
            "step_ms_off": off, "step_ms_on": quartiles(times[True]),
            "on_minus_off_ms_median": statistics.median(diff),
            "on_cost_pct": 100 * statistics.median(diff) / off["median"]}


def clock_and_correlation(engine, seed: int, device, brackets: int = 300,
                          calls: int = 5) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's first start
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)
    fill(engine, seed, device)
    a = torch.zeros(1024, device=device)
    was = perf.enable(True)
    try:
        with perf.recording() as rec:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            torch.cuda.synchronize(device)
            time.sleep(0.5)
            br = []
            for _ in range(brackets):
                p0 = time.perf_counter_ns()
                a.add_(1)
                p1 = time.perf_counter_ns()
                br.append((p0, p1))
                time.sleep(0.0002)
            torch.cuda.synchronize(device)
            time.sleep(0.01)
            t_start = time.perf_counter()
            c0 = (qm.launches.count, qm.indexed_launches.count)
            for _ in range(calls):
                engine.step_fused(max_chunk=8)
            c1 = (qm.launches.count, qm.indexed_launches.count)
            t_stop = time.perf_counter()
            torch.cuda.synchronize(device)
            prof.stop()
    finally:
        perf.enable(was)
    clear(engine)
    raw, base = pt.raw_events(prof.profiler.kineto_results.events(),
                              rec.unix_ns(int(t_stop * 1e9)) + 10 ** 9)
    out = {}
    # the clock: the bracketed launches are the only ones between the first
    # bracket's start and the last one's end (give or take a millisecond)
    lo_u, hi_u = rec.unix_ns(br[0][0]) - 10 ** 6, rec.unix_ns(br[-1][1]) + 10 ** 6
    adds = sorted((e for e in raw if e.device == "cpu" and e.name == "cudaLaunchKernel"
                   and lo_u <= e.t0 <= hi_u), key=lambda e: e.t0)
    if len(adds) == len(br):
        # the true offset lies where every call falls inside its bracket
        lo = max(c.t1 - p1 for c, (p0, p1) in zip(adds, br))
        hi = min(c.t0 - p0 for c, (p0, p1) in zip(adds, br))
        inside = sum(rec.unix_ns(p0) <= c.t0 and c.t1 <= rec.unix_ns(p1)
                     for c, (p0, p1) in zip(adds, br))
        width = sorted(p1 - p0 for p0, p1 in br)
        out["clock"] = {"brackets": len(br), "inside": inside,
                        "residual_us": [(rec.offset_ns - hi) / 1e3, (rec.offset_ns - lo) / 1e3],
                        "bracket_us_median": width[len(width) // 2] / 1e3}
    else:
        out["clock"] = {"brackets": len(br), "launches_found": len(adds)}
    # correlation
    run = SimpleNamespace(program=rec, w0=t_start, w1=t_stop, rec=SimpleNamespace(
        profile=SimpleNamespace(t_start=t_start, t_stop=t_stop, raw=raw, base_ns=base,
                                events=[])))
    w = pt.issue_work(run)
    steps, k = w["steps"], w["kernels"]
    out["correlation"] = {
        "steps": steps,
        "qgemv_kernels_per_step": sum(v for n, v in k.items() if "qgemv" in n
                                      and "indexed" not in n),
        "qgemv_calls_per_step": (c1[0] - c0[0]) / steps,
        "qgemv_indexed_kernels_per_step": sum(v for n, v in k.items() if "indexed" in n),
        "qgemv_indexed_calls_per_step": (c1[1] - c0[1]) / steps,
        "device.step_busy_ms": w["device_ms"], "host.launches_per_step": w["launches"],
        "host.syncs_per_step": pt.syncs_per_step(run), "host.issue_ms": pt.issue_ms(run),
        "wall_ms_per_step": (t_stop - t_start) * 1e3 / steps,
        "top_kernels_per_step": sorted(k.items(), key=lambda kv: -kv[1])[:12]}
    # the calls that hold the host, by name, copy and innermost span
    lo_w, hi_w = rec.unix_ns(int(t_start * 1e9)), rec.unix_ns(int(t_stop * 1e9))
    loop = sorted((e for e in raw if e.device == "cpu" and lo_w <= e.t0 <= hi_w),
                  key=lambda e: e.t0)
    copies = {e.corr: e.name for e in raw if e.device == "cuda" and "Memcpy" in e.name}
    syncs = [e for i, e in enumerate(loop) if pt.is_sync(loop, i, copies)]
    where = pt.innermost(rec.spans, [e.t0 - rec.offset_ns for e in syncs])
    by = Counter((e.name, copies.get(e.corr, ""), s) for e, s in zip(syncs, where))
    out["correlation"]["syncs_by_span_per_step"] = sorted(
        ([f"{n} {c} in {s}".replace("  ", " "), v / steps] for (n, c, s), v in by.items()),
        key=lambda kv: -kv[1])
    # launches of the loop outside every decode.issue span
    ivs = sorted((rec.unix_ns(s.t0), rec.unix_ns(s.t1)) for s in rec.spans
                 if s.name == "decode.issue")
    starts = [iv[0] for iv in ivs]

    def covered(t):
        j = bisect.bisect_right(starts, t) - 1
        return j >= 0 and ivs[j][1] >= t

    launches = [e for e in loop if e.name.startswith(pt.LAUNCH_PREFIXES)]
    out["correlation"]["loop_launches"] = len(launches)
    out["correlation"]["loop_launches_outside_issue"] = sum(not covered(e.t0) for e in launches)
    return out


def served(engine, tok, cell, seed: int, seconds: float, device) -> dict:
    """A served window with the recorder off, then one with it on."""
    res = {}
    program_perf = pt._program_perf
    try:
        for on in (False, True):
            clear(engine)  # no prefix of the other window's requests is reused
            pt._program_perf = program_perf if on else (lambda: None)
            run = serve.Run(cell.cfg, cell.mix, seconds,
                            ModelCost(cell.cfg["model"], tensor_table(cell.cfg["model"],
                                                                       cell.cfg["types"])),
                            time.perf_counter())
            serve.serve(run, engine, tok, seed, True, device, profile=False)
            res["on" if on else "off"] = {
                "engine.decode_step_ms": measure.decode_step_ms(run),
                "itl_mean_ms": measure.itl_mean_ms(run),
                "tpot_p90_ms": measure.window_p90_ms(run, measure.tpot_s),
                "output_tok_s": measure.output_tok_s(run),
                "host.issue_ms": pt.issue_ms(run),
                "failed": sum(not serve.finished(s) for s in run.window())}
    finally:
        pt._program_perf = program_perf
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    device = torch.device("cuda", 0)
    out = {"workload": args.workload, "seed": args.seed, "card": _run.power_limit(),
           "torch": torch.__version__}
    cell = spec.cell(args.workload)
    t = time.perf_counter()
    engine, tok = serve.build(cell.cfg, cell.mix, args.seed, device)
    serve.warm_up(engine, args.seed)
    out["build_s"] = time.perf_counter() - t
    phases = set(args.phases.split(","))
    if "cost" in phases:
        out["cost"] = cost(engine, args.seed, device)
        print(json.dumps(out), flush=True)
    if "clock" in phases:
        out.update(clock_and_correlation(engine, args.seed, device))
        print(json.dumps(out), flush=True)
    if "serve" in phases:
        out["serve"] = served(engine, tok, cell, args.seed, args.seconds, device)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/trace_check_{args.workload}.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
