"""The knee sweep of a cell: one program at several arrival rates and
traffic seeds, set up once.

    python3 benchmark/sweep.py --workload <name> --seeds 7,8 --seconds 30 --rates 0.6,0.8,1.0

The weights come from the first seed. For each traffic seed and rate, in
one process: the cell's mix at that rate (its lead-in, its window, a
drain of at most --drain seconds), then one JSON line: the tails, the
output rate, the failures, and the backlog's growth: the median
admission wait of the window's last quarter less that of its first. A
rate is sustained where every request finishes and the growth is under
GROWTH_S; the knee is the highest rate sustained on every seed, and a
cell's rate is 0.8 of it, written into its mix.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the most the median admission wait may grow over a window of a sustained
# rate: about two 256-row prefill chunks of the 7B models
GROWTH_S = 0.5


def sweep_rate(cell, engine, tok, seed: int, seconds: float, rate: float, drain: float,
               device) -> dict:
    from benchmark import measure, serve
    from benchmark.layout import tensor_table
    from benchmark.roofline import ModelCost
    from benchmark.traffic import percentile
    from prima_tpu_torch.runtime.engine import SlotState

    mix = dict(cell.mix, rate_rps=rate, drain_cap_s=drain)
    run = serve.Run(cell.cfg, mix, seconds,
                    ModelCost(cell.cfg["model"], tensor_table(cell.cfg["model"],
                                                               cell.cfg["types"])), 0.0)
    serve.serve(run, engine, tok, seed, True, device, profile=False)
    for s in engine.slots:  # what the drain left running
        if s.state != SlotState.IDLE:
            engine.cancel(s.request_id)
        s.prompt = []
    win = run.window()
    ttft = [measure.ttft_s(run, s) for s in win]
    tpot = [measure.tpot_s(run, s) for s in win]
    waits = [run.admitted.get(s.gen.request_id, run.t_end) - s.due for s in win]
    q = max(1, len(win) // 4)
    failed = sum(not serve.finished(s) for s in win)
    growth = percentile(waits[-q:], 50) - percentile(waits[:q], 50)
    return {"seed": seed, "rate_rps": rate, "attempted": len(win), "failed": failed,
            "growth_ms": 1e3 * growth, "sustained": failed == 0 and growth < GROWTH_S,
            "ttft_p50_ms": 1e3 * percentile(ttft, 50), "ttft_p90_ms": 1e3 * percentile(ttft, 90),
            "tpot_p50_ms": 1e3 * percentile(tpot, 50), "tpot_p90_ms": 1e3 * percentile(tpot, 90),
            "output_tok_s": measure.output_tok_s(run),
            "admit_wait_first_quarter_ms": 1e3 * percentile(waits[:q], 50),
            "admit_wait_last_quarter_ms": 1e3 * percentile(waits[-q:], 50),
            "decode_step_ms": measure.decode_step_ms(run),
            "prefill_tok_s": measure.prefill_tok_s(run)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated; weights from the first")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated req/s")
    ap.add_argument("--drain", type=float, default=20.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import serve, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(x) for x in args.seeds.split(",")]
    engine, tok = serve.build(cell.cfg, cell.mix, seeds[0], device)
    serve.warm_up(engine, seeds[0])
    print(json.dumps({"workload": args.workload, "setup_s": time.perf_counter() - T_START,
                      "device": torch.cuda.get_device_name(device)}), flush=True)
    for seed in seeds:
        for r in args.rates.split(","):
            print(json.dumps(sweep_rate(cell, engine, tok, seed, args.seconds, float(r),
                                        args.drain, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
