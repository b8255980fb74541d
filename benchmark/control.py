"""The control of a cell's comparison, and the readings its limit is set from.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds 10

For each seed, in one process: the cell as a run drives it (its lead-in,
its window and its drain, at the cell's own load), then, over the same
greedy requests that the run compares, the readings of the program's
served tokens against the f32 reference, of the tokens that the reference
put first when computed in float8 (the control: the nearest precision
below the configuration's bfloat16), and of the tokens that the reference
put first in bfloat16 (the model's own sensitivity to the stated
precision). For a mixture of experts all three follow the program's
experts, and the float8 and bfloat16 references' own routers are judged
as the program's is (`route_mismatch_share`, `route_mismatch_lead`, the
margins, each layer's share). One JSON line a seed on standard output.
The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_readings(cell, seed: int, seconds: float, device, t_start: float) -> dict:
    from benchmark import check, serve
    from benchmark.layout import tensor_table
    from benchmark.roofline import ModelCost

    engine, tok = serve.build(cell.cfg, cell.mix, seed, device)
    serve.warm_up(engine, seed)
    run = serve.Run(cell.cfg, cell.mix, seconds,
                    ModelCost(cell.cfg["model"], tensor_table(cell.cfg["model"],
                                                               cell.cfg["types"])), t_start)
    serve.serve(run, engine, tok, seed, False, device)
    serve.free(engine)
    del engine
    picked = check.pick(run, seed)
    routes = check.program_routes(run, picked)
    ref, r32 = check.reference(cell.cfg, seed, picked, device, routes=routes)
    out = {"seed": seed, "tokens": sum(s.req.n_out for s in picked),
           "program": check.readings(ref, check.served(picked, device))}
    lead = cell.cfg["correct"].get("route_lead_layers")
    if routes is not None:
        out["program"].update(check.router_readings(r32, lead))
    for prec in ("fp8", "bf16"):
        low, _ = check.reference(cell.cfg, seed, picked, device, prec, routes)
        out[prec] = check.readings(ref, [lg.argmax(-1) for lg in low])
        del low
        if routes is not None:
            # this precision's own router, judged as the program's is: for
            # fp8 the control, for bf16 a witness of what rounding alone
            # makes of the router at each depth
            _, own = check.reference(cell.cfg, seed, picked, device, prec)
            _, r = check.reference(cell.cfg, seed, picked, device, routes=own.chosen)
            out[prec].update(check.router_readings(r, lead))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = control_readings(cell, int(s), args.seconds, device, t)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
