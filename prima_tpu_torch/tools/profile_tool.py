"""profile-tool: run the full device profile and print the capability table.

Counterpart of prima_tpu/tools/profile_tool.py on one device (CUDA unless
--device cpu), the analogue of tools/profile_tool.cpp: optionally loads a
GGUF for the model cost model and prints the suggested layer assignment
for 1 device.

  python -m prima_tpu_torch.tools.profile_tool [-m model.gguf] [--json] [--no-disk]
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile-tool", description=__doc__)
    ap.add_argument("-m", "--model", help="GGUF to derive the model cost from")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--no-disk", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = ap.parse_args(argv)

    from ..profiler import model_cost_from_gguf, print_device_props, profile_device

    p = profile_device(args.device, bench_disk=not args.no_disk)
    if args.json:
        out = p.to_dict()
    else:
        print(print_device_props(p))

    if args.model:
        from ..gguf.reader import GGUFModel
        from ..sched import assign_layers

        m = GGUFModel.open(args.model)
        cost = model_cost_from_gguf(m)
        if args.json:
            out["model"] = {
                "n_layers": cost.n_layers,
                "n_params": cost.n_params,
                "layer_bytes": cost.layer_bytes,
                "head_bytes": cost.head_bytes,
            }
        else:
            print(f"\nmodel: {cost.n_layers} layers, {cost.n_params/1e9:.2f}B params, "
                  f"{cost.layer_bytes/2**20:.1f} MiB/layer")
            res = assign_layers([p], cost)
            print(f"single-device plan: w={res.w} n={res.n} k={res.k} "
                  f"est {res.objective*1e3:.1f} ms/token")
    if args.json:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
