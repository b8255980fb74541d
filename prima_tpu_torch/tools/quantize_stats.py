"""prima-quantize-stats — per-tensor quantization error statistics.

Counterpart of prima_tpu/tools/quantize_stats.py: a host tool (numpy
over GGUF files, no device), the same output from the same inputs.

The llama-quantize-stats analogue (reference examples/quantize-stats):
round-trips every (or a filtered set of) weight tensor through quantize ->
dequantize for each requested type and reports RMSE, max error, and the
fraction of elements beyond error quantiles, against the f32 reference.

Usage: python -m prima_tpu_torch.tools.quantize_stats -m model.gguf
           [--type q4_K --type q8_0 ...] [--include-layer REGEX]
           [--exclude-layer REGEX] [--per-layer-stats]
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFModel
from ..quant.dequant_np import dequantize, dequantize_tensor
from ..quant.quantize_np import QUANTIZE_FNS, quantize

_IQ_TYPES = {GGMLType.IQ1_S, GGMLType.IQ1_M, GGMLType.IQ2_XXS,
             GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ3_XXS,
             GGMLType.IQ3_S}

DEFAULT_TYPES = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0",
                 "q2_K", "q3_K", "q4_K", "q5_K", "q6_K"]


def _stats(err: np.ndarray) -> dict:
    e2 = err * err
    return {
        "rmse": float(np.sqrt(e2.mean())),
        "max": float(np.abs(err).max()),
        "p95": float(np.quantile(np.abs(err), 0.95)),
        "median": float(np.median(np.abs(err))),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-quantize-stats", description=__doc__)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--type", action="append", default=[], dest="types",
                    help="quant type to evaluate (repeatable); default: all")
    ap.add_argument("-l", "--include-layer", action="append", default=[])
    ap.add_argument("-L", "--exclude-layer", action="append", default=[])
    ap.add_argument("-p", "--per-layer-stats", action="store_true")
    args = ap.parse_args(argv)

    names = args.types or DEFAULT_TYPES
    types = []
    for n in names:
        t = GGMLType[n.upper()]
        if (t not in QUANTIZE_FNS and t not in _IQ_TYPES
                and t not in (GGMLType.F16, GGMLType.BF16)):
            print(f"note: no encoder for {t.name}, skipping", file=sys.stderr)
            continue
        types.append(t)

    m = GGUFModel.open(args.model)
    sel = []
    for name, ti in m.tensors.items():
        if len(ti.ne) != 2 or ti.ne[0] % 256:
            continue  # 2D row-quantizable tensors only (as the reference)
        if args.include_layer and not any(re.search(p, name) for p in args.include_layer):
            continue
        if args.exclude_layer and any(re.search(p, name) for p in args.exclude_layer):
            continue
        sel.append((name, ti))
    if not sel:
        print("no tensors selected", file=sys.stderr)
        return 1
    print(f"testing {len(sel)} tensors x {len(types)} types", file=sys.stderr)

    for t in types:
        errs = []
        for name, ti in sel:
            x = dequantize_tensor(ti)
            raw = quantize(x, t)
            y = dequantize(raw, t, x.shape[-1])
            err = (y - x).ravel()
            errs.append(err)
            if args.per_layer_stats:
                s = _stats(err)
                print(f"{t.name:8s} {name:40s} rmse {s['rmse']:.6f} "
                      f"max {s['max']:.6f} p95 {s['p95']:.6f}")
        s = _stats(np.concatenate(errs))
        print(f"{t.name:8s} total: rmse {s['rmse']:.8f}, maxerr {s['max']:.6f}, "
              f"95pct<{s['p95']:.4f}, median<{s['median']:.4f}")
    m.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
