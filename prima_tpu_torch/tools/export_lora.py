"""prima-export-lora — merge LoRA adapters into a base GGUF.

Counterpart of prima_tpu/tools/export_lora.py: a host tool (numpy over GGUF
files, no device), the same output from the same inputs.

The llama-export-lora analogue (reference examples/export-lora/
export-lora.cpp): W' = W + sum_i scale_i * (B_i @ A_i). Tensors touched by
an adapter are written as F16 (export-lora.cpp:181); all other tensors and
every metadata KV are copied through unchanged.

Usage: python -m prima_tpu_torch.tools.export_lora -m base.gguf \
          --lora adapter.gguf [--lora-scaled other.gguf 0.5] -o merged.gguf
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter
from ..quant.dequant_np import dequantize_tensor


def load_adapter(path: str, user_scale: float) -> dict:
    """{base tensor name: (A f32 (r,K), B f32 (N,r), scale)}."""
    r = GGUFReader(path)
    if r.metadata.get("adapter.type", "lora") != "lora":
        raise ValueError(f"{path}: not a lora adapter gguf")
    alpha = float(r.metadata.get("adapter.lora.alpha", 0.0))
    pairs: dict[str, dict] = {}
    for name, ti in r.tensors.items():
        if name.endswith(".lora_a"):
            pairs.setdefault(name[: -len(".lora_a")], {})["a"] = ti
        elif name.endswith(".lora_b"):
            pairs.setdefault(name[: -len(".lora_b")], {})["b"] = ti
    out = {}
    for base, ab in pairs.items():
        if "a" not in ab or "b" not in ab:
            raise ValueError(f"{path}: missing lora_a/lora_b pair for {base}")
        a = dequantize_tensor(ab["a"])
        b = dequantize_tensor(ab["b"])
        rank = a.shape[0]
        scale = user_scale * (alpha / rank if alpha > 0 else 1.0)
        out[base] = (a, b, scale)
    return out


def export_lora(model: str, adapters: list[tuple[str, float]], output: str,
                verbose: bool = False) -> int:
    """Merge and write; returns the number of merged tensors."""
    base = GGUFReader(model)
    loaded = [load_adapter(p, s) for p, s in adapters]

    w = GGUFWriter(output)
    for key, value in base.metadata.items():
        w.add_kv(key, value)

    n_merged = 0
    for name, ti in base.tensors.items():
        deltas = [ad[name] for ad in loaded if name in ad]
        if not deltas:
            w.add_tensor(name, bytes(ti.data.tobytes())
                         if isinstance(ti.data, np.ndarray) else bytes(ti.data),
                         ne=ti.ne, ggml_type=ti.ggml_type)
            continue
        x = dequantize_tensor(ti)  # (N, K) f32
        for a, b, scale in deltas:
            if (b.shape[0], a.shape[1]) != x.shape:
                raise ValueError(
                    f"{name}: adapter shape {(b.shape[0], a.shape[1])} "
                    f"!= base {x.shape}")
            x = x + np.float32(scale) * (b @ a)
        w.add_tensor(name, x.astype(np.float16))
        n_merged += 1
        if verbose:
            print(f"merged {name} {x.shape}", file=sys.stderr)
    w.write()
    return n_merged


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-export-lora", description=__doc__)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--lora", action="append", default=[], metavar="FNAME")
    ap.add_argument("--lora-scaled", action="append", default=[], nargs=2,
                    metavar=("FNAME", "SCALE"))
    ap.add_argument("-o", "--output", default="ggml-lora-merged-f16.gguf")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    adapters = [(p, 1.0) for p in args.lora] + [
        (p, float(s)) for p, s in args.lora_scaled]
    if not adapters:
        ap.error("at least one --lora / --lora-scaled required")
    n = export_lora(args.model, adapters, args.output, verbose=args.verbose)
    print(f"merged {n} tensors with lora adapters -> {args.output}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
