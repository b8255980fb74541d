"""prima-eval-callback — per-tensor activation inspection for one prompt.

Counterpart of prima_tpu/tools/eval_callback.py on one device (CUDA unless
--device cpu; --matmul kernel|plain stands in for pallas|xla). The
analogue of examples/eval-callback (reference
examples/eval-callback/eval-callback.cpp): runs a single forward pass and
prints, for every matmul input the forward taps (the same hook imatrix
uses, models/llama.py:_tap), the activation RMS and column statistics,
followed by a logits summary — the debugging surface for "which layer
went wrong" comparisons between builds or quantizations.

Usage:
  python -m prima_tpu_torch.tools.eval_callback -m model.gguf -p "Hello world"
"""

from __future__ import annotations

import argparse
import sys


def run_taps(model, toks: list, matmul: str = "kernel", device="cuda") -> tuple:
    """One f32 forward of toks (f32 logits, an f32 cache of len + 8
    cells): (last row's logits f64 numpy, {name: (sum of x^2 f32 numpy,
    row count)}), read back in one copy."""
    import numpy as np
    import torch

    from .. import resolve_device
    from ..models.llama import ForwardOptions, forward, init_kv_caches
    from ..runtime.generate import to_device

    dev = resolve_device(device)
    cfg = model.cfg
    opts = ForwardOptions(matmul_impl=matmul, dtype=torch.float32,
                          logits_dtype=torch.float32)
    t = to_device(np.asarray([toks], np.int64), dev)
    kv = init_kv_caches(cfg, 1, len(toks) + 8, torch.float32, dev)
    pos = torch.arange(t.shape[1], dtype=torch.int32, device=dev)[None]
    taps: dict = {}
    with torch.no_grad():
        logits, _ = forward(model.params, cfg, t, pos, kv,
                            torch.zeros(1, dtype=torch.int32, device=dev), opts, taps=taps)
    n_vocab = logits.shape[-1]
    flat = torch.cat([logits[0, -1].float()] + [ssq for ssq, _ in taps.values()]).cpu()
    flat = flat.numpy()
    last, at, out = flat[:n_vocab].astype(np.float64), n_vocab, {}
    for name, (ssq, cnt) in taps.items():
        out[name] = (flat[at:at + ssq.shape[0]], cnt)
        at += ssq.shape[0]
    return last, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="Hello world")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    ap.add_argument("--top", type=int, default=5,
                    help="top-N logits to print")
    args = ap.parse_args(argv)

    import numpy as np

    from ..models.loader import load_model

    model = load_model(args.model, device=args.device)
    toks = model.tokenizer.encode(args.prompt, add_special=True,
                                  parse_special=True)
    last, taps = run_taps(model, toks, args.matmul, args.device)

    def order(n: str):
        # execution order: embedding-side first, then by layer index
        parts = n.split(".")
        return ((int(parts[1]), n) if parts[0] == "blk" else (10**9, n))

    print(f"{'tensor':<28} {'rms':>12} {'col_min':>12} {'col_max':>12}")
    for name in sorted(taps, key=order):
        ssq, cnt = taps[name]
        col_ms = np.asarray(ssq, np.float64) / max(int(cnt), 1)
        rms = float(np.sqrt(col_ms.mean()))
        print(f"{name:<28} {rms:>12.6f} {np.sqrt(col_ms.min()):>12.6f} "
              f"{np.sqrt(col_ms.max()):>12.6f}")

    exp = np.exp(last - last.max())
    probs = exp / exp.sum()
    top = np.argsort(-last)[: args.top]
    print(f"\nlogits: mean={last.mean():.4f} std={last.std():.4f} "
          f"max={last.max():.4f}")
    for t in top:
        piece = model.tokenizer.decode([int(t)])
        print(f"  {int(t):>7} {probs[t]:.4f} {piece!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
