"""prima-imatrix — importance matrix collection over a calibration corpus.

Counterpart of prima_tpu/tools/imatrix.py on one device (CUDA unless
--device cpu; --matmul kernel|plain stands in for pallas|xla). The
analogue of examples/imatrix/imatrix.cpp: runs the model over n_ctx
chunks of a text corpus, accumulating per-input-column sum(x^2) for every
matmul weight (via the forward pass's activation taps), and writes the
llama.cpp-compatible .imatrix file that prima-quantize --imatrix consumes.

  python -m prima_tpu_torch.tools.imatrix -m model.gguf -f calib.txt -o out.imatrix
"""

from __future__ import annotations

import argparse
import sys
import time


def chunk_taps(model, toks, opts) -> dict:
    """name -> (per-column sum of x^2 f32 numpy, row count) of one chunk of
    token ids toks (n,) on their device, run from position 0 over a fresh
    bf16 cache of n cells (the JAX tool's chunk_taps closure). The sums
    come back to the host in one copy."""
    import torch

    from ..models.llama import forward, init_kv_caches

    n, dev = toks.shape[0], toks.device
    kv = init_kv_caches(model.cfg, 1, n, torch.bfloat16, dev)
    positions = torch.arange(n, dtype=torch.int32, device=dev)[None]
    taps: dict = {}
    with torch.no_grad():
        forward(model.params, model.cfg, toks[None], positions, kv,
                torch.zeros(1, dtype=torch.int32, device=dev), opts, taps=taps)
    flat = torch.cat([ssq for ssq, _ in taps.values()]).cpu().numpy()
    out, at = {}, 0
    for name, (ssq, cnt) in taps.items():
        out[name] = (flat[at:at + ssq.shape[0]], cnt)
        at += ssq.shape[0]
    return out


def collect_imatrix(model, text: str, n_ctx: int = 512, matmul: str = "kernel",
                    max_chunks: int = 0, logfile=sys.stderr, device="cuda") -> dict:
    """-> stats dict: name -> [sum_sq f64 (n_cols,), n_tokens, ncall]."""
    import numpy as np

    from .. import resolve_device
    from ..models.llama import ForwardOptions
    from ..runtime.generate import to_device

    dev = resolve_device(device)
    opts = ForwardOptions(matmul_impl=matmul)
    tokens = model.tokenizer.encode(text, add_special=True)
    n_chunks = len(tokens) // n_ctx
    if max_chunks:
        n_chunks = min(n_chunks, max_chunks)
    if n_chunks < 1:
        raise ValueError(f"need at least {n_ctx} tokens, got {len(tokens)}")

    stats: dict = {}
    t0 = time.time()
    for c in range(n_chunks):
        chunk = np.asarray(tokens[c * n_ctx:(c + 1) * n_ctx], np.int64)
        for name, (ssq, cnt) in chunk_taps(model, to_device(chunk, dev), opts).items():
            prev = stats.get(name)
            if prev is None:
                stats[name] = [np.asarray(ssq, np.float64), int(cnt), 1]
            else:
                prev[0] += ssq
                prev[1] += int(cnt)
                prev[2] += 1
        print(f"[{c + 1}/{n_chunks}] {time.time() - t0:.1f}s", file=logfile)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-imatrix", description=__doc__)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", required=True, help="calibration text")
    ap.add_argument("-o", "--output", default="imatrix.dat")
    ap.add_argument("-c", "--n-ctx", type=int, default=512)
    ap.add_argument("--chunks", type=int, default=0, help="max chunks (0 = all)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    from ..models.loader import load_model
    from ..quant.quantize_imatrix import save_imatrix

    model = load_model(args.model, device=args.device)
    text = open(args.file, encoding="utf-8").read()
    stats = collect_imatrix(model, text, n_ctx=args.n_ctx, matmul=args.matmul,
                            max_chunks=args.chunks, device=args.device)
    # stored form: (sum_sq / n_tokens) * ncall (imatrix.cpp:265-277)
    out = {
        name: (((ssq / max(cnt, 1)) * ncall).astype("float32"), ncall)
        for name, (ssq, cnt, ncall) in stats.items()
    }
    last_call = max((v[1] for v in out.values()), default=0)
    save_imatrix(args.output, out, last_call, dataset=args.file)
    print(f"stored {len(out)} entries ({last_call} chunks) in {args.output}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
