"""prima-bench — pp/tg benchmark matrix over model files or synth shapes.

Counterpart of prima_tpu/tools/bench_tool.py on one device (CUDA unless
--device cpu), the analogue of examples/llama-bench/llama-bench.cpp: times
prompt processing (pp: one batched forward over n_prompt tokens) and token
generation (tg: n_gen sequential single-token greedy decodes) for every
combination of the requested sizes, repeats each test and reports
mean +- stddev tok/s in markdown / csv / json / jsonl.

  python -m prima_tpu_torch.tools.bench_tool -m model.gguf -p 512 -n 128 -o md
  python -m prima_tpu_torch.tools.bench_tool --synth 8b -p 0 -n 64 -b 1,8 -o json

Timing: one untimed run of the test first, then each repetition is a host
clock around the Python loop of forwards, closed by a device synchronize,
so it counts the device's work and the host's time to launch it. --synth
builds the shape's Q4_K weights on the device from a seed (no file IO).
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import sys
import time


def _ints(csv: str) -> list[int]:
    return [int(x) for x in csv.split(",") if x != ""]


SYNTH_SHAPES = {
    # name -> tiny_config kwargs (Llama-3-8B / 1B-ish shapes)
    "8b": dict(n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=8, head_dim=128,
               n_ff=14336, n_vocab=128256, n_ctx_train=8192, rope_base=500000.0,
               rope_dim=128),
    "1b": dict(n_layers=16, n_embd=2048, n_heads=32, n_kv_heads=8, head_dim=64,
               n_ff=8192, n_vocab=128256, rope_dim=64),
    "tiny": dict(n_layers=4, n_embd=1024, n_heads=16, n_kv_heads=8, head_dim=64,
                 n_ff=2816, n_vocab=32000, rope_dim=64),
}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_test(cfg, params, opts, *, batch: int, n_prompt: int, n_gen: int,
             ctx: int, reps: int, device) -> dict:
    """One matrix cell; returns timing stats."""
    import torch

    from ..models.llama import forward, init_kv_caches

    B = batch
    T = max(ctx, n_prompt + n_gen + 2)
    kv = init_kv_caches(cfg, B, T, torch.bfloat16, device)

    if n_prompt > 0:
        toks = torch.ones((B, n_prompt), dtype=torch.int64, device=device)
        positions = torch.arange(n_prompt, dtype=torch.int32,
                                 device=device)[None].expand(B, n_prompt)
        zeros = torch.zeros(B, dtype=torch.int32, device=device)

        def once():
            logits, _ = forward(params, cfg, toks, positions, kv, zeros, opts)
            return logits[:, -1].argmax(-1)
        n_tok = n_prompt
    else:
        pos0 = torch.ones(B, dtype=torch.int32, device=device)

        def once():
            token = torch.ones((B, 1), dtype=torch.int64, device=device)
            for i in range(n_gen):
                pos = pos0 + i
                logits, _ = forward(params, cfg, token, pos[:, None], kv, pos, opts)
                token = logits[:, -1].argmax(-1)[:, None]
            return token
        n_tok = n_gen

    times = []
    with torch.no_grad():
        once()
        _sync(device)
        for _r in range(reps):
            t0 = time.perf_counter()
            once()
            _sync(device)
            times.append(n_tok * B / (time.perf_counter() - t0))

    return {
        "avg_ts": statistics.fmean(times),
        "stddev_ts": statistics.stdev(times) if len(times) > 1 else 0.0,
        "max_ts": max(times),
        "n_tokens": n_tok,
    }


def params_nbytes(tree) -> int:
    """Bytes of a params tree: quantized tensors at their stored size."""
    import torch

    from ..quant.qtensor import QTensor

    if isinstance(tree, QTensor):
        return tree.nbytes
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(params_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(params_nbytes(v) for v in tree)
    return 0


def fmt_markdown(rows: list[dict]) -> str:
    hdr = ["model", "size", "params", "backend", "n_batch", "test", "t/s"]
    out = ["| " + " | ".join(hdr) + " |",
           "| " + " | ".join("-" * len(h) for h in hdr) + " |"]
    for r in rows:
        out.append("| {model} | {size_gib:.2f} GiB | {n_params_b:.2f} B | {backend} "
                   "| {n_batch} | {test} | {avg_ts:.2f} ± {stddev_ts:.2f} |".format(**r))
    return "\n".join(out)


def fmt_csv(rows: list[dict]) -> str:
    keys = list(rows[0].keys())
    lines = [",".join(keys)]
    for r in rows:
        lines.append(",".join(str(r[k]) for k in keys))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-bench", description=__doc__)
    ap.add_argument("-m", "--model", help="GGUF file (or use --synth)")
    ap.add_argument("--synth", choices=sorted(SYNTH_SHAPES),
                    help="synthetic Q4_K weights of a named shape (no file IO)")
    ap.add_argument("-p", "--n-prompt", default="512", type=_ints,
                    help="CSV prompt sizes; 0 skips the pp test")
    ap.add_argument("-n", "--n-gen", default="128", type=_ints,
                    help="CSV generation lengths; 0 skips the tg test")
    ap.add_argument("-b", "--batch-size", default="1", type=_ints)
    ap.add_argument("-c", "--ctx-size", type=int, default=1024)
    ap.add_argument("-r", "--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    ap.add_argument("-o", "--output", default="md",
                    choices=["md", "csv", "json", "jsonl"])
    args = ap.parse_args(argv)
    if not args.model and not args.synth:
        ap.error("need -m or --synth")

    import torch

    from .. import resolve_device
    from ..models.llama import ForwardOptions

    dev = resolve_device(args.device)
    opts = ForwardOptions(matmul_impl=args.matmul)
    if args.model:
        from ..models.loader import load_model

        model = load_model(args.model, device=dev)
        cfg, params = model.cfg, model.params
        name = args.model.rsplit("/", 1)[-1]
    else:
        from ..gguf.constants import GGMLType
        from ..models.config import tiny_config
        from ..models.llama import synth_params_device

        cfg = tiny_config(**SYNTH_SHAPES[args.synth])
        params = synth_params_device(cfg, GGMLType.Q4_K, seed=0, device=dev)
        _sync(dev)
        name = f"synth-{args.synth}-Q4_K"

    n_params = cfg.n_layers * (
        cfg.n_embd * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
        + cfg.n_heads * cfg.head_dim * cfg.n_embd + 3 * cfg.n_embd * cfg.n_ff
    ) + 2 * cfg.n_vocab * cfg.n_embd

    base = {
        "model": name,
        "size_gib": params_nbytes(params) / 2**30,
        "n_params_b": n_params / 1e9,
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "matmul": args.matmul,
        "host": platform.node(),
    }

    rows = []
    for b in args.batch_size:
        for p in args.n_prompt:
            if p > 0:
                r = run_test(cfg, params, opts, batch=b, n_prompt=p, n_gen=0,
                             ctx=args.ctx_size, reps=args.reps, device=dev)
                rows.append({**base, "n_batch": b, "test": f"pp{p}", **r})
                print(f"  pp{p} b={b}: {r['avg_ts']:.2f} t/s", file=sys.stderr)
        for g in args.n_gen:
            if g > 0:
                r = run_test(cfg, params, opts, batch=b, n_prompt=0, n_gen=g,
                             ctx=args.ctx_size, reps=args.reps, device=dev)
                rows.append({**base, "n_batch": b, "test": f"tg{g}", **r})
                print(f"  tg{g} b={b}: {r['avg_ts']:.2f} t/s", file=sys.stderr)

    if args.output == "md":
        print(fmt_markdown(rows))
    elif args.output == "csv":
        print(fmt_csv(rows))
    elif args.output == "json":
        print(json.dumps(rows, indent=2))
    else:
        for r in rows:
            print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
