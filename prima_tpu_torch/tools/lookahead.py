"""prima-lookahead — lookahead decoding demo (draft-model-free speculation).

Counterpart of prima_tpu/tools/lookahead.py on one device (CUDA unless
--device cpu).

The llama-lookahead analogue (reference examples/lookahead/lookahead.cpp):
generates with Jacobi-iteration lookahead + n-gram verification and reports
per-step acceptance statistics. W/N/G defaults mirror lookahead.cpp:48-50.

Usage: python -m prima_tpu_torch.tools.lookahead -m model.gguf -p "prompt" -n 64 \
          [--lookahead-w 15] [--lookahead-n 5] [--lookahead-g 15]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    def env(name, default=None):
        return os.environ.get(f"LLAMA_ARG_{name}", default)

    ap = argparse.ArgumentParser(prog="prima-lookahead", description=__doc__)
    ap.add_argument("-m", "--model", default=env("MODEL"),
                    required=env("MODEL") is None)
    ap.add_argument("-p", "--prompt", default="Hello")
    ap.add_argument("-f", "--file", help="read prompt from file")
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--lookahead-w", type=int, default=15,
                    help="lookahead window width W")
    ap.add_argument("--lookahead-n", type=int, default=5,
                    help="n-gram size N")
    ap.add_argument("--lookahead-g", type=int, default=15,
                    help="max verification n-grams G")
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("-s", "--seed", type=int, default=-1)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    from ..models.llama import ForwardOptions
    from ..models.loader import load_model
    from ..runtime.engine import Engine
    from ..runtime.lookahead import LookaheadDecoder
    from ..sampling import Sampler, SamplerParams

    opts = ForwardOptions(matmul_impl=args.matmul)
    print(f"loading {args.model} ...", file=sys.stderr)
    model = load_model(args.model, device=args.device)

    eng = Engine(model.cfg, model.params, n_slots=1, max_seq=args.ctx_size,
                 opts=opts, eog_ids=model.eog_ids, device=args.device)
    la = LookaheadDecoder(eng, W=args.lookahead_w, N=args.lookahead_n,
                          G=args.lookahead_g)

    prompt = open(args.file).read() if args.file else args.prompt
    toks = model.tokenizer.encode(prompt, add_special=True, parse_special=True)
    sampler = Sampler(SamplerParams(
        temp=args.temp, seed=args.seed if args.seed >= 0 else 0xFFFFFFFF,
    ), n_vocab=model.cfg.n_vocab)

    t0 = time.perf_counter()
    out, stats = la.generate(toks, sampler=sampler, n_predict=args.n_predict)
    dt = time.perf_counter() - t0

    sys.stdout.write(prompt + model.tokenizer.decode(out) + "\n")
    print(f"\nW = {la.W}\nN = {la.N}\nG = {la.G}\n"
          f"n_predict = {stats.n_predict}\nn_accept  = {stats.n_accept}\n"
          f"steps = {stats.n_steps} "
          f"({stats.tokens_per_step:.2f} tokens/step)\n"
          f"decoded {stats.n_predict} tokens in {dt:.3f}s "
          f"({stats.n_predict / dt:.2f} t/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
