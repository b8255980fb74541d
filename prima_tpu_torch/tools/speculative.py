"""prima-speculative — draft/target speculative-decoding demo.

Counterpart of prima_tpu/tools/speculative.py on one device (CUDA unless
--device cpu).

The llama-speculative analogue (reference examples/speculative/
speculative.cpp): loads a target and a draft GGUF, generates with batched
draft-verify, and reports acceptance statistics. The draft model is whole
and replicated (speculative.cpp:73-76); the target may be any engine.

Usage: python -m prima_tpu_torch.tools.speculative -m target.gguf -md draft.gguf \
          -p "prompt" -n 64 [--draft 8] [--draft-p-min 0.75]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    def env(name, default=None):
        return os.environ.get(f"LLAMA_ARG_{name}", default)

    ap = argparse.ArgumentParser(prog="prima-speculative", description=__doc__)
    ap.add_argument("-m", "--model", default=env("MODEL"),
                    required=env("MODEL") is None)
    ap.add_argument("-md", "--model-draft", required=True)
    ap.add_argument("-p", "--prompt", default="Hello")
    ap.add_argument("-f", "--file", help="read prompt from file")
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--draft", type=int, default=8,
                    help="max tokens drafted per round (--draft-max)")
    ap.add_argument("--draft-p-min", type=float, default=0.75,
                    help="draft confidence floor (common/speculative.h)")
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("-s", "--seed", type=int, default=-1)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    from ..models.llama import ForwardOptions
    from ..models.loader import load_model
    from ..runtime.engine import Engine
    from ..runtime.speculative import SpeculativeDecoder
    from ..sampling import Sampler, SamplerParams

    opts = ForwardOptions(matmul_impl=args.matmul)
    print(f"loading target {args.model} ...", file=sys.stderr)
    target = load_model(args.model, device=args.device)
    print(f"loading draft {args.model_draft} ...", file=sys.stderr)
    draft = load_model(args.model_draft, device=args.device)

    t_eng = Engine(target.cfg, target.params, n_slots=1, max_seq=args.ctx_size,
                   opts=opts, eog_ids=target.eog_ids, device=args.device)
    d_eng = Engine(draft.cfg, draft.params, n_slots=1, max_seq=args.ctx_size,
                   opts=opts, eog_ids=draft.eog_ids, device=args.device)
    spec = SpeculativeDecoder(t_eng, d_eng, n_draft=args.draft,
                              p_min=args.draft_p_min)

    prompt = open(args.file).read() if args.file else args.prompt
    toks = target.tokenizer.encode(prompt, add_special=True, parse_special=True)
    sampler = Sampler(SamplerParams(
        temp=args.temp, seed=args.seed if args.seed >= 0 else 0xFFFFFFFF,
    ), n_vocab=target.cfg.n_vocab)

    t0 = time.perf_counter()
    out, stats = spec.generate(toks, sampler=sampler, n_predict=args.n_predict)
    dt = time.perf_counter() - t0

    sys.stdout.write(prompt + target.tokenizer.decode(out) + "\n")
    n = len(out)
    print(f"\nencoded {len(toks)} tokens, generated {n} in {dt:.2f}s "
          f"({n / dt:.2f} t/s)", file=sys.stderr)
    print(f"n_draft      = {args.draft}", file=sys.stderr)
    print(f"n_drafted    = {stats.n_drafted}", file=sys.stderr)
    print(f"n_accepted   = {stats.n_accepted}", file=sys.stderr)
    print(f"accept rate  = {stats.acceptance:.3f}", file=sys.stderr)
    print(f"target calls = {stats.n_target_calls}  "
          f"draft calls = {stats.n_draft_calls}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
