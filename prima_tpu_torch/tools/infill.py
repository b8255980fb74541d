"""prima-infill — fill-in-the-middle code completion CLI.

Counterpart of prima_tpu/tools/infill.py on one device (CUDA unless
--device cpu).

The llama-infill analogue (reference examples/infill/infill.cpp): builds
the FIM prompt from --in-prefix/--in-suffix (PSM order, or SPM with
--spm-infill), generates until EOG or the middle token, and optionally
loops interactively reading new prefix/suffix pairs.

Usage: python -m prima_tpu_torch.tools.infill -m model.gguf \\
          --in-prefix "def add(a, b):\\n    " --in-suffix "\\n    return c" \\
          -n 32 [--spm-infill] [-i]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    def env(name, default=None):
        return os.environ.get(f"LLAMA_ARG_{name}", default)

    ap = argparse.ArgumentParser(prog="prima-infill", description=__doc__)
    ap.add_argument("-m", "--model", default=env("MODEL"),
                    required=env("MODEL") is None)
    ap.add_argument("--in-prefix", default="", help="code before the hole")
    ap.add_argument("--in-suffix", default="", help="code after the hole")
    ap.add_argument("--spm-infill", action="store_true",
                    help="suffix-prefix-middle prompt order")
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("-s", "--seed", type=int, default=-1)
    ap.add_argument("-i", "--interactive", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    from ..models.llama import ForwardOptions
    from ..models.loader import load_model
    from ..runtime.engine import Engine
    from ..sampling import Sampler, SamplerParams
    from ..tokenizer.fim import build_infill_prompt, detect_fim_tokens

    print(f"loading {args.model} ...", file=sys.stderr)
    model = load_model(args.model, device=args.device)
    fim = detect_fim_tokens(model.tokenizer.vocab)
    if fim is None:
        print("error: model has no FIM (infill) special tokens",
              file=sys.stderr)
        return 1
    middle_id = fim[2]
    # stop at EOG or at a generated middle token (infill.cpp:221,425-432)
    eog = set(model.eog_ids) | {middle_id}

    eng = Engine(model.cfg, model.params, n_slots=1, max_seq=args.ctx_size,
                 opts=ForwardOptions(matmul_impl=args.matmul), eog_ids=eog, device=args.device)

    def unescape(s: str) -> str:
        return s.replace("\\n", "\n").replace("\\t", "\t")

    def fill(prefix: str, suffix: str) -> str:
        toks = build_infill_prompt(model.tokenizer, prefix, suffix,
                                   spm_infill=args.spm_infill)
        sampler = Sampler(SamplerParams(
            temp=args.temp, seed=args.seed if args.seed >= 0 else 0xFFFFFFFF,
        ), n_vocab=model.cfg.n_vocab)
        out = eng.run_to_completion(toks, sampler=sampler,
                                    n_predict=args.n_predict)
        if out and out[-1] in eog:
            out = out[:-1]
        return model.tokenizer.decode(out)

    prefix, suffix = unescape(args.in_prefix), unescape(args.in_suffix)
    print(prefix + fill(prefix, suffix) + suffix)
    while args.interactive:
        try:
            prefix = input("in-prefix> ")
            if not prefix:
                break
            suffix = input("in-suffix> ")
        except EOFError:
            break
        prefix, suffix = unescape(prefix), unescape(suffix)
        print(prefix + fill(prefix, suffix) + suffix)
    return 0


if __name__ == "__main__":
    sys.exit(main())
