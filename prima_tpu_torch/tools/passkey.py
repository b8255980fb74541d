"""prima-passkey — long-context passkey retrieval self-test.

Counterpart of prima_tpu/tools/passkey.py on one device (CUDA unless
--device cpu).

The llama-passkey analogue (reference examples/passkey): hide a random
number inside `--junk` repetitions of filler text, ask the model to repeat
it, and report whether it was recovered. Exercises long-context attention
(combine with --grp-attn-n/--grp-attn-w Self-Extend).

Usage: python -m prima_tpu_torch.tools.passkey -m model.gguf [--junk 250]
          [--pos N] [-c 4096] [-gan 1] [-gaw 512]
"""

from __future__ import annotations

import argparse
import random
import sys

JUNK = ("The grass is green. The sky is blue. The sun is yellow. "
        "Here we go. There and back again. ")


def build_prompt(n_junk: int, i_pos: int, passkey: int) -> str:
    parts = ["There is an important info hidden inside a lot of irrelevant "
             "text. Find it and memorize it. I will quiz you about the "
             "important information there.\n"]
    for i in range(n_junk):
        if i == i_pos:
            parts.append(f"The pass key is {passkey}. Remember it. "
                         f"{passkey} is the pass key.\n")
        parts.append(JUNK)
    parts.append("\nWhat is the pass key? The pass key is")
    return "".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-passkey", description=__doc__)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--junk", type=int, default=250)
    ap.add_argument("--pos", type=int, default=-1)
    ap.add_argument("-c", "--ctx-size", type=int, default=8192)
    ap.add_argument("-n", "--n-predict", type=int, default=16)
    ap.add_argument("-s", "--seed", type=int, default=-1)
    ap.add_argument("-gan", "--grp-attn-n", type=int, default=1)
    ap.add_argument("-gaw", "--grp-attn-w", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    rng = random.Random(args.seed if args.seed >= 0 else None)
    i_pos = args.pos if args.pos >= 0 else rng.randrange(args.junk)
    passkey = rng.randrange(1, 50001)
    prompt = build_prompt(args.junk, i_pos, passkey)

    from ..models.llama import ForwardOptions
    from ..models.loader import load_model
    from ..runtime.engine import Engine

    print(f"loading {args.model} ...", file=sys.stderr)
    model = load_model(args.model, device=args.device)
    toks = model.tokenizer.encode(prompt, add_special=True, parse_special=True)
    print(f"prompt: {len(toks)} tokens, passkey at junk position {i_pos}",
          file=sys.stderr)
    if len(toks) + args.n_predict >= args.ctx_size:
        print(f"error: prompt ({len(toks)}) does not fit in ctx "
              f"({args.ctx_size}); raise -c or use -gan/-gaw", file=sys.stderr)
        return 1

    engine = Engine(model.cfg, model.params, n_slots=1, max_seq=args.ctx_size,
                    opts=ForwardOptions(matmul_impl=args.matmul),
                    eog_ids=model.eog_ids, grp_attn_n=args.grp_attn_n,
                    grp_attn_w=args.grp_attn_w, device=args.device)
    out = engine.run_to_completion(toks, n_predict=args.n_predict)
    text = model.tokenizer.decode(out)
    print(f"response: {text!r}")
    ok = str(passkey) in text
    print(f"passkey {passkey}: {'FOUND' if ok else 'NOT FOUND'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
