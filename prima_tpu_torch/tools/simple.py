"""prima-simple — the minimal API example.

Counterpart of prima_tpu/tools/simple.py, the llama-simple analogue
(reference examples/simple/simple.cpp): load a GGUF, tokenize a prompt,
greedy-decode n tokens with the barest possible loop, print the result and
the timing line. Start here to learn the API.

  python -m prima_tpu_torch.tools.simple -m model.gguf -p "Hello my name is" -n 32
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-simple", description=__doc__)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="Hello my name is")
    ap.add_argument("-n", "--n-predict", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    from ..models.llama import ForwardOptions
    from ..models.loader import load_model
    from ..runtime.engine import Engine

    model = load_model(args.model, device=args.device)  # GGUF -> params
    eng = Engine(model.cfg, model.params, n_slots=1,    # decode loop
                 max_seq=args.n_predict + 256,
                 opts=ForwardOptions(matmul_impl=args.matmul),
                 eog_ids=model.eog_ids, device=args.device)
    toks = model.tokenizer.encode(args.prompt, add_special=True)

    t0 = time.perf_counter()
    out = eng.run_to_completion(toks, n_predict=args.n_predict)  # greedy
    dt = time.perf_counter() - t0

    sys.stdout.write(args.prompt + model.tokenizer.decode(out) + "\n")
    print(f"decoded {len(out)} tokens in {dt:.2f} s, "
          f"speed: {len(out) / dt:.2f} t/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
