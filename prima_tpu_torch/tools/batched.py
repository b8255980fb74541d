"""prima-batched — N parallel continuations of one prompt.

Counterpart of prima_tpu/tools/batched.py, the llama-batched analogue
(reference examples/batched/batched.cpp): decode the prompt once, fork it
into -np sequences (Engine.fork copies the slot's cache row, the role of
llama_kv_cache_seq_cp, batched.cpp:139-143), then decode all sequences in
one batched forward per step with sampled continuations.

Usage: python -m prima_tpu_torch.tools.batched -m model.gguf \\
          -p "Hello my name is" -np 4 -n 32 [--temp 0.8] [-s 1234]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    def env(name, default=None):
        return os.environ.get(f"LLAMA_ARG_{name}", default)

    ap = argparse.ArgumentParser(prog="prima-batched", description=__doc__)
    ap.add_argument("-m", "--model", default=env("MODEL"),
                    required=env("MODEL") is None)
    ap.add_argument("-p", "--prompt", default="Hello my name is")
    ap.add_argument("-np", "--parallel", type=int, default=4)
    ap.add_argument("-n", "--n-predict", type=int, default=32)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.94)
    ap.add_argument("-s", "--seed", type=int, default=1234)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    from ..models.llama import ForwardOptions
    from ..models.loader import load_model
    from ..runtime.engine import Engine
    from ..sampling import Sampler, SamplerParams

    print(f"loading {args.model} ...", file=sys.stderr)
    model = load_model(args.model, device=args.device)
    eng = Engine(model.cfg, model.params, n_slots=args.parallel,
                 max_seq=args.ctx_size,
                 opts=ForwardOptions(matmul_impl=args.matmul),
                 eog_ids=model.eog_ids, device=args.device)
    toks = model.tokenizer.encode(args.prompt, add_special=True)

    # decode the prompt ONCE, then fork it into n_parallel sequences — the
    # llama_kv_cache_seq_cp fork (batched.cpp:131-143)
    def sampler_for(i):
        return Sampler(SamplerParams(
            temp=args.temp, top_k=args.top_k, top_p=args.top_p,
            seed=args.seed + i), n_vocab=model.cfg.n_vocab)

    first = eng.submit(toks, sampler=sampler_for(0),
                       n_predict=args.n_predict, request_id=0)
    eng.prefill_only(first)
    for i in range(1, args.parallel):
        eng.fork(first, sampler=sampler_for(i), n_predict=args.n_predict,
                 request_id=i)

    out: dict[int, list[int]] = {i: [] for i in range(args.parallel)}
    t0 = time.perf_counter()
    live = set(range(args.parallel))
    while live:
        events = eng.step()
        if not events:
            break  # all forked slots start in DECODE; [] means none left
        for ev in events:
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
            if ev.done:
                live.discard(ev.request_id)
    dt = time.perf_counter() - t0

    n_decoded = sum(len(v) for v in out.values())
    for i in range(args.parallel):
        text = model.tokenizer.decode(out[i])
        print(f"sequence {i}:\n\n{args.prompt}{text}\n")
    print(f"decoded {n_decoded} tokens in {dt:.2f} s, "
          f"speed: {n_decoded / dt:.2f} t/s "
          f"({eng.n_decode_calls} decode calls)", file=sys.stderr)
    print(eng.perf_summary(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
