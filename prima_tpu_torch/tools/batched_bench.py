"""prima-batched-bench — batched decoding benchmark over the Engine.

Counterpart of prima_tpu/tools/batched_bench.py on one device (CUDA unless
--device cpu).

The llama-batched-bench analogue (reference examples/batched-bench): for
every (PP, TG, PL) combination, prefill PL parallel sequences with PP
prompt tokens each, then decode TG tokens per sequence through the
continuous-batching engine, and print the reference's markdown table
(T_PP/S_PP/T_TG/S_TG/T/S columns).

Usage: python -m prima_tpu_torch.tools.batched_bench -m model.gguf \
           -npp 128,256 -ntg 64 -npl 1,2,4 [-c 2048]
"""

from __future__ import annotations

import argparse
import sys
import time


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-batched-bench", description=__doc__)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-npp", type=_ints, default=[128], help="prompt sizes")
    ap.add_argument("-ntg", type=_ints, default=[64], help="gen sizes")
    ap.add_argument("-npl", type=_ints, default=[1, 2, 4], help="batch counts")
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("-b", "--batch-size", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    import numpy as np

    from ..models.llama import ForwardOptions
    from ..models.loader import load_model
    from ..runtime.engine import Engine, SlotState
    from ..sampling import Sampler, SamplerParams

    print(f"loading {args.model} ...", file=sys.stderr)
    model = load_model(args.model, device=args.device)
    n_vocab = model.cfg.n_vocab
    rng = np.random.default_rng(0)

    print("|    PP |     TG |    B |   N_KV |   T_PP s | S_PP t/s |   T_TG s "
          "| S_TG t/s |      T s |    S t/s |")
    print("|-------|--------|------|--------|----------|----------|----------"
          "|----------|----------|----------|")

    for pl in args.npl:
        engine = Engine(model.cfg, model.params, n_slots=pl,
                        max_seq=args.ctx_size, n_batch=args.batch_size,
                        opts=ForwardOptions(matmul_impl=args.matmul),
                        eog_ids=set(),  # ignore EOG: fixed-length decode
                        device=args.device)
        for pp in args.npp:
            for tg in args.ntg:
                n_kv = pl * (pp + tg)
                if pp + tg >= args.ctx_size:
                    print(f"| {pp:5d} | {tg:6d} | {pl:4d} | skipped: "
                          f"pp+tg >= ctx ({args.ctx_size}) |")
                    continue
                prompts = [rng.integers(1, n_vocab, size=pp).tolist()
                           for _ in range(pl)]
                t0 = time.perf_counter()
                slots = [engine.submit(p, sampler=Sampler(SamplerParams(temp=0.0)),
                                       n_predict=tg, reuse_prefix=False)
                         for p in prompts]
                while any(s.state == SlotState.PREFILL for s in slots):
                    for s in slots:
                        if s.state == SlotState.PREFILL:
                            engine._advance_prefill(s)
                engine._sync()  # the prefill's kernels, not their enqueue
                t_pp = time.perf_counter() - t0

                t0 = time.perf_counter()
                while any(s.state == SlotState.DECODE for s in slots):
                    engine.step()
                t_tg = time.perf_counter() - t0
                for s in slots:
                    s.state = SlotState.IDLE

                n_gen = sum(len(s.generated) for s in slots)
                t_total = t_pp + t_tg
                s_pp = pl * pp / t_pp if t_pp > 0 else float("inf")
                s_tg = n_gen / t_tg if t_tg > 0 else float("inf")
                s_all = (pl * pp + n_gen) / t_total
                print(f"| {pp:5d} | {tg:6d} | {pl:4d} | {n_kv:6d} "
                      f"| {t_pp:8.3f} | {s_pp:8.2f} | {t_tg:8.3f} "
                      f"| {s_tg:8.2f} | {t_total:8.3f} | {s_all:8.2f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
