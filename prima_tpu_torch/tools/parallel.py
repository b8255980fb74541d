"""prima-parallel — multi-client continuous-batching simulation.

Counterpart of prima_tpu/tools/parallel.py on one device (CUDA unless
--device cpu).

The llama-parallel analogue (reference examples/parallel/parallel.cpp): a
pool of simulated clients submits `--sequences` total requests through
`--parallel` engine slots; decoding is continuously batched (one forward
per tick serves every active client), finished slots are immediately
re-assigned, and the tool reports aggregate prompt/decode throughput and
per-client latencies.

Usage: python -m prima_tpu_torch.tools.parallel -m model.gguf -np 4 -ns 16 -n 32
"""

from __future__ import annotations

import argparse
import os
import sys
import time

QUESTIONS = [
    "What is the capital of France?",
    "Explain photosynthesis in one sentence.",
    "Write a haiku about distributed systems.",
    "Why is the sky blue?",
    "Name three uses for a paperclip.",
    "Summarize the plot of Hamlet.",
    "How do vaccines work?",
    "What makes a good unit test?",
    "Describe the water cycle.",
    "What is the Pythagorean theorem?",
]

SYSTEM = ("A chat between a curious user and a helpful assistant. The "
          "assistant answers concisely and accurately.\n")


def main(argv=None) -> int:
    def env(name, default=None):
        return os.environ.get(f"LLAMA_ARG_{name}", default)

    ap = argparse.ArgumentParser(prog="prima-parallel", description=__doc__)
    ap.add_argument("-m", "--model", default=env("MODEL"),
                    required=env("MODEL") is None)
    ap.add_argument("-np", "--parallel", type=int, default=4,
                    help="simultaneous clients (engine slots)")
    ap.add_argument("-ns", "--sequences", type=int, default=8,
                    help="total requests to serve")
    ap.add_argument("-n", "--n-predict", type=int, default=32,
                    help="max tokens per response")
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("-s", "--seed", type=int, default=1234)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    ap.add_argument("--no-system", action="store_true",
                    help="skip the shared system preamble")
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

    system = "" if args.no_system else SYSTEM
    pending = list(range(args.sequences))
    results: dict[int, dict] = {}
    slot_req: dict[int, int] = {}  # slot id -> request seq number
    n_prompt_total = 0

    def submit_next() -> bool:
        if not pending or eng.find_idle_slot() is None:
            return False
        seq = pending.pop(0)
        q = QUESTIONS[seq % len(QUESTIONS)]
        toks = model.tokenizer.encode(f"{system}User: {q}\nAssistant:",
                                      add_special=True)
        sampler = Sampler(SamplerParams(temp=args.temp, seed=args.seed + seq),
                          n_vocab=model.cfg.n_vocab)
        slot = eng.submit(toks, sampler=sampler, n_predict=args.n_predict,
                          request_id=seq)
        slot_req[slot.id] = seq
        results[seq] = {"question": q, "tokens": [], "t_start": time.perf_counter(),
                        "n_prompt": len(toks)}
        nonlocal n_prompt_total
        n_prompt_total += len(toks)
        return True

    t0 = time.perf_counter()
    while submit_next():
        pass
    n_decoded = n_done = 0
    from ..runtime.engine import SlotState

    while n_done < args.sequences:
        events = eng.step()
        if not events:
            # [] also happens on prefill-only ticks — keep stepping while
            # any slot is still ingesting its prompt
            if any(s.state == SlotState.PREFILL for s in eng.slots):
                continue
            if not submit_next():
                break  # nothing active and nothing left to submit
            continue
        for ev in events:
            seq = slot_req.get(ev.slot_id)
            if seq is None:
                continue
            if ev.token is not None:
                results[seq]["tokens"].append(ev.token)
                n_decoded += 1
            if ev.done:
                results[seq]["t_done"] = time.perf_counter()
                results[seq]["reason"] = ev.reason
                del slot_req[ev.slot_id]
                n_done += 1
                submit_next()
    dt = time.perf_counter() - t0

    for seq in sorted(results):
        r = results[seq]
        text = model.tokenizer.decode(r["tokens"]).strip()
        lat = r.get("t_done", time.perf_counter()) - r["t_start"]
        print(f"[seq {seq:3d}] ({lat:6.2f}s, {len(r['tokens'])} tok, "
              f"{r.get('reason')}) Q: {r['question']!r}\n"
              f"          A: {text[:120]!r}")

    print(f"\nn_parallel = {args.parallel}, n_sequences = {args.sequences}",
          file=sys.stderr)
    print(f"prompt tokens: {n_prompt_total}, decoded tokens: {n_decoded} "
          f"in {dt:.2f}s ({(n_prompt_total + n_decoded) / dt:.1f} tok/s "
          f"aggregate, {eng.n_decode_calls} decode calls)", file=sys.stderr)
    print(eng.perf_summary(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
