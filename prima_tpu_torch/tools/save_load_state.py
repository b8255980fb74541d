"""prima-save-load-state — state round-trip correctness demo.

Counterpart of prima_tpu/tools/save_load_state.py on one device (CUDA unless
--device cpu).

The llama-save-load-state analogue (reference
examples/save-load-state/save-load-state.cpp:55-231): evaluate a prompt,
serialize the sequence state to disk, sample a continuation; then restore
the state into a FRESH engine and sample again with the same seed — the
two generations must match token for token. A third leg restores the
state into a *different* slot id (the llama_state_seq_get/set_data
seq-copy leg, save-load-state.cpp:188-205) and checks again.

  python -m prima_tpu_torch.tools.save_load_state -m model.gguf -p "..." -n 24

Exit 0 iff all generations are identical.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def _generate(eng, slot, n: int) -> list[int]:
    from ..runtime.engine import SlotState

    while slot.state != SlotState.IDLE:
        eng.step()
    return list(slot.generated)[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-save-load-state",
                                 description=__doc__)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="The quick brown fox")
    ap.add_argument("-n", "--n-predict", type=int, default=24)
    ap.add_argument("-s", "--seed", type=int, default=42)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    from ..models.llama import ForwardOptions
    from ..models.loader import load_model
    from ..runtime import state as rstate
    from ..runtime.engine import Engine
    from ..sampling import Sampler, SamplerParams

    model = load_model(args.model, device=args.device)
    opts = ForwardOptions(matmul_impl=args.matmul)
    max_seq = args.n_predict + 256

    def new_engine():
        return Engine(model.cfg, model.params, n_slots=2, max_seq=max_seq,
                      opts=opts, eog_ids=model.eog_ids, device=args.device)

    def new_sampler():
        return Sampler(SamplerParams(temp=args.temp, seed=args.seed),
                       n_vocab=model.cfg.n_vocab)

    toks = model.tokenizer.encode(args.prompt, add_special=True)
    path = os.path.join(tempfile.mkdtemp(prefix="prima-state-"), "dump_state.bin")

    # first run: eval prompt, save state, then generate
    eng = new_engine()
    slot = eng.submit(toks, sampler=new_sampler(), n_predict=args.n_predict)
    eng.prefill_only(slot)
    n_saved = rstate.slot_save(eng, slot.id, path)
    run1 = _generate(eng, slot, args.n_predict)
    print(f"saved state: {n_saved} tokens -> {path}", file=sys.stderr)
    print("first run: " + args.prompt + model.tokenizer.decode(run1))

    # second run: FRESH engine, restore, same seed -> identical tokens
    eng2 = new_engine()
    rstate.slot_restore(eng2, 0, path)
    slot2 = eng2.submit(toks, sampler=new_sampler(),
                        n_predict=args.n_predict, reuse_prefix=True)
    run2 = _generate(eng2, slot2, args.n_predict)
    print("second run: " + args.prompt + model.tokenizer.decode(run2))
    if run2 != run1:
        print("error: the 2 generations are different", file=sys.stderr)
        return 1

    # third run: restore the same state into BOTH slot ids (the seq-copy
    # leg, save-load-state.cpp:188-205) and decode them concurrently —
    # each batched generation must still reproduce run 1.
    eng3 = new_engine()
    rstate.slot_restore(eng3, 0, path)
    rstate.slot_restore(eng3, 1, path)
    slot_a = eng3.submit(toks, sampler=new_sampler(),
                         n_predict=args.n_predict, reuse_prefix=True)
    slot_b = eng3.submit(toks, sampler=new_sampler(),
                         n_predict=args.n_predict, reuse_prefix=True)
    assert {slot_a.id, slot_b.id} == {0, 1}
    from ..runtime.engine import SlotState

    while slot_a.state != SlotState.IDLE or slot_b.state != SlotState.IDLE:
        eng3.step()
    for name, s in (("seq-0", slot_a), ("seq-1", slot_b)):
        run3 = list(s.generated)[: args.n_predict]
        print(f"{name} run: " + args.prompt + model.tokenizer.decode(run3))
        if run3 != run1:
            print(f"error: {name} seq-restore generation differs",
                  file=sys.stderr)
            return 1

    print("success: all generations match", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
