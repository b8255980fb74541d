"""Multi-process TCP-ring continuous-batching runner.

Counterpart of prima_tpu/tools/ring_serve.py. Rank 0 drives a
TcpRingEngine (slots and the full sampler chain) over the wire protocol;
worker ranks run the batched window service loop. Rank 0 prints the
generated token ids of each prompt as one JSON list:

  python -m prima_tpu_torch.tools.ring_serve -m m.gguf -w 2 --rank 0 \\
      --data-port 9000 -lw 2,2 --slots 4 --prompts-json '[[1,2,3],...]'
  python -m prima_tpu_torch.tools.ring_serve -m m.gguf -w 2 --rank 1 --data-port 9000 -lw 2,2
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-ring-serve-torch")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("-w", "--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--master-ip", default="127.0.0.1")
    ap.add_argument("--next-ip", default="127.0.0.1")
    ap.add_argument("--data-port", type=int, required=True)
    ap.add_argument("-lw", "--n-layer-window", required=True,
                    help="CSV windows, e.g. 2,2")
    ap.add_argument("-k", "--n-cycles", type=int, default=1)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--groups", type=int, default=0,
                    help="ubatch groups (0 = one per ring hop)")
    ap.add_argument("-c", "--ctx-size", type=int, default=128)
    ap.add_argument("-n", "--n-predict", type=int, default=6)
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    ap.add_argument("--prompts-json", default=None,
                    help="rank 0: JSON list of token-id lists")
    ap.add_argument("-gan", "--grp-attn-n", type=int, default=1)
    ap.add_argument("-gaw", "--grp-attn-w", type=int, default=512)
    ap.add_argument("--ctx-shift", action="store_true",
                    help="context shift on a full context (ring-replicated)")
    ap.add_argument("--n-keep", type=int, default=0)
    ap.add_argument("--stagger", action="store_true",
                    help="rank 0: submit prompts across successive steps")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..gguf.reader import GGUFModel
    from ..models.config import ModelConfig
    from ..models.llama import ForwardOptions, load_params
    from ..parallel.bootstrap import RingConfig, RingNode
    from ..parallel.ring_host import RingPlan
    from ..parallel.ring_tcp import (RingContext, TcpRingEngine, TcpRingWorker,
                                     default_groups)
    from ..runtime.engine import SlotState

    device = resolve_device(args.device)
    windows = [int(x) for x in args.n_layer_window.split(",")]
    if len(windows) != args.world:
        raise SystemExit(f"-lw has {len(windows)} windows for a ring of {args.world}")
    plan = RingPlan(windows=windows, k=args.n_cycles)
    n_groups = args.groups or default_groups(args.world, args.slots)
    node = RingNode(RingConfig(rank=args.rank, world=args.world, master_ip=args.master_ip,
                               next_ip=args.next_ip, data_port=args.data_port))
    node.connect_ring()
    ctx = RingContext(node, plan, args.rank, args.world)
    m = GGUFModel.open(args.model)
    cfg = ModelConfig.from_gguf(m)
    owned = plan.owned(args.rank)
    opts = ForwardOptions(matmul_impl=args.matmul)
    params = load_params(m, cfg, device, layer_filter=owned.__contains__,
                         with_embedding=args.rank == 0, with_output=args.rank == 0)
    if args.rank != 0:
        TcpRingWorker(ctx, cfg, params, max_seq=args.ctx_size, opts=opts,
                      n_slots=args.slots, n_groups=n_groups, device=device).serve()
        node.close()
        return 0

    from ..tokenizer import Tokenizer

    v = Tokenizer.from_gguf(m).vocab
    eng = TcpRingEngine(ctx, cfg, params, n_slots=args.slots, n_groups=n_groups,
                        max_seq=args.ctx_size, n_batch=16, opts=opts,
                        eog_ids={t for t in (v.eos_id, v.eot_id) if t >= 0},
                        ctx_shift=args.ctx_shift, n_keep=args.n_keep,
                        grp_attn_n=args.grp_attn_n, grp_attn_w=args.grp_attn_w,
                        device=device)
    try:
        pending = list(json.loads(args.prompts_json or "[[1,2,3]]"))
        slots = []

        def submit():
            slots.append(eng.submit(pending.pop(0), n_predict=args.n_predict,
                                    request_id=len(slots)))

        submit()
        while pending and not args.stagger:  # all at once, or one a step
            submit()
        while pending or any(s.state != SlotState.IDLE for s in slots):
            eng.step()
            if pending:
                submit()
        print(json.dumps([s.generated for s in slots]))
        print(eng.perf_summary(), file=sys.stderr)
    finally:
        eng.stop()
        node.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
