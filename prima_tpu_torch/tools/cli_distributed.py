"""Distributed CLI flow: the llama_init_from_gpt_params bootstrap, then
decode over the TCP ring.

Counterpart of prima_tpu/tools/cli_distributed.py. One process per rank
(the reference's one command per device, README.md:232-268):

  rank 0: python -m prima_tpu_torch.tools.cli -m m.gguf -w 3 --rank 0 -p "..." [-lw 16,8,8] [-k 2]
  rank 1: python -m prima_tpu_torch.tools.cli -m m.gguf -w 3 --rank 1
  rank 2: python -m prima_tpu_torch.tools.cli -m m.gguf -w 3 --rank 2

Flow (common/common.cpp:1663-2003): ring TCP setup -> startup-args
broadcast -> device-profile gather -> rank 0 solves the layer windows
(or takes -lw) -> layer-setup broadcast -> each rank loads only its
layers -> the master drives decode, workers serve their windows, ranks
the solver removed relay. `-ngl N` keeps N layers of each window resident
and streams the rest from host memory; on one process it runs the
one-rank ring.
"""

from __future__ import annotations

import sys
import types


def parse_lw(s: str | None) -> list[int] | None:
    if not s:
        return None
    return [int(x) for x in s.split(",")]


def setup_ring(args):
    """Bootstrap one ring rank: connect (with the topology rebuild when
    --topo-grace is set), schedule through profile + MILP unless -lw is
    given, load this rank's layers with the resident/streamed split, and
    return what a master or a worker needs. Returns None when this rank
    got no layers (it relayed until STOP). Shared by the CLI and the ring
    server."""
    import torch

    from .. import resolve_device
    from ..gguf.reader import GGUFModel
    from ..models.config import ModelConfig, apply_rope_overrides
    from ..models.llama import ForwardOptions, gguf_host_layer, load_params
    from ..parallel.bootstrap import RingConfig, RingNode, bootstrap
    from ..parallel.ring_host import RingPlan
    from ..parallel.ring_tcp import RingContext, relay_loop
    from ..profiler.device import DeviceProfile, _mem_info, profile_device
    from ..profiler.model_cost import model_cost_from_gguf
    from ..runtime.streaming import pack_host_layer

    device = resolve_device(args.device)
    node = RingNode(RingConfig(rank=args.rank, world=args.world, master_ip=args.master_ip,
                               next_ip=args.next_ip, data_port=args.data_port))
    grace = getattr(args, "topo_grace", 0.0)  # the server has no --topo-grace
    if grace > 0:
        # llama_rebuild_topo analogue: the ring over the ranks that register
        # within the grace window, renumbered densely
        node.connect_ring_robust(grace=grace)
        if node.rank != args.rank or node.world != args.world:
            print(f"rebuild_topo: rank {args.rank} -> {node.rank}, "
                  f"world {args.world} -> {node.world}", file=sys.stderr)
        args.rank, args.world = node.rank, node.world
    else:
        node.connect_ring()

    m = GGUFModel.open(args.model)
    cfg = ModelConfig.from_gguf(m)
    # every rank ropes its own windows: the overrides apply on each
    apply_rope_overrides(
        cfg, rope_scaling=args.rope_scaling, rope_freq_base=args.rope_freq_base,
        rope_freq_scale=args.rope_freq_scale, yarn_orig_ctx=args.yarn_orig_ctx,
        yarn_ext_factor=args.yarn_ext_factor, yarn_attn_factor=args.yarn_attn_factor,
        yarn_beta_fast=args.yarn_beta_fast, yarn_beta_slow=args.yarn_beta_slow)
    if args.ctx_size == 0:  # -c 0: the model's training context (common.cpp)
        args.ctx_size = cfg.n_ctx_train
    cost = model_cost_from_gguf(m)
    manual_w = parse_lw(args.n_layer_window)
    if manual_w is not None and len(manual_w) != args.world:
        print(f"-lw has {len(manual_w)} entries but ring world is {args.world}; "
              "falling back to auto schedule", file=sys.stderr)
        manual_w = None
    if manual_w is None:
        profile = profile_device(device, full=True, bench_disk=False)
    else:
        # manual -lw skips profiling (common.cpp:1717)
        mi = _mem_info()
        profile = DeviceProfile(host_ram_total=mi["host_ram_total"],
                                host_ram_avail=mi["host_ram_avail"])
    res = bootstrap(node, profile, cost, n_ctx=args.ctx_size,
                    master_priority=getattr(args, "master_priority", 1.01),
                    force_k=args.n_cycles or None, manual_w=manual_w)
    if not res.is_active:
        # the reference's forwarder role: relay until STOP, then exit
        print("No layer is assigned to me; relaying.", file=sys.stderr)
        relay_loop(node)
        node.close()
        return None

    plan = RingPlan(windows=res.w, k=res.k)
    ctx = RingContext(node, plan, res.rank, res.world)
    ranges = plan.layer_ranges()[res.rank]
    owned = plan.owned(res.rank)
    print(f"rank {res.rank}/{res.world}: layers {sorted(owned)} (k={res.k})",
          file=sys.stderr)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    opts = ForwardOptions(matmul_impl=args.matmul,
                          dtype=dtypes[getattr(args, "dtype", "bf16")])
    # resident/streamed split: the last n[m] layers of each window stay on
    # the device (src/llama.cpp:7597-7605); the rest live in host memory and
    # stream in each cycle (manage_graph_tensors @18152). -ngl overrides n[m].
    n_res = args.n_gpu_layers if args.n_gpu_layers >= 0 else res.n[res.rank]
    streamed = set()
    for lo, hi in ranges:
        streamed.update(range(lo, hi - min(max(n_res, 0), hi - lo)))
    params = load_params(m, cfg, device, dtype=opts.dtype, fuse=args.fuse,
                         layer_filter=lambda i: i in owned and i not in streamed,
                         with_embedding=res.rank == 0, with_output=res.rank == 0)
    streamed_host = None
    if streamed:
        print(f"rank {res.rank}: streaming {len(streamed)} of {len(owned)} layers "
              "from host memory", file=sys.stderr)
        streamed_host = {i: pack_host_layer(gguf_host_layer(m, cfg, i, opts.dtype, args.fuse),
                                            pin=device.type == "cuda")
                         for i in sorted(streamed)}
    kv_dtype = dtypes.get(args.cache_type, args.cache_type)  # or "q8_0" / "q4_0"
    return types.SimpleNamespace(node=node, ctx=ctx, cfg=cfg, params=params, res=res, m=m,
                                 opts=opts, kv_dtype=kv_dtype, streamed_host=streamed_host,
                                 owned=owned, device=device)


def run_distributed(args, prompt: str) -> int:
    from ..models.loader import LoadedModel
    from ..parallel.ring_tcp import TcpRingEngine, TcpRingWorker
    from ..tokenizer import Tokenizer
    from .cli import _stream_generate, make_sampler

    rt = setup_ring(args)
    if rt is None:
        return 0
    if rt.res.rank != 0:
        TcpRingWorker(rt.ctx, rt.cfg, rt.params, max_seq=args.ctx_size, opts=rt.opts,
                      kv_dtype=rt.kv_dtype, streamed_host=rt.streamed_host,
                      device=rt.device).serve()
        rt.node.close()
        return 0

    # the master: the full ring engine (sampler chain, context shift,
    # Self-Extend, reverse prompts, conversation mode) through the same
    # streaming loop as the one-process CLI
    tok = Tokenizer.from_gguf(rt.m)
    model = LoadedModel(rt.cfg, rt.params, tok, rt.m)
    eng = TcpRingEngine(
        rt.ctx, rt.cfg, rt.params, n_slots=1, n_groups=1, max_seq=args.ctx_size,
        n_batch=max(1, min(args.batch_size, args.ctx_size)), opts=rt.opts,
        eog_ids=model.eog_ids, kv_dtype=rt.kv_dtype,
        ctx_shift=not args.no_context_shift and args.grp_attn_n == 1, n_keep=args.n_keep,
        grp_attn_n=args.grp_attn_n, grp_attn_w=args.grp_attn_w,
        streamed_host=rt.streamed_host, device=rt.device)
    # any failure on the master (an oversized prompt, Ctrl-C) must still
    # send STOP, or every worker blocks on its receive
    try:
        if args.conversation:
            from ..server.chat import apply_chat_template

            tmpl = args.chat_template or rt.m.get("tokenizer.chat_template")
            msgs = [{"role": "system", "content": prompt}] if prompt.strip() else []
            print("== conversation mode: empty line or Ctrl-D to exit ==", file=sys.stderr)
            while True:
                try:
                    line = input("> ")
                except EOFError:
                    break
                if not line.strip():
                    break
                msgs.append({"role": "user", "content": line})
                text = apply_chat_template(msgs, tmpl, tok.vocab, add_generation_prompt=True)
                toks = tok.encode(text, add_special=True, parse_special=True)
                sampler = make_sampler(args, model, tok.vocab.n_tokens)
                out = _stream_generate(eng, model, sampler, toks, args.n_predict,
                                       args.reverse_prompt)
                msgs.append({"role": "assistant", "content": out})
                print()
            return 0
        toks = tok.encode(prompt, add_special=True, parse_special=True)
        if not args.no_display_prompt:
            sys.stdout.write(prompt)
        sampler = make_sampler(args, model, tok.vocab.n_tokens)
        if args.model_draft and args.n_predict != 0:
            # distributed speculative decoding: the draft whole on rank 0
            # (server.cpp:715-733), the chain verified across the ring
            from ..models.loader import load_model
            from ..runtime.engine import Engine
            from ..runtime.speculative import SpeculativeDecoder

            dmodel = load_model(args.model_draft, device=rt.device)
            deng = Engine(dmodel.cfg, dmodel.params, n_slots=1, max_seq=args.ctx_size,
                          opts=rt.opts, eog_ids=dmodel.eog_ids, device=rt.device)
            spec = SpeculativeDecoder(eng, deng, n_draft=args.draft_max,
                                      p_min=args.draft_p_min)
            n = args.n_predict if args.n_predict > 0 else 128
            buf = b""
            for chunk in spec.generate_stream(toks, sampler, n):
                for t in chunk:
                    buf += tok.decode_token_bytes(t)
                    try:
                        sys.stdout.write(buf.decode("utf-8"))
                        buf = b""
                        sys.stdout.flush()
                    except UnicodeDecodeError:
                        continue
        else:
            _stream_generate(eng, model, sampler, toks, args.n_predict, args.reverse_prompt)
        sys.stdout.write("\n")
        if args.verbose:
            print(eng.perf_summary(), file=sys.stderr)
    finally:
        eng.stop()
        rt.node.close()
    return 0
