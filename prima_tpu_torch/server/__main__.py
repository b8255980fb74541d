"""prima-server for the port: python -m prima_tpu_torch.server -m model.gguf

Counterpart of prima_tpu/server/__main__.py on one device (CUDA unless
--device cpu), with LoRA adapters (--lora, --lora-scaled) and speculative
decoding with a draft model (-md). With -w > 1 it serves over the TCP
ring: every rank runs the command with its --rank, rank 0 answers HTTP
over a TcpRingEngine and the others serve their windows (-lw, -k, -ngl as
in the CLI). With --pp / --tp / --dp it serves over the mesh
(parallel/engine.DistributedEngine): this process is rank 0 and spawns the
other ranks of its host. A bert / nomic-bert GGUF is served by serve_embeddings
(/v1/embeddings, /v1/rerank). `-c 0` takes the GGUF's context_length key
(2048 without it) before any branch, as the JAX server does.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys


def _load_api_keys(args) -> list[str]:
    """--api-key flags plus one key per line of --api-key-file."""
    keys = list(args.api_key or [])
    if args.api_key_file:
        with open(args.api_key_file) as f:
            keys += [ln.strip() for ln in f if ln.strip()]
    return keys


def build_parser() -> argparse.ArgumentParser:
    def env(name, default=None):
        return os.environ.get(f"LLAMA_ARG_{name}", default)

    ap = argparse.ArgumentParser(prog="prima-server-torch")
    ap.add_argument("-m", "--model", default=env("MODEL"), required=env("MODEL") is None)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--host", default=env("HOST", "127.0.0.1"))
    ap.add_argument("--port", type=int, default=int(env("PORT", 8080)))
    ap.add_argument("-c", "--ctx-size", type=int, default=int(env("CTX_SIZE", 2048)))
    ap.add_argument("-np", "--parallel", type=int, default=int(env("N_PARALLEL", 4)),
                    help="number of server slots")
    ap.add_argument("-b", "--batch-size", type=int, default=256)
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"],
                    help="kernel = fused dequant-GEMV; plain = dequantize + "
                         "torch.matmul")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                    help="activation dtype")
    ap.add_argument("--fuse", action="store_true",
                    help="fuse Q/K/V and gate/up weights at load where quant "
                         "types match (fewer GEMV launches per layer)")
    ap.add_argument("-ctk", "--cache-type-k", default="bf16",
                    choices=["f32", "bf16", "q8_0", "q4_0"], dest="cache_type")
    ap.add_argument("--alias", default="prima-tpu")
    ap.add_argument("--lora", action="append", default=[], metavar="FNAME",
                    help="LoRA adapter GGUF (repeatable)")
    ap.add_argument("--lora-scaled", action="append", default=[], nargs=2,
                    metavar=("FNAME", "SCALE"),
                    help="LoRA adapter GGUF with user scale (repeatable)")
    ap.add_argument("-md", "--model-draft", default=env("MODEL_DRAFT"),
                    help="draft model GGUF for speculative decoding")
    ap.add_argument("--draft-max", "--draft", type=int, default=8, dest="draft_max",
                    help="max tokens drafted per round")
    ap.add_argument("--draft-p-min", type=float, default=0.75,
                    help="draft confidence floor")
    ap.add_argument("--rope-scaling", choices=["none", "linear", "yarn"], default=None)
    ap.add_argument("--rope-freq-base", type=float, default=0.0)
    ap.add_argument("--rope-freq-scale", type=float, default=0.0)
    ap.add_argument("--yarn-orig-ctx", type=int, default=0)
    ap.add_argument("--yarn-ext-factor", type=float, default=-1.0)
    ap.add_argument("--yarn-attn-factor", type=float, default=-1.0)
    ap.add_argument("--yarn-beta-fast", type=float, default=-1.0)
    ap.add_argument("--yarn-beta-slow", type=float, default=-1.0)
    ap.add_argument("--no-context-shift", action="store_true",
                    help="stop at context_full instead of shifting")
    ap.add_argument("--keep", type=int, default=0,
                    help="tokens to keep at the start on context shift")
    ap.add_argument("-gan", "--grp-attn-n", type=int, default=1,
                    help="Self-Extend group factor (disables context shift)")
    ap.add_argument("-gaw", "--grp-attn-w", type=int, default=512,
                    help="Self-Extend group window")
    ap.add_argument("--slot-save-path", default=env("SLOT_SAVE_PATH"),
                    help="confine /slots save/restore files to this dir")
    ap.add_argument("--api-key", action="append", default=None, metavar="KEY")
    ap.add_argument("--api-key-file", default=env("API_KEY_FILE"))
    ap.add_argument("--override-kv", action="append", default=[],
                    metavar="KEY=TYPE:VALUE")
    # distributed (mesh) mode: serve a piped-ring pipelined model, the
    # analogue of llama-server driving the distributed ring
    # (server.cpp:2431 llama_decode(ctx, batch_view, true))
    ap.add_argument("--pp", type=int, default=int(env("PP", 1)),
                    help="pipeline stages (layer windows over the mesh)")
    ap.add_argument("--tp", type=int, default=int(env("TP", 1)),
                    help="tensor-parallel ranks per stage")
    ap.add_argument("--dp", type=int, default=int(env("DP", 1)),
                    help="data-parallel replicas")
    ap.add_argument("-k", "--n-cycles", type=int, default=0,
                    help="piped-ring cycles per token (reference -k; "
                         "0 = solver-chosen in ring mode, 1 in mesh mode)")
    # multi-process (TCP ring) mode: one server process per rank, rank 0
    # serves HTTP (the reference's llama-server -w/--rank flow)
    ap.add_argument("-w", "--world", type=int, default=int(env("WORLD", 1)),
                    help="TCP ring size (1 = no ring)")
    ap.add_argument("--rank", type=int, default=int(env("RANK", 0)))
    ap.add_argument("-mip", "--master-ip", default="127.0.0.1")
    ap.add_argument("-nip", "--next-ip", default="127.0.0.1")
    ap.add_argument("--data-port", type=int, default=9337)
    ap.add_argument("-lw", "--n-layer-window", default=None,
                    help="CSV layer windows per rank (manual mode)")
    ap.add_argument("-ngl", "--n-gpu-layers", type=int, default=-1,
                    help="ring mode: device-resident layers per window, the rest "
                         "stream from host memory (default: the scheduler's n[m])")
    from ..utils.args import apply_env_defaults

    apply_env_defaults(ap)  # PRIMA_ARG_* / LLAMA_ARG_* fallbacks
    return ap


def _unported(args) -> str | None:
    """The first requested option this port does not carry yet: none is
    left, every option of the JAX server is served."""
    return None


def probe_gguf(args) -> str:
    """The GGUF's arch, read before anything loads; `-c 0` becomes the
    raw `{arch}.context_length` key, or 2048 without it, for every branch
    (prima_tpu/server/__main__.py:114-121). --override-kv does not reach
    this key, as it does not in the JAX server."""
    from ..gguf.reader import GGUFModel

    probe = GGUFModel.open(args.model)
    arch = probe.arch
    if args.ctx_size == 0:  # -c 0: the model's training context (common.cpp)
        # read the KV directly: encoder archs (bert) have no decoder config
        args.ctx_size = int(probe.get(f"{arch}.context_length") or 2048)
    probe.close()
    return arch


def _embeddings_main(args) -> int:
    """An encoder GGUF: /v1/embeddings and /v1/rerank only."""
    from ..models.bert import BertModelRuntime
    from .app import serve_embeddings

    rt = BertModelRuntime.load(args.model, device=args.device)
    rt.embed(["warmup"], matmul_impl=args.matmul)
    httpd = serve_embeddings(rt, args.host, args.port, args.alias, args.matmul)
    print(f"embeddings server on http://{args.host}:{args.port}", file=sys.stderr,
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(f"loading {args.model} ...", file=sys.stderr)
    # bert and nomic-bert serve embeddings; jina-bert-v2 falls through to
    # the decoder loader, as in the JAX server
    arch = probe_gguf(args)
    if arch in ("bert", "nomic-bert"):
        return _embeddings_main(args)
    if arch == "deepseek2" and (args.world > 1 or args.pp * args.tp * args.dp > 1):
        # latent attention runs on the single-device Engine only
        print("deepseek2 serves on one device: no ring (-w) or mesh (--pp / --tp / --dp)",
              file=sys.stderr)
        return 2
    what = _unported(args)
    if what is not None:
        print(f"{what} is not yet ported to prima_tpu_torch", file=sys.stderr)
        return 2

    if args.world > 1:
        return _ring_main(args)
    if args.pp * args.tp * args.dp > 1:
        return _mesh_main(args)

    import torch

    from ..models.config import apply_rope_overrides
    from ..models.llama import ForwardOptions
    from ..models.loader import load_model, parse_kv_override
    from ..runtime.engine import Engine
    from .app import serve

    lora_specs = [(p, 1.0) for p in args.lora] + [(p, float(s)) for p, s in args.lora_scaled]
    # LoRA adapters target the unfused tensor names: never fuse with one
    model = load_model(args.model, device=args.device, fuse=args.fuse and not lora_specs,
                       kv_overrides=dict(parse_kv_override(s) for s in args.override_kv))
    apply_rope_overrides(
        model.cfg, rope_scaling=args.rope_scaling, rope_freq_base=args.rope_freq_base,
        rope_freq_scale=args.rope_freq_scale, yarn_orig_ctx=args.yarn_orig_ctx,
        yarn_ext_factor=args.yarn_ext_factor, yarn_attn_factor=args.yarn_attn_factor,
        yarn_beta_fast=args.yarn_beta_fast, yarn_beta_slow=args.yarn_beta_slow)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    kv_dtype = dtypes.get(args.cache_type, args.cache_type)  # or "q8_0" / "q4_0"
    ctx_size = args.ctx_size
    opts = ForwardOptions(matmul_impl=args.matmul, dtype=dtypes[args.dtype])
    engine = Engine(model.cfg, model.params, n_slots=args.parallel, max_seq=ctx_size,
                    n_batch=args.batch_size, opts=opts,
                    eog_ids=model.eog_ids, kv_dtype=kv_dtype,
                    # Self-Extend disables context shift (server.cpp:2034)
                    ctx_shift=not args.no_context_shift and args.grp_attn_n == 1,
                    n_keep=args.keep, grp_attn_n=args.grp_attn_n,
                    grp_attn_w=args.grp_attn_w, device=args.device)
    bos = model.tokenizer.vocab.bos_id
    engine.run_to_completion([bos if bos >= 0 else 0], n_predict=1)  # warmup
    print("warmup done", file=sys.stderr)

    loras = []
    if lora_specs:
        from ..models.adapters import load_lora_gguf

        loras = [{"id": i, "path": path, "scale": scale,
                  "data": load_lora_gguf(path, scale=1.0, device=args.device)}
                 for i, (path, scale) in enumerate(lora_specs)]
    spec = None
    if args.model_draft:
        from ..runtime.speculative import SpeculativeDecoder

        print(f"loading draft {args.model_draft} ...", file=sys.stderr)
        dmodel = load_model(args.model_draft, device=args.device)
        # one draft slot per server slot: concurrent requests speculate at once
        deng = Engine(dmodel.cfg, dmodel.params, n_slots=args.parallel, max_seq=ctx_size,
                      opts=opts, eog_ids=dmodel.eog_ids, device=args.device)
        spec = SpeculativeDecoder(engine, deng, n_draft=args.draft_max,
                                  p_min=args.draft_p_min)
    httpd, _ctx = serve(model, engine, args.host, args.port, args.alias, loras=loras,
                        spec=spec, slot_save_dir=args.slot_save_path,
                        api_keys=_load_api_keys(args))
    if loras:
        _ctx.set_lora_scales([{"id": r["id"], "scale": r["scale"]} for r in loras])
    print(f"listening on http://{args.host}:{args.port}", file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        _ctx.worker.shutdown()
        httpd.server_close()
    return 0


def _interrupt(signum, frame):
    raise KeyboardInterrupt


# a worker rank waits this long for rank 0's next command: a server may sit
# idle between requests (the data collectives keep the mesh's own timeout)
MESH_IDLE_TIMEOUT = 30 * 86400.0


def _mesh_main(args) -> int:
    """Mesh-distributed serving (prima_tpu/server/__main__.py:157-197):
    slots live on the pipeline's microbatch grid (pp microbatches of
    ceil(-np / pp) rows, rounded up to a multiple of dp). This process is
    rank 0 (HTTP and the DistributedEngine) and spawns the other ranks of
    its host; hosts join through PRIMA_COORDINATOR / PRIMA_NUM_PROCS /
    PRIMA_PROC_ID (parallel/launch.py), where a launcher other than 0
    serves its ranks and no HTTP."""
    if args.lora or args.lora_scaled:
        print("--lora is not supported in mesh-distributed mode", file=sys.stderr)
        return 1
    import torch

    from ..models.llama import ForwardOptions
    from ..models.loader import LoadedModel
    from ..parallel.engine import DistributedEngine
    from ..parallel.launch import (RankPlan, build_rank, init_multihost, spawn_ranks,
                                   stop_ranks, worker_main)
    from ..tokenizer import Tokenizer
    from .app import serve

    shape = {"dp": args.dp, "pp": args.pp, "sp": 1, "tp": args.tp}
    world = args.dp * args.pp * args.tp
    init_method, n_procs, proc_id = init_multihost()
    if world % n_procs:
        print(f"a mesh of {world} ranks does not split over {n_procs} hosts", file=sys.stderr)
        return 1
    local = world // n_procs
    micro = max(args.pp, 1)
    bpm = max(1, -(-args.parallel // micro))  # slots = micro * bpm
    bpm = -(-bpm // args.dp) * args.dp  # dp shards the microbatch rows
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    plan = RankPlan(
        shape, init_method, ("gguf", args.model), k_cycles=args.n_cycles or 1,
        microbatches=micro,
        opts=ForwardOptions(matmul_impl=args.matmul, dtype=dtypes[args.dtype]),
        device=args.device,
        local_world=local, ctrl_timeout=MESH_IDLE_TIMEOUT,
        rope=dict(rope_scaling=args.rope_scaling, rope_freq_base=args.rope_freq_base,
                  rope_freq_scale=args.rope_freq_scale, yarn_orig_ctx=args.yarn_orig_ctx,
                  yarn_ext_factor=args.yarn_ext_factor,
                  yarn_attn_factor=args.yarn_attn_factor,
                  yarn_beta_fast=args.yarn_beta_fast, yarn_beta_slow=args.yarn_beta_slow))
    base = proc_id * local
    procs = spawn_ranks(worker_main, plan, range(base + 1, base + local))
    if proc_id != 0:
        try:
            worker_main(plan, base)
        finally:
            stop_ranks(procs)
        return 0
    engine = mesh = None
    try:
        mesh, cfg, spec, params, streamer = build_rank(plan, 0)
        from ..gguf.reader import GGUFModel

        m = GGUFModel.open(args.model)
        model = LoadedModel(cfg, params, Tokenizer.from_gguf(m), m)
        engine = DistributedEngine(
            cfg, params, spec, mesh, batch_per_micro=bpm, max_seq=args.ctx_size,
            n_batch=args.batch_size, opts=plan.opts,
            kv_dtype=dtypes.get(args.cache_type, args.cache_type),
            eog_ids=model.eog_ids, ctx_shift=not args.no_context_shift and args.grp_attn_n == 1,
            n_keep=args.keep, grp_attn_n=args.grp_attn_n, grp_attn_w=args.grp_attn_w,
            streamer=streamer)
        bos = model.tokenizer.vocab.bos_id
        engine.run_to_completion([bos if bos >= 0 else 0], n_predict=1)  # warmup
        print("warmup done", file=sys.stderr)
        spec_dec = None
        if args.model_draft:
            # the draft whole on rank 0, the target verified over the mesh
            # (prima_tpu/runtime/speculative.py:14)
            from ..models.loader import load_model
            from ..runtime.engine import Engine
            from ..runtime.speculative import SpeculativeDecoder

            dmodel = load_model(args.model_draft, device=mesh.device)
            deng = Engine(dmodel.cfg, dmodel.params, n_slots=engine.n_slots,
                          max_seq=args.ctx_size, opts=plan.opts, eog_ids=dmodel.eog_ids,
                          device=mesh.device)
            spec_dec = SpeculativeDecoder(engine, deng, n_draft=args.draft_max,
                                          p_min=args.draft_p_min)
        httpd, _ctx = serve(model, engine, args.host, args.port, args.alias, spec=spec_dec,
                            slot_save_dir=args.slot_save_path, api_keys=_load_api_keys(args))
    except BaseException:
        if engine is not None:
            engine.stop()
        if mesh is not None:
            mesh.close()
        stop_ranks(procs, timeout=5)
        raise
    print(f"listening on http://{args.host}:{args.port} (mesh dp={args.dp} pp={args.pp} "
          f"tp={args.tp})", file=sys.stderr, flush=True)
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        _ctx.worker.shutdown()
        httpd.server_close()
        engine.stop()
        mesh.close()
        stop_ranks(procs)
    return 0


def _ring_main(args) -> int:
    """Multi-process serving (prima_tpu/server/__main__.py:257-333): rank 0
    is the HTTP server over a TcpRingEngine, the other ranks run the
    batched window service loop (llama-server as the rank-0 command of a
    prima.cpp ring, server.cpp:2431)."""
    from ..models.loader import LoadedModel
    from ..parallel.ring_tcp import TcpRingEngine, TcpRingWorker, default_groups
    from ..tokenizer import Tokenizer
    from ..tools.cli_distributed import setup_ring
    from .app import serve

    if args.lora or args.lora_scaled:
        print("--lora is not supported over the ring", file=sys.stderr)
        return 1
    n_slots = max(1, args.parallel)
    n_groups = default_groups(args.world, n_slots)
    # the shared bootstrap: ring connect, auto schedule when -lw is absent,
    # rank-filtered load, resident/streamed split, relays
    rt = setup_ring(args)
    if rt is None:
        return 0
    if rt.res.rank != 0:
        print(f"rank {rt.res.rank}: serving ring windows {sorted(rt.owned)}",
              file=sys.stderr)
        TcpRingWorker(rt.ctx, rt.cfg, rt.params, max_seq=args.ctx_size, opts=rt.opts,
                      n_slots=n_slots, n_groups=n_groups, kv_dtype=rt.kv_dtype,
                      streamed_host=rt.streamed_host, device=rt.device).serve()
        rt.node.close()
        return 0

    model = LoadedModel(rt.cfg, rt.params, Tokenizer.from_gguf(rt.m), rt.m)
    # a failure before serving must still send STOP, or the workers wait on
    try:
        engine = TcpRingEngine(rt.ctx, rt.cfg, rt.params, n_slots=n_slots,
                               n_groups=n_groups, max_seq=args.ctx_size,
                               n_batch=args.batch_size, opts=rt.opts, eog_ids=model.eog_ids,
                               kv_dtype=rt.kv_dtype,
                               ctx_shift=not args.no_context_shift and args.grp_attn_n == 1,
                               n_keep=args.keep, grp_attn_n=args.grp_attn_n,
                               grp_attn_w=args.grp_attn_w, streamed_host=rt.streamed_host,
                               device=rt.device)
        spec = None
        if args.model_draft:
            # speculative serving over the ring: the draft whole on rank 0,
            # the target verified across the ring (server.cpp:715-733)
            from ..models.loader import load_model
            from ..runtime.engine import Engine
            from ..runtime.speculative import SpeculativeDecoder

            dmodel = load_model(args.model_draft, device=rt.device)
            deng = Engine(dmodel.cfg, dmodel.params, n_slots=engine.n_slots,
                          max_seq=args.ctx_size, opts=rt.opts, eog_ids=dmodel.eog_ids,
                          device=rt.device)
            spec = SpeculativeDecoder(engine, deng, n_draft=args.draft_max,
                                      p_min=args.draft_p_min)
        httpd, _ctx = serve(model, engine, args.host, args.port, args.alias, spec=spec,
                            api_keys=_load_api_keys(args))
    except BaseException:
        rt.node.send_stop()
        rt.node.close()
        raise
    print(f"listening on http://{args.host}:{args.port} (ring world={args.world})",
          file=sys.stderr, flush=True)
    # SIGTERM ends the server as Ctrl-C does, so STOP still goes round the ring
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        _ctx.worker.shutdown()
        httpd.server_close()
        engine.stop()
        rt.node.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
