"""prima-server for the port: python -m prima_tpu_torch.server -m model.gguf

Counterpart of prima_tpu/server/__main__.py on one device (CUDA unless
--device cpu), with LoRA adapters (--lora, --lora-scaled) and speculative
decoding with a draft model (-md). With -w > 1 it serves over the TCP
ring: every rank runs the command with its --rank, rank 0 answers HTTP
over a TcpRingEngine and the others serve their windows (-lw, -k, -ngl as
in the CLI). The mesh options of the JAX server (--pp / --tp / --dp) are
not carried yet and raise a "not yet ported" error instead of being
ignored. A bert / nomic-bert GGUF is served by serve_embeddings
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
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("-k", "--n-cycles", type=int, default=0,
                    help="piped-ring cycles per token (0 = solver-chosen)")
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
    """The first requested option this port does not carry yet."""
    if args.pp * args.tp * args.dp > 1:
        return "--pp / --tp / --dp"
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
    if probe_gguf(args) in ("bert", "nomic-bert"):
        return _embeddings_main(args)
    what = _unported(args)
    if what is not None:
        print(f"{what} is not yet ported to prima_tpu_torch", file=sys.stderr)
        return 2

    if args.world > 1:
        return _ring_main(args)

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
