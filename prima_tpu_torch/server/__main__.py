"""prima-server for the port: python -m prima_tpu_torch.server -m model.gguf

Counterpart of prima_tpu/server/__main__.py on one device (CUDA unless
--device cpu). Options of the JAX server that this port does not carry
yet raise a "not yet ported" error instead of being ignored.
"""

from __future__ import annotations

import argparse
import os
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
    ap.add_argument("--lora", action="append", default=[], metavar="FNAME")
    ap.add_argument("-md", "--model-draft", default=env("MODEL_DRAFT"))
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
    ap.add_argument("-w", "--world", type=int, default=1)
    from ..utils.args import apply_env_defaults

    apply_env_defaults(ap)  # PRIMA_ARG_* / LLAMA_ARG_* fallbacks
    return ap


def _unported(args) -> str | None:
    """The first requested option this port does not carry yet."""
    checks = [
        (bool(args.lora), "--lora"),
        (bool(args.model_draft), "-md / --model-draft"),
        (args.pp * args.tp * args.dp > 1, "--pp / --tp / --dp"),
        (args.world > 1, "-w / --world"),
    ]
    return next((what for bad, what in checks if bad), None)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    what = _unported(args)
    if what is not None:
        print(f"{what} is not yet ported to prima_tpu_torch", file=sys.stderr)
        return 2

    import torch

    from ..models.config import apply_rope_overrides
    from ..models.llama import ForwardOptions
    from ..models.loader import load_model, parse_kv_override
    from ..runtime.engine import Engine
    from .app import serve

    print(f"loading {args.model} ...", file=sys.stderr)
    model = load_model(args.model, device=args.device, fuse=args.fuse,
                       kv_overrides=dict(parse_kv_override(s) for s in args.override_kv))
    apply_rope_overrides(
        model.cfg, rope_scaling=args.rope_scaling, rope_freq_base=args.rope_freq_base,
        rope_freq_scale=args.rope_freq_scale, yarn_orig_ctx=args.yarn_orig_ctx,
        yarn_ext_factor=args.yarn_ext_factor, yarn_attn_factor=args.yarn_attn_factor,
        yarn_beta_fast=args.yarn_beta_fast, yarn_beta_slow=args.yarn_beta_slow)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    kv_dtype = dtypes.get(args.cache_type, args.cache_type)  # or "q8_0" / "q4_0"
    ctx_size = args.ctx_size or model.cfg.n_ctx_train  # -c 0: training context
    engine = Engine(model.cfg, model.params, n_slots=args.parallel, max_seq=ctx_size,
                    n_batch=args.batch_size,
                    opts=ForwardOptions(matmul_impl=args.matmul, dtype=dtypes[args.dtype]),
                    eog_ids=model.eog_ids, kv_dtype=kv_dtype,
                    # Self-Extend disables context shift (server.cpp:2034)
                    ctx_shift=not args.no_context_shift and args.grp_attn_n == 1,
                    n_keep=args.keep, grp_attn_n=args.grp_attn_n,
                    grp_attn_w=args.grp_attn_w, device=args.device)
    bos = model.tokenizer.vocab.bos_id
    engine.run_to_completion([bos if bos >= 0 else 0], n_predict=1)  # warmup
    print("warmup done", file=sys.stderr)
    httpd, _ctx = serve(model, engine, args.host, args.port, args.alias,
                        slot_save_dir=args.slot_save_path,
                        api_keys=_load_api_keys(args))
    print(f"listening on http://{args.host}:{args.port}", file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        _ctx.worker.shutdown()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
