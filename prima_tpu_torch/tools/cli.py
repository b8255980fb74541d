"""prima-cli for the port — interactive / one-shot chat CLI.

Counterpart of prima_tpu/tools/cli.py (the llama-cli analogue, reference
examples/main/main.cpp) on one device, CUDA unless --device cpu: loads a
GGUF, tokenizes the prompt, streams sampled tokens, with the full sampler
flag set, grammar / JSON-schema constrained output, reverse prompts,
interactive and chat-template conversation modes, a draft model for
speculative decoding (-md), session files (--prompt-cache), quantized KV
caches (-ctk) and Self-Extend (-gan / -gaw). Flags mirror common/arg.cpp
names with LLAMA_ARG_* environment fallbacks.

    python -m prima_tpu_torch.tools.cli -m model.gguf -p "Hello" -n 32

With -w > 1 each rank runs this command with its --rank, and the ranks
form the TCP ring (tools/cli_distributed.py): -lw sets the layer windows
by hand (else every rank profiles its device and rank 0 solves them), -k
the cycles, -ngl the resident layers of each window (the rest stream from
host memory; on one process -ngl runs the one-rank ring).

minicpm3, t5 and rwkv6 GGUFs run one-shot on their own runtimes (greedy,
the prefix recomputed or the state carried), mamba too, sampled at
--temp > 0; as in the JAX CLI, -cnv runs them one-shot. deepseek2 GGUFs
run through Engine like the decoder archs (the JAX CLI keeps them on its
recompute runtime).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    def env(name, default=None):
        return os.environ.get(f"LLAMA_ARG_{name}", default)

    ap = argparse.ArgumentParser(prog="prima-cli-torch", description=__doc__.split("\n\n")[0])
    ap.add_argument("-m", "--model", default=env("MODEL"), required=env("MODEL") is None)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("-p", "--prompt", default="")
    ap.add_argument("-f", "--file", help="read prompt from file")
    ap.add_argument("-n", "--n-predict", type=int, default=int(env("N_PREDICT", -1)))
    ap.add_argument("-c", "--ctx-size", type=int, default=int(env("CTX_SIZE", 2048)))
    ap.add_argument("-b", "--batch-size", type=int, default=int(env("BATCH", 256)))
    ap.add_argument("-i", "--interactive", action="store_true")
    ap.add_argument("-cnv", "--conversation", action="store_true",
                    help="chat-template conversation mode: each turn is rendered with "
                         "the model's chat template; -p becomes the system prompt")
    ap.add_argument("--chat-template", default=env("CHAT_TEMPLATE"),
                    help="builtin template name or a jinja template string "
                         "(default: the GGUF's tokenizer.chat_template)")
    ap.add_argument("-r", "--reverse-prompt", action="append", default=[])
    ap.add_argument("--in-prefix", default="", help="prepended to each interactive input")
    ap.add_argument("--in-suffix", default="", help="appended after each interactive input")
    ap.add_argument("-e", "--escape", action="store_true",
                    help="process \\n, \\t, ... escapes in the prompt")
    ap.add_argument("--no-display-prompt", action="store_true")
    ap.add_argument("-md", "--model-draft", default=env("MODEL_DRAFT"),
                    help="draft model for speculative decoding")
    ap.add_argument("--draft-max", "--draft", type=int, default=8, dest="draft_max",
                    help="max tokens drafted per round")
    ap.add_argument("--draft-p-min", type=float, default=0.75, help="draft confidence floor")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"],
                    help="kernel = fused dequant-GEMV; plain = dequantize + torch.matmul")
    ap.add_argument("--fuse", action="store_true",
                    help="fuse Q/K/V and gate/up weights at load where quant types match")
    ap.add_argument("--override-kv", action="append", default=[], metavar="KEY=TYPE:VALUE",
                    help="override model metadata (int, float, bool, str); repeatable")
    ap.add_argument("-ctk", "--cache-type-k", default="bf16",
                    choices=["f32", "bf16", "q8_0", "q4_0"], dest="cache_type")
    ap.add_argument("--n-keep", type=int, default=0, help="tokens kept through a context shift")
    ap.add_argument("--prompt-cache", help="session file: restore the KV cache from it on "
                    "start, save on exit (main.cpp:268-288)")
    ap.add_argument("--prompt-cache-ro", action="store_true",
                    help="use the prompt cache read-only (no save on exit)")
    # the distributed ring (the reference's -w/-r/-lw/-k/--master/--next flags)
    ap.add_argument("-w", "--world", type=int, default=int(env("WORLD", 1)))
    ap.add_argument("--rank", type=int, default=int(env("RANK", 0)))
    ap.add_argument("-mip", "--master-ip", default=env("MASTER_IP", "127.0.0.1"))
    ap.add_argument("-nip", "--next-ip", default=env("NEXT_IP", "127.0.0.1"))
    ap.add_argument("--data-port", type=int, default=int(env("DATA_PORT", 9000)))
    ap.add_argument("-lw", "--n-layer-window", default=env("LAYER_WINDOW"),
                    help="manual CSV windows, e.g. 16,8,8 (skips the solver)")
    ap.add_argument("-k", "--n-cycles", type=int, default=0)
    ap.add_argument("-ngl", "--n-gpu-layers", type=int, default=-1,
                    help="device-resident layers per window; the rest stream from "
                         "host memory each cycle (default: the scheduler's n[m])")
    ap.add_argument("--master-priority", type=float, default=1.01)
    ap.add_argument("--topo-grace", type=float, default=0.0,
                    help="topology-rebuild registration window (seconds): route the "
                         "ring around ranks that never show up; 0 = strict ring")
    # RoPE overrides on top of the GGUF metadata (0 / -1 mean "from model")
    ap.add_argument("--rope-scaling", choices=["none", "linear", "yarn"], default=None)
    ap.add_argument("--rope-freq-base", type=float, default=0.0)
    ap.add_argument("--rope-freq-scale", type=float, default=0.0)
    ap.add_argument("--yarn-orig-ctx", type=int, default=0)
    ap.add_argument("--yarn-ext-factor", type=float, default=-1.0)
    ap.add_argument("--yarn-attn-factor", type=float, default=-1.0)
    ap.add_argument("--yarn-beta-fast", type=float, default=-1.0)
    ap.add_argument("--yarn-beta-slow", type=float, default=-1.0)
    ap.add_argument("--no-context-shift", action="store_true",
                    help="stop at context end instead of shifting")
    ap.add_argument("-gan", "--grp-attn-n", type=int, default=1,
                    help="Self-Extend group attention factor (main.cpp:618)")
    ap.add_argument("-gaw", "--grp-attn-w", type=int, default=512,
                    help="Self-Extend group attention width")
    ap.add_argument("--verbose", "-v", action="count", default=0)
    # sampling (common/arg.cpp flag names)
    ap.add_argument("-s", "--seed", type=int, default=-1)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--min-p", type=float, default=0.05)
    ap.add_argument("--tfs", type=float, default=1.0)
    ap.add_argument("--typical", type=float, default=1.0)
    ap.add_argument("--repeat-penalty", type=float, default=1.0)
    ap.add_argument("--repeat-last-n", type=int, default=64)
    ap.add_argument("--frequency-penalty", type=float, default=0.0)
    ap.add_argument("--presence-penalty", type=float, default=0.0)
    ap.add_argument("--mirostat", type=int, default=0)
    ap.add_argument("--mirostat-lr", type=float, default=0.1)
    ap.add_argument("--mirostat-ent", type=float, default=5.0)
    ap.add_argument("-l", "--logit-bias", action="append", default=[],
                    help="TOKEN_ID(+/-)BIAS, e.g. 29871+1.5")
    ap.add_argument("--ignore-eos", action="store_true")
    ap.add_argument("--grammar", default="")
    ap.add_argument("--grammar-file", default="")
    ap.add_argument("--json-schema", default="")
    return ap


def make_sampler(args, model, n_vocab: int):
    from ..sampling import Sampler, SamplerParams

    bias = {}
    for spec in args.logit_bias:
        spec = spec.replace("+", ":").replace("-", ":-")
        tid, _, b = spec.partition(":")
        bias[int(tid)] = float(b)
    if args.ignore_eos:
        for t in model.eog_ids:
            bias[t] = -np.inf

    grammar = None
    gtext = args.grammar
    if args.grammar_file:
        with open(args.grammar_file) as f:
            gtext = f.read()
    if args.json_schema:
        from ..grammar.json_schema import json_schema_to_gbnf

        gtext = json_schema_to_gbnf(args.json_schema)
    if gtext:
        from ..grammar.engine import GrammarSampler

        token_bytes = [model.tokenizer.decode_token_bytes(i) for i in range(n_vocab)]
        grammar = GrammarSampler(gtext, token_bytes, eog_ids=model.eog_ids)

    params = SamplerParams(
        seed=args.seed if args.seed >= 0 else 0xFFFFFFFF,
        top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
        tfs_z=args.tfs, typ_p=args.typical, temp=args.temp,
        penalty_last_n=args.repeat_last_n, penalty_repeat=args.repeat_penalty,
        penalty_freq=args.frequency_penalty, penalty_present=args.presence_penalty,
        mirostat=args.mirostat, mirostat_eta=args.mirostat_lr,
        mirostat_tau=args.mirostat_ent, logit_bias=bias,
    )
    return Sampler(params, n_vocab=n_vocab, grammar=grammar)


def _stream_generate(eng, model, sampler, prompt_tokens, n_predict, reverse: list[str]):
    """Generate, print incrementally, honour reverse prompts. Returns the text."""
    from ..runtime.engine import SlotState

    if n_predict == 0:  # -n 0: prompt only, nothing generated
        return ""
    slot = eng.submit(prompt_tokens, sampler=sampler, n_predict=n_predict)
    buf = b""
    text_out = ""
    step = (lambda: eng.step_fused(max_chunk=8)) if hasattr(eng, "step_fused") else eng.step
    while slot.state != SlotState.IDLE:
        for ev in step():
            if ev.token is None:
                continue
            buf += model.tokenizer.decode_token_bytes(ev.token)
            try:
                piece = buf.decode("utf-8")
                buf = b""
            except UnicodeDecodeError:
                continue
            text_out += piece
            sys.stdout.write(piece)
            sys.stdout.flush()
            if any(r in text_out for r in reverse):
                eng.cancel(slot.request_id)
                break
    return text_out


def _read_prompt(args) -> str:
    prompt = args.prompt
    if args.file:
        with open(args.file) as f:
            prompt = f.read()
    if args.escape:
        # string_process_escapes applies to the prefix and suffix too (arg.cpp)
        prompt = prompt.encode().decode("unicode_escape")
        args.in_prefix = args.in_prefix.encode().decode("unicode_escape")
        args.in_suffix = args.in_suffix.encode().decode("unicode_escape")
    return prompt


def _run_family(args, arch: str) -> int:
    """One-shot generation on a family runtime of its own: greedy on the
    correctness-tier runtimes (minicpm3, t5, rwkv6; -n defaults
    to 64), and for mamba the recurrent decode (-n defaults to 128), sampled
    through the host sampler at --temp > 0."""
    prompt = _read_prompt(args)
    if arch == "t5":
        from ..models.t5 import T5Runtime as runtime
    elif arch == "rwkv6":
        from ..models.rwkv6 import Rwkv6Runtime as runtime
    elif arch == "mamba":
        from ..models.mamba import MambaRuntime as runtime
    else:
        from ..models.deepseek2 import DeepseekV2Runtime as runtime
    rt = runtime.load(args.model, device=args.device)
    toks = rt.tokenizer.encode(prompt, add_special=True, parse_special=True)
    if arch == "mamba":
        n = args.n_predict if args.n_predict > 0 else 128
        sampler = make_sampler(args, rt, rt.cfg.n_vocab) if args.temp > 0 else None
        out = rt.generate(toks, n_predict=n, sampler=sampler)
    else:
        out = rt.generate(toks, n_predict=args.n_predict if args.n_predict > 0 else 64)
    if not args.no_display_prompt:
        sys.stdout.write(prompt)
    sys.stdout.write(rt.tokenizer.decode(out) + "\n")
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    from ..utils.args import apply_env_defaults

    apply_env_defaults(parser)  # PRIMA_ARG_* / LLAMA_ARG_* fallbacks
    args = parser.parse_args(argv)

    if args.world > 1 or args.n_gpu_layers >= 0:
        # -ngl on one process runs the one-rank ring: the window streamer
        # serves models larger than the device's memory
        from .cli_distributed import run_distributed

        return run_distributed(args, _read_prompt(args))

    if args.verbose:
        print(f"loading {args.model} ...", file=sys.stderr)

    from ..gguf.reader import GGUFModel

    probe = GGUFModel.open(args.model)
    probe_arch = probe.arch
    probe.close()
    if probe_arch in ("minicpm3", "t5", "rwkv6", "mamba"):
        if args.conversation:
            print(f"warning: -cnv is not supported on the {probe_arch} "
                  "correctness-tier runtime; running one-shot", file=sys.stderr)
        return _run_family(args, probe_arch)

    import torch

    from ..models.config import apply_rope_overrides
    from ..models.llama import ForwardOptions
    from ..models.loader import load_model, parse_kv_override
    from ..runtime.engine import Engine

    overrides = dict(parse_kv_override(s) for s in args.override_kv)
    model = load_model(args.model, device=args.device, fuse=args.fuse, kv_overrides=overrides)
    apply_rope_overrides(
        model.cfg, rope_scaling=args.rope_scaling, rope_freq_base=args.rope_freq_base,
        rope_freq_scale=args.rope_freq_scale, yarn_orig_ctx=args.yarn_orig_ctx,
        yarn_ext_factor=args.yarn_ext_factor, yarn_attn_factor=args.yarn_attn_factor,
        yarn_beta_fast=args.yarn_beta_fast, yarn_beta_slow=args.yarn_beta_slow)
    if args.ctx_size == 0:  # -c 0: the model's training context (common.cpp)
        args.ctx_size = model.cfg.n_ctx_train
    opts = ForwardOptions(matmul_impl=args.matmul)
    kv_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}.get(args.cache_type,
                                                                 args.cache_type)
    eng = Engine(model.cfg, model.params, n_slots=1, max_seq=args.ctx_size,
                 n_batch=args.batch_size, opts=opts, eog_ids=model.eog_ids,
                 kv_dtype=kv_dtype, ctx_shift=not args.no_context_shift,
                 n_keep=args.n_keep, grp_attn_n=args.grp_attn_n,
                 grp_attn_w=args.grp_attn_w, device=args.device)
    prompt = _read_prompt(args)
    v = model.tokenizer.vocab
    if args.verbose:
        print(f"model: {model.cfg.name or model.cfg.arch}, {model.cfg.n_layers} layers, "
              f"vocab {v.n_tokens}", file=sys.stderr)

    # session restore: the longest common prefix of the cached tokens is
    # reused (the reference's --prompt-cache path, main.cpp:268-288)
    if args.prompt_cache and os.path.exists(args.prompt_cache):
        from ..runtime.state import session_load

        cached = session_load(eng, 0, args.prompt_cache)
        if args.verbose:
            print(f"session: restored {len(cached)} tokens from {args.prompt_cache}",
                  file=sys.stderr)

    if not (args.interactive or args.conversation):
        toks = model.tokenizer.encode(prompt, add_special=True, parse_special=True)
        if not args.no_display_prompt:
            sys.stdout.write(prompt)
        sampler = make_sampler(args, model, v.n_tokens)
        if args.model_draft:
            # speculative decoding, lossless draft and verify (the server's
            # and the speculative example's path)
            from ..runtime.speculative import SpeculativeDecoder

            dmodel = load_model(args.model_draft, device=args.device)
            deng = Engine(dmodel.cfg, dmodel.params, n_slots=1, max_seq=args.ctx_size,
                          opts=opts, eog_ids=dmodel.eog_ids, device=args.device)
            spec = SpeculativeDecoder(eng, deng, n_draft=args.draft_max,
                                      p_min=args.draft_p_min)
            n = args.n_predict if args.n_predict > 0 else 128
            out_toks, stats = spec.generate(toks, sampler=sampler, n_predict=n)
            sys.stdout.write(model.tokenizer.decode(out_toks))
            if args.verbose:
                print(f"\naccept rate {stats.acceptance:.3f} "
                      f"({stats.n_accepted}/{stats.n_drafted} drafted)", file=sys.stderr)
        else:
            _stream_generate(eng, model, sampler, toks, args.n_predict, args.reverse_prompt)
        sys.stdout.write("\n")
        if args.prompt_cache and not args.prompt_cache_ro:
            from ..runtime.state import session_save

            eng.slots[0].prompt = toks + eng.slots[0].generated
            session_save(eng, 0, args.prompt_cache)
            if args.verbose:
                print(f"session: saved to {args.prompt_cache}", file=sys.stderr)
        if args.verbose:
            print(eng.perf_summary(), file=sys.stderr)
        return 0

    if args.conversation:
        # chat-template conversation (main.cpp:264-290): the whole
        # conversation re-renders each turn, and the engine's prefix reuse
        # makes that an incremental KV append
        from ..server.chat import apply_chat_template

        tmpl = args.chat_template or model.gguf.get("tokenizer.chat_template")
        msgs = []
        if prompt.strip():
            msgs.append({"role": "system", "content": prompt})
        print("== conversation mode: empty line or Ctrl-D to exit ==", file=sys.stderr)
        while True:
            try:
                line = input("> ")
            except EOFError:
                break
            if not line.strip():
                break
            msgs.append({"role": "user", "content": line})
            text = apply_chat_template(msgs, tmpl, v, add_generation_prompt=True)
            toks = model.tokenizer.encode(text, add_special=True, parse_special=True)
            sampler = make_sampler(args, model, v.n_tokens)
            out = _stream_generate(eng, model, sampler, toks, args.n_predict,
                                   args.reverse_prompt)
            msgs.append({"role": "assistant", "content": out})
            print()
        return 0

    # the interactive loop
    print("== interactive mode: empty line or Ctrl-D to exit ==", file=sys.stderr)
    history = prompt
    while True:
        try:
            line = input("> ")
        except EOFError:
            break
        if not line.strip():
            break
        # the reference's order: prefix, the input line, then the suffix last
        # so that generation continues right after it (main.cpp)
        history += args.in_prefix + line + "\n" + args.in_suffix
        toks = model.tokenizer.encode(history, add_special=True, parse_special=True)
        sampler = make_sampler(args, model, v.n_tokens)
        out = _stream_generate(eng, model, sampler, toks, args.n_predict,
                               args.reverse_prompt or ["\n>"])
        history += out
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
