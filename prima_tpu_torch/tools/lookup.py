"""prima-lookup — n-gram cache tools + lookup decoding demo.

Counterpart of prima_tpu/tools/lookup.py on one device (CUDA unless
--device cpu).

The analogue of examples/lookup/ (lookup-create.cpp, lookup-merge.cpp,
lookup-stats.cpp, lookup.cpp): build a static n-gram cache from a corpus,
merge caches, measure simulated acceptance over a corpus, and generate with
draft-model-free speculative decoding. Cache files are byte-compatible with
the reference's llama-lookup-create output, and with the JAX package's.
create and stats read only the model's tokenizer.

  python -m prima_tpu_torch.tools.lookup create -m model.gguf -f corpus.txt -o c.bin
  python -m prima_tpu_torch.tools.lookup merge a.bin b.bin -o out.bin
  python -m prima_tpu_torch.tools.lookup stats -m model.gguf -f corpus.txt [-lcs c.bin]
  python -m prima_tpu_torch.tools.lookup run -m model.gguf -p "..." -n 64 [-lcs c.bin]
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_model_args(ap):
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])


def _tokenizer(args):
    """The model's tokenizer, after checking the device as a model load
    would (create and stats run no forward)."""
    from .. import resolve_device
    from ..gguf.reader import GGUFModel
    from ..tokenizer import Tokenizer

    resolve_device(args.device)
    return Tokenizer.from_gguf(GGUFModel.open(args.model))


def cmd_create(args) -> int:
    from ..runtime import ngram_cache as nc

    text = open(args.file, encoding="utf-8").read()
    tokens = _tokenizer(args).encode(text, add_special=True)
    cache: dict = {}
    # static caches hold only NGRAM_STATIC-grams (lookup-create.cpp)
    nc.update(cache, nc.NGRAM_STATIC, nc.NGRAM_STATIC, tokens, len(tokens))
    nc.save(cache, args.output)
    print(f"saved {len(cache)} {nc.NGRAM_STATIC}-grams from "
          f"{len(tokens)} tokens to {args.output}", file=sys.stderr)
    return 0


def cmd_merge(args) -> int:
    from ..runtime import ngram_cache as nc

    target = nc.load(args.inputs[0])
    for path in args.inputs[1:]:
        nc.merge(target, nc.load(path))
    nc.save(target, args.output)
    print(f"merged {len(args.inputs)} caches -> {args.output} "
          f"({len(target)} ngrams)", file=sys.stderr)
    return 0


def cmd_stats(args) -> int:
    """Simulate drafting over a corpus WITHOUT running the model
    (lookup-stats.cpp): every position is 'verified' against the corpus."""
    from ..runtime import ngram_cache as nc

    text = open(args.file, encoding="utf-8").read()
    tokens = _tokenizer(args).encode(text, add_special=True)
    nc_static = nc.load(args.lookup_cache_static) if args.lookup_cache_static else {}
    nc_dynamic = nc.load(args.lookup_cache_dynamic) if args.lookup_cache_dynamic else {}
    nc_context: dict = {}

    n_drafted = n_accepted = 0
    i = max(nc.NGRAM_STATIC, args.n_ctx // 8)
    nc.update(nc_context, nc.NGRAM_MIN, nc.NGRAM_MAX, tokens[:i], i)
    while i < len(tokens) - 1:
        chain = [tokens[i]]
        nc.draft(tokens[: i + 1], chain, args.n_draft, nc.NGRAM_MIN,
                 nc.NGRAM_MAX, nc_context, nc_dynamic, nc_static)
        drafted = chain[1:]
        n_drafted += len(drafted)
        adv = 1
        for j, tok in enumerate(drafted):
            if i + 1 + j >= len(tokens) or tokens[i + 1 + j] != tok:
                break
            n_accepted += 1
            adv += 1
        new_i = min(i + adv, len(tokens) - 1)
        nc.update(nc_context, nc.NGRAM_MIN, nc.NGRAM_MAX,
                  tokens[: new_i + 1], new_i - i)
        i = new_i
    print(f"n_tokens   = {len(tokens)}")
    print(f"n_drafted  = {n_drafted}")
    print(f"n_accepted = {n_accepted}")
    rate = n_accepted / n_drafted if n_drafted else 0.0
    print(f"accept     = {100 * rate:.3f}%")
    return 0


def cmd_run(args) -> int:
    import torch

    from ..models.llama import ForwardOptions
    from ..models.loader import load_model
    from ..runtime import ngram_cache as nc
    from ..runtime.engine import Engine
    from ..runtime.ngram_cache import LookupDecoder
    from ..sampling import Sampler, SamplerParams

    model = load_model(args.model, device=args.device)
    engine = Engine(model.cfg, model.params, n_slots=1, max_seq=args.ctx_size,
                    opts=ForwardOptions(matmul_impl=args.matmul),
                    eog_ids=model.eog_ids, kv_dtype=torch.bfloat16, device=args.device)
    dec = LookupDecoder(
        engine, n_draft=args.n_draft,
        nc_static=nc.load(args.lookup_cache_static) if args.lookup_cache_static else None,
        nc_dynamic=nc.load(args.lookup_cache_dynamic) if args.lookup_cache_dynamic else None,
    )
    prompt = model.tokenizer.encode(args.prompt, add_special=True)
    t0 = time.perf_counter()
    out, stats = dec.generate(prompt, sampler=Sampler(SamplerParams(temp=args.temp)),
                              n_predict=args.n_predict)
    dt = time.perf_counter() - t0
    print(model.tokenizer.decode(out))
    print(f"\n[{len(out)} tokens, {len(out)/dt:.2f} tok/s, "
          f"{stats.n_target_calls} target calls, "
          f"accept {100*stats.acceptance:.1f}%]", file=sys.stderr)
    if args.lookup_cache_dynamic:
        nc.save(dec.nc_dynamic, args.lookup_cache_dynamic)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-lookup", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create", help="build a static cache from a corpus")
    _add_model_args(c)
    c.add_argument("-f", "--file", required=True)
    c.add_argument("-o", "--output", required=True)
    c.set_defaults(fn=cmd_create)

    m = sub.add_parser("merge", help="merge caches")
    m.add_argument("inputs", nargs="+")
    m.add_argument("-o", "--output", required=True)
    m.set_defaults(fn=cmd_merge)

    s = sub.add_parser("stats", help="simulated acceptance over a corpus")
    _add_model_args(s)
    s.add_argument("-f", "--file", required=True)
    s.add_argument("--n-draft", type=int, default=5)
    s.add_argument("-c", "--n-ctx", type=int, default=512)
    s.add_argument("-lcs", "--lookup-cache-static")
    s.add_argument("-lcd", "--lookup-cache-dynamic")
    s.set_defaults(fn=cmd_stats)

    r = sub.add_parser("run", help="generate with lookup decoding")
    _add_model_args(r)
    r.add_argument("-p", "--prompt", required=True)
    r.add_argument("-n", "--n-predict", type=int, default=64)
    r.add_argument("-c", "--ctx-size", type=int, default=2048)
    r.add_argument("--n-draft", type=int, default=8)
    r.add_argument("--temp", type=float, default=0.0)
    r.add_argument("-lcs", "--lookup-cache-static")
    r.add_argument("-lcd", "--lookup-cache-dynamic")
    r.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
