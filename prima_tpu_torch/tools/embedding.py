"""prima-embedding — batch sequence embeddings from the command line.

Counterpart of prima_tpu/tools/embedding.py on one device (CUDA unless
--device cpu; --matmul kernel|plain stands in for pallas|xla).

The llama-embedding analogue (reference examples/embedding/embedding.cpp):
split the prompt on a separator, embed every chunk, normalize per
--embd-normalize (llama_embd_normalize semantics: -1 none, 0 max-abs,
1 taxicab, 2 euclidean, p > 2 p-norm), and print either the raw vectors,
a JSON document (--embd-output-format json / json+ adds the cosine
similarity matrix), or — for several prompts with no format — the
pairwise cosine-similarity table (embedding.cpp:253-272). Encoder GGUFs
(bert, nomic-bert, jina-bert-v2) embed through models/bert.py, decoders
through Engine.embed.

Usage: python -m prima_tpu_torch.tools.embedding -m model.gguf -p "a\\nb" \\
          [--pooling mean|last|cls] [--embd-normalize 2] [--embd-separator '\\n']
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def normalize_embedding(v: np.ndarray, embd_norm: int) -> np.ndarray:
    """common.cpp llama_embd_normalize."""
    v = np.asarray(v, np.float64)
    if embd_norm < 0:
        s = 1.0
    elif embd_norm == 0:  # max absolute (scaled for int16 quantization)
        s = float(np.abs(v).max()) / 32760.0
    elif embd_norm == 2:
        s = float(np.linalg.norm(v))
    else:
        s = float(np.sum(np.abs(v) ** embd_norm) ** (1.0 / embd_norm))
    return (v / s if s > 0.0 else v * 0.0).astype(np.float32)


def cosine_sim(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(a @ b / (na * nb))


def main(argv=None) -> int:
    def env(name, default=None):
        return os.environ.get(f"LLAMA_ARG_{name}", default)

    ap = argparse.ArgumentParser(prog="prima-embedding", description=__doc__)
    ap.add_argument("-m", "--model", default=env("MODEL"),
                    required=env("MODEL") is None)
    ap.add_argument("-p", "--prompt", default="Hello world")
    ap.add_argument("-f", "--file", help="read prompt from file")
    ap.add_argument("--pooling", default="mean", choices=["mean", "last", "cls"])
    ap.add_argument("--embd-normalize", type=int, default=2)
    ap.add_argument("--embd-separator", default="\n")
    ap.add_argument("--embd-output-format", default="",
                    choices=["", "array", "json", "json+"])
    ap.add_argument("-c", "--ctx-size", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..gguf.reader import GGUFModel

    dev = resolve_device(args.device)
    prompt = open(args.file, encoding="utf-8").read() if args.file else args.prompt
    prompts = prompt.replace("\\n", "\n").split(args.embd_separator.replace("\\n", "\n"))

    print(f"loading {args.model} ...", file=sys.stderr)
    probe = GGUFModel.open(args.model)
    arch = probe.arch
    probe.close()

    if arch in ("bert", "nomic-bert", "jina-bert-v2"):
        # encoder-only models embed through the bert runtime (the
        # llama_encode branch, embedding.cpp:44-48)
        from ..models.bert import BertModelRuntime, PoolingType

        rt = BertModelRuntime.load(args.model, device=dev)
        ptype = {"mean": PoolingType.MEAN, "last": PoolingType.LAST,
                 "cls": PoolingType.CLS}[args.pooling]
        embs = [np.asarray(rt.embed([p], normalize=False, matmul_impl=args.matmul,
                                    pooling=ptype)[0], np.float32)
                for p in prompts]
    else:
        from ..models.llama import ForwardOptions
        from ..models.loader import load_model
        from ..runtime.engine import Engine

        model = load_model(args.model, device=dev)
        eng = Engine(model.cfg, model.params, n_slots=1, max_seq=args.ctx_size,
                     opts=ForwardOptions(matmul_impl=args.matmul), device=dev)
        embs = []
        for p in prompts:
            ids = model.tokenizer.encode(p, add_special=True)[: args.ctx_size]
            embs.append(eng.embed(ids, pooling=args.pooling))

    embs = [normalize_embedding(v, args.embd_normalize) for v in embs]

    fmt = args.embd_output_format
    if fmt in ("json", "json+"):
        doc = {"object": "list", "model": args.model,
               "data": [{"object": "embedding", "index": i,
                         "embedding": [round(float(x), 7) for x in v]}
                        for i, v in enumerate(embs)]}
        if fmt == "json+" and len(embs) > 1:
            doc["cosineSimilarity"] = [
                [round(cosine_sim(a, b), 2) for b in embs] for a in embs]
        print(json.dumps(doc, indent=2))
    elif fmt == "array":
        for v in embs:
            print(" ".join(f"{x:.6f}" for x in v))
    else:
        for i, v in enumerate(embs):
            head = " ".join(f"{x:9.6f}" for x in v[:8])
            print(f"embedding {i}: {head}{' ...' if len(v) > 8 else ''}")
        if len(embs) > 1:
            print("\ncosine similarity matrix:\n")
            print(" \t" + "\t".join(p[:6] for p in prompts))
            for i, a in enumerate(embs):
                row = "\t".join(f"{cosine_sim(a, b):6.2f}" for b in embs)
                print(f"{row} \t{prompts[i][:6]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
