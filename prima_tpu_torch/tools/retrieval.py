"""prima-retrieval — cosine-similarity chunk retrieval with an embedding model.

Counterpart of prima_tpu/tools/retrieval.py on one device (CUDA unless
--device cpu; --matmul kernel|plain).

The llama-retrieval analogue (reference examples/retrieval): split the given
context files into chunks, embed every chunk with a BERT-arch GGUF, then
answer queries with the top-k most similar chunks. One-shot (`-q`) or
interactive ("Enter query:" loop on stdin).

Usage: python -m prima_tpu_torch.tools.retrieval -m bge.gguf \\
          --context-file doc.txt [--context-file more.txt] \\
          [--chunk-size 100] [--chunk-separator "\\n"] [--top-k 3] [-q "..."]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def chunk_files(paths: list[str], chunk_size: int, separator: str) -> list[dict]:
    """The reference's chunker: accumulate separator-delimited pieces until
    at least chunk_size characters (retrieval.cpp chunk_file)."""
    chunks = []
    for path in paths:
        text = open(path, errors="replace").read()
        pieces = text.split(separator)
        cur = ""
        for i, piece in enumerate(pieces):
            cur += piece + (separator if i < len(pieces) - 1 else "")
            if len(cur) >= chunk_size:
                chunks.append({"file": path, "text": cur.strip()})
                cur = ""
        if cur.strip():
            chunks.append({"file": path, "text": cur.strip()})
    return chunks


def top_k_chunks(rt, chunks: list[dict], query: str, k: int,
                 matmul_impl: str = "kernel") -> list[tuple[float, dict]]:
    emb = np.asarray(rt.embed([c["text"] for c in chunks], matmul_impl=matmul_impl))
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    q = np.asarray(rt.embed([query], matmul_impl=matmul_impl))[0]
    q = q / max(float(np.linalg.norm(q)), 1e-9)
    sims = emb @ q
    order = np.argsort(-sims)[:k]
    return [(float(sims[i]), chunks[i]) for i in order]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-retrieval", description=__doc__)
    ap.add_argument("-m", "--model", required=True, help="BERT-arch GGUF")
    ap.add_argument("--context-file", action="append", default=[], required=True)
    ap.add_argument("--chunk-size", type=int, default=100)
    ap.add_argument("--chunk-separator", default="\n")
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("-q", "--query", help="one-shot query (else interactive)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    from ..models.bert import BertModelRuntime

    print(f"loading {args.model} ...", file=sys.stderr)
    rt = BertModelRuntime.load(args.model, device=args.device)
    chunks = chunk_files(args.context_file, args.chunk_size, args.chunk_separator)
    if not chunks:
        print("no chunks produced", file=sys.stderr)
        return 1
    print(f"embedded {len(chunks)} chunks", file=sys.stderr)

    def answer(query: str) -> None:
        for sim, c in top_k_chunks(rt, chunks, query, args.top_k, args.matmul):
            print(f"[{sim:.4f}] ({c['file']}) {c['text'][:200]}")

    if args.query is not None:
        answer(args.query)
        return 0
    while True:
        try:
            q = input("Enter query: ")
        except EOFError:
            break
        if not q.strip():
            break
        answer(q)
    return 0


if __name__ == "__main__":
    sys.exit(main())
