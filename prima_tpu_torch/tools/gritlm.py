"""prima-gritlm — generative-representational (GRIT) dual-mode demo.

Counterpart of prima_tpu/tools/gritlm.py on one device (CUDA unless
--device cpu).

The llama-gritlm analogue (reference examples/gritlm/gritlm.cpp): the same
decoder checkpoint serves BOTH as an embedding model — non-causal
attention (a zero attn_mask, which takes the plain masked attention), mean
pooling that skips the instruction tokens, L2-normalized — and as a
generator (plain causal decoding). Instruction framing follows
gritlm_instruction() (gritlm.cpp:150-152):

  "<|user|>\\n{instruction}\\n<|embed|>\\n"  (or just "<|embed|>\\n")

Usage: python -m prima_tpu_torch.tools.gritlm -m model.gguf
       python -m prima_tpu_torch.tools.gritlm -m model.gguf --mode embed \\
           -p "a\\nb" [--instruction "..."]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def gritlm_instruction(instruction: str) -> str:
    return (f"<|user|>\n{instruction}\n<|embed|>\n" if instruction
            else "<|embed|>\n")


def encode(model, sentences: list[str], instruction: str,
           matmul_impl: str = "kernel", device="cuda") -> np.ndarray:
    """Non-causal mean-pooled embeddings, instruction tokens excluded from
    the pool (gritlm.cpp encode(): llama_set_causal_attn(false), logits
    only for j >= n_inst). Returns (n, n_embd) L2-normalized rows."""
    import torch

    from .. import resolve_device
    from ..models.llama import ForwardOptions, forward, init_kv_caches, model_norm

    dev = resolve_device(device)
    opts = ForwardOptions(matmul_impl=matmul_impl, attn_impl="plain")
    cfg = model.cfg
    out = []
    for s in sentences:
        ids = model.tokenizer.encode(instruction + s, add_special=True)
        n_inst = len(model.tokenizer.encode(instruction, add_special=True)) \
            if instruction else 0
        n = len(ids)
        kv = init_kv_caches(cfg, 1, n, torch.float32, dev)
        toks = torch.as_tensor([ids], dtype=torch.int64, device=dev)
        pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
        # bidirectional: every token sees every token
        mask = torch.zeros((1, 1, n, n), dtype=torch.float32, device=dev)
        with torch.no_grad():
            hidden, _ = forward(model.params, cfg, toks, pos, kv,
                                torch.zeros(1, dtype=torch.int32, device=dev), opts,
                                return_hidden=True, attn_mask=mask)
            hidden = model_norm(hidden, model.params.get("output_norm"),
                                model.params.get("output_norm_b"), cfg)
        h = hidden[0].float().cpu().numpy()
        emb = h[n_inst:].mean(axis=0)  # skip instruction tokens
        norm = float(np.linalg.norm(emb))
        out.append(emb / norm if norm > 0 else emb)
    return np.stack(out)


def cosine_sim(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(a @ b / (na * nb)) if na and nb else 0.0


def generate(model, prompt: str, n_predict: int = 64,
             matmul_impl: str = "kernel", device="cuda") -> str:
    from ..models.llama import ForwardOptions
    from ..runtime.engine import Engine

    eng = Engine(model.cfg, model.params, n_slots=1,
                 max_seq=max(512, n_predict + 256),
                 opts=ForwardOptions(matmul_impl=matmul_impl),
                 eog_ids=model.eog_ids, device=device)
    ids = model.tokenizer.encode(prompt, add_special=True)
    out = eng.run_to_completion(ids, n_predict=n_predict)
    return model.tokenizer.decode(out)


def main(argv=None) -> int:
    def env(name, default=None):
        return os.environ.get(f"LLAMA_ARG_{name}", default)

    ap = argparse.ArgumentParser(prog="prima-gritlm", description=__doc__)
    ap.add_argument("-m", "--model", default=env("MODEL"),
                    required=env("MODEL") is None)
    ap.add_argument("--mode", default="demo",
                    choices=["demo", "embed", "generate"])
    ap.add_argument("-p", "--prompt", default=None)
    ap.add_argument("--instruction", default="")
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    from ..models.loader import load_model

    print(f"loading {args.model} ...", file=sys.stderr)
    model = load_model(args.model, device=args.device)
    dev = args.device

    if args.mode == "embed":
        sentences = (args.prompt or "Hello world").replace("\\n", "\n").split("\n")
        embs = encode(model, sentences, gritlm_instruction(args.instruction),
                      args.matmul, dev)
        for i, v in enumerate(embs):
            print(f"embedding {i}: " + " ".join(f"{x:9.6f}" for x in v[:8])
                  + (" ..." if len(v) > 8 else ""))
        if len(embs) > 1:
            for i in range(len(embs)):
                for j in range(i + 1, len(embs)):
                    print(f"cosine({i},{j}) = {cosine_sim(embs[i], embs[j]):.3f}")
        return 0

    if args.mode == "generate":
        prompt = args.prompt or "<|user|>\nPlease write me a poem.\n<|assistant|>\n"
        print(generate(model, prompt, args.n_predict, args.matmul, dev))
        return 0

    # demo: the gritlm.cpp sample flow — retrieval scoring then generation
    instruction = "Given a scientific paper title, retrieve the paper's abstract"
    queries = ["Bitcoin: A Peer-to-Peer Electronic Cash System",
               "Generative Representational Instruction Tuning"]
    documents = [
        "A purely peer-to-peer version of electronic cash would allow online "
        "payments to be sent directly from one party to another without "
        "going through a financial institution.",
        "All text-based language problems can be reduced to either "
        "generation or embedding. We introduce generative representational "
        "instruction tuning (GRIT).",
    ]
    d_rep = encode(model, documents, gritlm_instruction(""), args.matmul, dev)
    q_rep = encode(model, queries, gritlm_instruction(instruction), args.matmul, dev)
    for i, q in enumerate(queries):
        for j, d in enumerate(documents):
            print(f'cosine sim q{i} x d{j}: {cosine_sim(q_rep[i], d_rep[j]):.3f}')
    print(generate(model,
                   "<|user|>\nPlease write me a poem.\n<|assistant|>\n",
                   args.n_predict, args.matmul, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
