"""Generate a tiny but COMPLETE llama-architecture GGUF for end-to-end tests.

The reference's tests use vocab-only GGUFs plus downloaded tiny HF models
(ci/run.sh); in a zero-egress environment we synthesize the whole model:
random weights quantized with our own quantizer (bit-exact block formats)
plus a real tokenizer — either copied from a vocab GGUF fixture or a
self-contained byte-level SPM vocab.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFModel
from ..gguf.writer import GGUFWriter
from ..quant.quantize_np import quantize

# no vocab fixture by default: the self-contained byte vocab; --vocab-from
# copies the tokenizer of a vocab GGUF instead
DEFAULT_VOCAB_FIXTURE = None


def _byte_vocab() -> dict:
    """Self-contained SPM-style vocab: specials + 256 byte tokens."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    scores = [0.0] * len(tokens)
    return {
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.scores": scores,
        "tokenizer.ggml.token_type": types,
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0,
        "tokenizer.ggml.add_bos_token": True,
    }


def make_tiny_gguf(
    path: str,
    vocab_from: str | None = DEFAULT_VOCAB_FIXTURE,
    n_layers: int = 2,
    n_embd: int = 256,
    n_heads: int = 8,
    n_kv_heads: int = 4,
    n_ff: int = 512,
    n_ctx: int = 512,
    ftype: GGMLType = GGMLType.Q4_K,
    seed: int = 0,
    arch: str = "llama",
    extra_tokens: list[str] | None = None,
) -> str:
    rng = np.random.default_rng(seed)
    head_dim = n_embd // n_heads

    w = GGUFWriter(path, arch=arch)
    w.add_kv("general.name", "tiny-synth")
    w.add_kv(f"{arch}.block_count", n_layers)
    w.add_kv(f"{arch}.embedding_length", n_embd)
    w.add_kv(f"{arch}.attention.head_count", n_heads)
    w.add_kv(f"{arch}.attention.head_count_kv", n_kv_heads)
    w.add_kv(f"{arch}.feed_forward_length", n_ff)
    w.add_kv(f"{arch}.context_length", n_ctx)
    w.add_kv(f"{arch}.attention.layer_norm_rms_epsilon", 1e-5)
    w.add_kv(f"{arch}.rope.freq_base", 10000.0)
    w.add_kv(f"{arch}.rope.dimension_count", head_dim)

    # tokenizer: copy from a vocab fixture if available, else byte vocab
    if vocab_from and os.path.exists(vocab_from) and not extra_tokens:
        src = GGUFModel.open(vocab_from)
        for key, val in src.metadata.items():
            if key.startswith("tokenizer."):
                w.add_kv(key, val)
        tokens = src.get("tokenizer.ggml.tokens")
        n_vocab = len(tokens)
        src.close()
    else:
        kv = _byte_vocab()
        for t in extra_tokens or []:  # appended as CONTROL (e.g. FIM)
            kv["tokenizer.ggml.tokens"].append(t)
            kv["tokenizer.ggml.token_type"].append(3)
            kv["tokenizer.ggml.scores"].append(0.0)
        for key, val in kv.items():
            w.add_kv(key, val)
        n_vocab = len(kv["tokenizer.ggml.tokens"])
    w.add_kv(f"{arch}.vocab_size", n_vocab)

    def q(name: str, rows: int, k: int, scale: float = 0.05):
        x = (rng.standard_normal((rows, k)) * scale).astype(np.float32)
        raw = quantize(x, ftype)
        w.add_tensor(name, raw, ne=(k, rows), ggml_type=ftype)

    def norm(name: str):
        w.add_tensor(name, np.ones(n_embd, dtype=np.float32))

    q("token_embd.weight", n_vocab, n_embd, scale=0.02)
    for i in range(n_layers):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight")
        q(p + "attn_q.weight", n_heads * head_dim, n_embd)
        q(p + "attn_k.weight", n_kv_heads * head_dim, n_embd)
        q(p + "attn_v.weight", n_kv_heads * head_dim, n_embd)
        q(p + "attn_output.weight", n_embd, n_heads * head_dim)
        norm(p + "ffn_norm.weight")
        q(p + "ffn_gate.weight", n_ff, n_embd)
        q(p + "ffn_up.weight", n_ff, n_embd)
        q(p + "ffn_down.weight", n_embd, n_ff)
    norm("output_norm.weight")
    q("output.weight", n_vocab, n_embd, scale=0.02)
    w.write()
    return path


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--embd", type=int, default=256)
    ap.add_argument("--ftype", default="Q4_K")
    ap.add_argument("--vocab-from", default=DEFAULT_VOCAB_FIXTURE)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    make_tiny_gguf(args.path, vocab_from=args.vocab_from, n_layers=args.layers,
                   n_embd=args.embd, ftype=GGMLType[args.ftype], seed=args.seed)
    print(args.path)


if __name__ == "__main__":
    main()
