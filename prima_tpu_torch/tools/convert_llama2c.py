"""prima-convert-llama2c — karpathy llama2.c checkpoint -> GGUF.

The convert-llama2c-to-ggml analogue (reference examples/
convert-llama2c-to-ggml/convert-llama2c-to-ggml.cpp). Reads the llama2.c
binary checkpoint format:

  header: 7 x int32 — dim, hidden_dim, n_layers, n_heads, n_kv_heads,
          vocab_size (NEGATIVE -> separate output classifier follows;
          positive -> classifier shares the token embedding), seq_len
  then f32 arrays in fixed order (convert-llama2c-to-ggml.cpp:152-170):
  tok_emb(vocab,dim), rms_att(L,dim), wq(L,dim,dim), wk(L,kv_dim,dim),
  wv(L,kv_dim,dim), wo(L,dim,dim), rms_ffn(L,dim), w1(L,ff,dim),
  w2(L,dim,ff), w3(L,ff,dim), rms_final(dim), [skipped freq_cis],
  [wcls(vocab,dim) when not shared]

and the vocabulary either from a llama2.c tokenizer.bin (u32 max_len, then
per token: f32 score, u32 len, bytes — fixups per @594-610: 0=<unk>,
1=<s>, 2=</s>, <0xXX> byte tokens, whitespace escaped to U+2581) or copied
from an existing GGUF model.

Usage: python -m prima_tpu_torch.tools.convert_llama2c \\
          --copy-vocab-from-model tokenizer.bin \\
          --llama2c-model stories15M.bin --llama2c-output-model out.gguf
"""

from __future__ import annotations

import argparse
import re
import struct
import sys

import numpy as np

UNKNOWN_TOKEN_ID = 0
BOS_TOKEN_ID = 1
EOS_TOKEN_ID = 2

# llama_token_type values (reference include/llama.h)
TT_NORMAL, TT_UNKNOWN, TT_CONTROL, TT_BYTE = 1, 2, 3, 6


def read_checkpoint(path: str):
    """-> (config dict, weights dict of numpy arrays (out, in))."""
    with open(path, "rb") as f:
        dim, hidden, n_layers, n_heads, n_kv, vocab, seq_len = \
            struct.unpack("<7i", f.read(28))
        shared = vocab > 0
        vocab = abs(vocab)
        kv_dim = dim * n_kv // n_heads
        head_size = dim // n_heads

        def arr(*shape):
            n = int(np.prod(shape))
            a = np.fromfile(f, dtype=np.float32, count=n)
            if a.size != n:
                raise ValueError(f"{path}: truncated checkpoint")
            return a.reshape(shape)

        w = {}
        w["tok_embd"] = arr(vocab, dim)
        w["rms_att"] = arr(n_layers, dim)
        w["wq"] = arr(n_layers, dim, dim)
        w["wk"] = arr(n_layers, kv_dim, dim)
        w["wv"] = arr(n_layers, kv_dim, dim)
        w["wo"] = arr(n_layers, dim, dim)
        w["rms_ffn"] = arr(n_layers, dim)
        w["w1"] = arr(n_layers, hidden, dim)  # ffn_gate
        w["w2"] = arr(n_layers, dim, hidden)  # ffn_down
        w["w3"] = arr(n_layers, hidden, dim)  # ffn_up
        w["rms_final"] = arr(dim)
        f.seek(seq_len * head_size * 4, 1)  # freq_cis_real + imag
        w["wcls"] = w["tok_embd"] if shared else arr(vocab, dim)

    cfg = dict(dim=dim, hidden_dim=hidden, n_layers=n_layers,
               n_heads=n_heads, n_kv_heads=n_kv, vocab_size=vocab,
               seq_len=seq_len, shared_classifier=shared)
    return cfg, w


def load_vocab(path: str, n_vocab: int):
    """-> (tokens, scores, types). GGUF models or llama2.c tokenizer.bin."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"GGUF":
        from ..gguf.reader import GGUFModel

        m = GGUFModel.open(path)
        tokens = list(m.get("tokenizer.ggml.tokens"))
        scores = list(m.get("tokenizer.ggml.scores"))
        types = list(m.get("tokenizer.ggml.token_type"))
        m.close()
        if len(tokens) != n_vocab:
            raise ValueError(f"vocab size mismatch: (gguf) {len(tokens)} "
                             f"!= (llama2c) {n_vocab}")
        return tokens, scores, types

    tokens, scores, types = [], [], []
    byte_re = re.compile(r"^<0x[0-9A-Fa-f]{2}>$")
    with open(path, "rb") as f:
        struct.unpack("<I", f.read(4))  # max_token_length, unused
        for tid in range(n_vocab):
            score, = struct.unpack("<f", f.read(4))
            ln, = struct.unpack("<I", f.read(4))
            text = f.read(ln).decode("utf-8", errors="replace")
            tt = TT_NORMAL
            if tid == UNKNOWN_TOKEN_ID:
                text, tt = "<unk>", TT_UNKNOWN
            elif tid == BOS_TOKEN_ID:
                text, tt = "<s>", TT_CONTROL
            elif tid == EOS_TOKEN_ID:
                text, tt = "</s>", TT_CONTROL
            elif not text:
                tt = TT_CONTROL
            elif byte_re.match(text):
                tt = TT_BYTE
            text = text.replace(" ", "▁")  # llama_escape_whitespaces
            tokens.append(text)
            scores.append(score)
            types.append(tt)
    return tokens, scores, types


def convert(llama2c_model: str, vocab_model: str, output: str,
            name: str | None = None) -> None:
    from ..gguf.writer import GGUFWriter

    cfg, wts = read_checkpoint(llama2c_model)
    tokens, scores, types = load_vocab(vocab_model, cfg["vocab_size"])

    w = GGUFWriter(output, arch="llama")
    w.add_kv("general.name", name or llama2c_model.rsplit("/", 1)[-1])
    w.add_kv("llama.context_length", cfg["seq_len"])
    w.add_kv("llama.embedding_length", cfg["dim"])
    w.add_kv("llama.block_count", cfg["n_layers"])
    w.add_kv("llama.feed_forward_length", cfg["hidden_dim"])
    w.add_kv("llama.attention.head_count", cfg["n_heads"])
    w.add_kv("llama.attention.head_count_kv", cfg["n_kv_heads"])
    w.add_kv("llama.rope.dimension_count", cfg["dim"] // cfg["n_heads"])
    w.add_kv("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add_kv("tokenizer.ggml.model", "llama")
    w.add_kv("tokenizer.ggml.tokens", tokens)
    w.add_kv("tokenizer.ggml.scores", np.asarray(scores, np.float32))
    w.add_kv("tokenizer.ggml.token_type", np.asarray(types, np.int32))
    w.add_kv("tokenizer.ggml.bos_token_id", BOS_TOKEN_ID)
    w.add_kv("tokenizer.ggml.eos_token_id", EOS_TOKEN_ID)
    w.add_kv("tokenizer.ggml.unknown_token_id", UNKNOWN_TOKEN_ID)

    w.add_tensor("token_embd.weight", wts["tok_embd"])
    for i in range(cfg["n_layers"]):
        w.add_tensor(f"blk.{i}.attn_norm.weight", wts["rms_att"][i])
        w.add_tensor(f"blk.{i}.attn_q.weight", wts["wq"][i])
        w.add_tensor(f"blk.{i}.attn_k.weight", wts["wk"][i])
        w.add_tensor(f"blk.{i}.attn_v.weight", wts["wv"][i])
        w.add_tensor(f"blk.{i}.attn_output.weight", wts["wo"][i])
        w.add_tensor(f"blk.{i}.ffn_norm.weight", wts["rms_ffn"][i])
        w.add_tensor(f"blk.{i}.ffn_gate.weight", wts["w1"][i])
        w.add_tensor(f"blk.{i}.ffn_down.weight", wts["w2"][i])
        w.add_tensor(f"blk.{i}.ffn_up.weight", wts["w3"][i])
    w.add_tensor("output_norm.weight", wts["rms_final"])
    if not cfg["shared_classifier"]:
        w.add_tensor("output.weight", wts["wcls"])
    w.write()
    print(f"wrote {output}: {cfg['n_layers']} layers, dim {cfg['dim']}, "
          f"vocab {cfg['vocab_size']}"
          + (" (tied output)" if cfg["shared_classifier"] else ""),
          file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-convert-llama2c",
                                 description=__doc__)
    ap.add_argument("--copy-vocab-from-model", required=True,
                    help="GGUF model or llama2.c tokenizer.bin")
    ap.add_argument("--llama2c-model", required=True)
    ap.add_argument("--llama2c-output-model", default="ak_llama_model.gguf")
    args = ap.parse_args(argv)
    convert(args.llama2c_model, args.copy_vocab_from_model,
            args.llama2c_output_model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
