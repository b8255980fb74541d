"""T5 encoder-decoder models.

Counterpart of prima_tpu/models/t5.py on one device (CUDA unless the
caller asks for the CPU). The LLM_ARCH_T5 analogue (reference llm_build_t5*
/ llm_build_inp_embd_enc, src/llama.cpp): T5 LayerNorm = RMSNorm without
bias, unscaled attention scores with learned relative-position-bucket
biases (bidirectional in the encoder, causal in the decoder;
cross-attention unbiased), ReLU or gated-GELU FFN (the tanh
approximation), shared embeddings with the d_model^-0.5 logit scale when
tied.

GGUF schema: `t5.*` KVs plus `enc.blk.N.*` / `dec.blk.N.*` tensors
(attn_rel_b on block 0 only). As in the JAX package the weights are
dequantized on the host and held dense, and decoding recomputes the
decoder prefix each step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFModel
from ..ops.layers import mm_t, rms_norm
from .family import dense_getter, open_runtime, tokens_tensor


@dataclass
class T5Config:
    arch: str
    n_layers: int  # decoder layers
    n_enc_layers: int
    n_embd: int
    n_heads: int
    head_dim: int
    n_ff: int
    n_vocab: int
    rms_eps: float
    rel_buckets: int
    rel_max_dist: int
    dec_start_token: int
    tie_embeddings: bool
    ffn_gated: bool

    @classmethod
    def from_gguf(cls, m: GGUFModel) -> "T5Config":
        g = m.arch_key
        n_embd = int(g("{arch}.embedding_length"))
        n_heads = int(g("{arch}.attention.head_count"))
        tokens = m.get("tokenizer.ggml.tokens")
        return cls(
            arch=m.arch,
            n_layers=int(g("{arch}.block_count")),
            n_enc_layers=int(g("{arch}.encoder_block_count", g("{arch}.block_count"))),
            n_embd=n_embd,
            n_heads=n_heads,
            head_dim=int(g("{arch}.attention.key_length", n_embd // n_heads)),
            n_ff=int(g("{arch}.feed_forward_length")),
            n_vocab=int(g("{arch}.vocab_size", len(tokens) if tokens is not None else 0)),
            rms_eps=float(g("{arch}.attention.layer_norm_rms_epsilon", 1e-6)),
            rel_buckets=int(g("{arch}.attention.relative_buckets_count", 32)),
            rel_max_dist=128,
            dec_start_token=int(g("{arch}.decoder_start_token_id", 0)),
            tie_embeddings="output.weight" not in m.tensors,
            ffn_gated="dec.blk.0.ffn_gate.weight" in m.tensors,
        )


def load_t5_params(m: GGUFModel, cfg: T5Config, dtype=torch.float32, device=None) -> dict:
    get = dense_getter(m, dtype, device)

    def block(prefix, cross):
        out = {
            "attn_norm": get(prefix + "attn_norm.weight"),
            "wq": get(prefix + "attn_q.weight"),
            "wk": get(prefix + "attn_k.weight"),
            "wv": get(prefix + "attn_v.weight"),
            "wo": get(prefix + "attn_o.weight"),
            "rel_b": get(prefix + "attn_rel_b.weight", required=False),
            "ffn_norm": get(prefix + "ffn_norm.weight"),
            "w_up": get(prefix + "ffn_up.weight"),
            "w_gate": get(prefix + "ffn_gate.weight", required=False),
            "w_down": get(prefix + "ffn_down.weight"),
        }
        if cross:
            out.update({
                "cross_norm": get(prefix + "cross_attn_norm.weight"),
                "cq": get(prefix + "cross_attn_q.weight"),
                "ck": get(prefix + "cross_attn_k.weight"),
                "cv": get(prefix + "cross_attn_v.weight"),
                "co": get(prefix + "cross_attn_o.weight"),
            })
        return out

    return {
        "tok_embd": get("token_embd.weight"),
        "enc": [block(f"enc.blk.{i}.", False) for i in range(cfg.n_enc_layers)],
        "dec": [block(f"dec.blk.{i}.", True) for i in range(cfg.n_layers)],
        "enc_norm": get("enc.output_norm.weight"),
        "dec_norm": get("dec.output_norm.weight"),
        "output": get("output.weight", required=False),
    }


def _rel_bucket(rel_pos: np.ndarray, bidirectional: bool, num_buckets: int,
                max_dist: int) -> np.ndarray:
    """HF T5 _relative_position_bucket (bias indexed by mem_pos - ctx_pos)."""
    ret = np.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret += (n < 0).astype(np.int64) * num_buckets
        n = np.abs(n)
    else:
        n = np.maximum(n, 0)
    half = num_buckets // 2
    is_small = n < half
    large = half + (
        np.log(np.maximum(n, 1) / half) / np.log(max_dist / half) * (num_buckets - half)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(is_small, n, large)


def _pos_bias(rel_b: torch.Tensor, q_len: int, k_len: int, bidirectional: bool,
              cfg: T5Config) -> torch.Tensor:
    """(1, n_heads, q_len, k_len) additive bias from the (n_buckets, n_heads)
    relative-attention-bias embedding."""
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    buckets = _rel_bucket(mem - ctx, bidirectional, cfg.rel_buckets, cfg.rel_max_dist)
    bias = rel_b[torch.from_numpy(buckets).to(rel_b.device)]  # (q, k, n_heads)
    return bias.permute(2, 0, 1)[None]


def _attn(x, kv_src, wq, wk, wv, wo, cfg: T5Config, bias, causal: bool):
    b, s, _ = x.shape
    t = kv_src.shape[1]
    h, hd = cfg.n_heads, cfg.head_dim
    q = mm_t(x, wq).reshape(b, s, h, hd)
    k = mm_t(kv_src, wk).reshape(b, t, h, hd)
    v = mm_t(kv_src, wv).reshape(b, t, h, hd)
    # T5: NO 1/sqrt(hd) scaling
    scores = torch.einsum("bshd,bthd->bhst", q, k).float()
    if bias is not None:
        scores = scores + bias
    if causal:
        scores = scores + torch.triu(torch.full((s, t), float("-inf"), dtype=torch.float32,
                                                device=x.device), 1)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.to(dt), v.to(dt)).reshape(b, s, h * hd)
    return mm_t(out, wo)


def _ffn(layer, x):
    up = mm_t(x, layer["w_up"])
    if layer["w_gate"] is not None:  # v1.1 gated-gelu, the tanh approximation
        act = F.gelu(mm_t(x, layer["w_gate"]), approximate="tanh") * up
    else:
        act = torch.relu(up)
    return mm_t(act, layer["w_down"])


def t5_encode(params: dict, cfg: T5Config, tokens) -> torch.Tensor:
    """tokens (b, s) -> encoder hidden states (b, s, e)."""
    tokens = tokens_tensor(tokens, params["tok_embd"].device)
    h = params["tok_embd"][tokens]
    rel_b = params["enc"][0]["rel_b"]
    s = tokens.shape[1]
    bias = _pos_bias(rel_b, s, s, True, cfg) if rel_b is not None else None
    for layer in params["enc"]:
        hin = rms_norm(h, layer["attn_norm"], cfg.rms_eps)
        h = h + _attn(hin, hin, layer["wq"], layer["wk"], layer["wv"], layer["wo"], cfg, bias,
                      causal=False)
        hin = rms_norm(h, layer["ffn_norm"], cfg.rms_eps)
        h = h + _ffn(layer, hin)
    return rms_norm(h, params["enc_norm"], cfg.rms_eps)


def t5_decode(params: dict, cfg: T5Config, dec_tokens, enc_hidden: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder: (b, s_dec) + (b, s_enc, e) -> logits."""
    dec_tokens = tokens_tensor(dec_tokens, params["tok_embd"].device)
    h = params["tok_embd"][dec_tokens]
    s = dec_tokens.shape[1]
    rel_b = params["dec"][0]["rel_b"]
    bias = _pos_bias(rel_b, s, s, False, cfg) if rel_b is not None else None
    for layer in params["dec"]:
        hin = rms_norm(h, layer["attn_norm"], cfg.rms_eps)
        h = h + _attn(hin, hin, layer["wq"], layer["wk"], layer["wv"], layer["wo"], cfg, bias,
                      causal=True)
        hin = rms_norm(h, layer["cross_norm"], cfg.rms_eps)
        h = h + _attn(hin, enc_hidden, layer["cq"], layer["ck"], layer["cv"], layer["co"], cfg,
                      None, causal=False)
        hin = rms_norm(h, layer["ffn_norm"], cfg.rms_eps)
        h = h + _ffn(layer, hin)
    h = rms_norm(h, params["dec_norm"], cfg.rms_eps)
    if params["output"] is not None:
        return mm_t(h, params["output"])
    # tied embeddings: the d_model^-0.5 rescale (HF T5ForConditionalGeneration);
    # a strong np.float32 scalar in JAX, so the product is f32
    h = h.float() * float(np.float32(cfg.n_embd) ** -0.5)
    return mm_t(h, params["tok_embd"])


class T5Runtime:
    def __init__(self, cfg: T5Config, params: dict, tokenizer=None, eog_ids=None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.eog_ids = eog_ids or set()

    @classmethod
    def load(cls, path: str, dtype=torch.float32, device=None) -> "T5Runtime":
        _, cfg, params, tok, eog = open_runtime(path, T5Config, load_t5_params, dtype, device)
        return cls(cfg, params, tok, eog)

    def generate(self, input_tokens: list[int], n_predict: int = 32) -> list[int]:
        """Greedy seq2seq generation from the decoder start token."""
        dec = [self.cfg.dec_start_token]
        out: list[int] = []
        with torch.no_grad():
            enc = t5_encode(self.params, self.cfg, [list(input_tokens)])
            for _ in range(n_predict):
                logits = t5_decode(self.params, self.cfg, [dec], enc)
                tok = int(torch.argmax(logits[0, -1]))
                out.append(tok)
                if tok in self.eog_ids:
                    break
                dec.append(tok)
        return out
