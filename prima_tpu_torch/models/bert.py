"""BERT-family encoder models: the embedding and rerank runtime.

Counterpart of prima_tpu/models/bert.py on one device (CUDA unless the
caller asks for the CPU). The analogue of the reference's LLM_ARCH_BERT
path (build_bert, served by llama-server --embeddings): token + type +
position embeddings, a post-norm encoder with bidirectional attention,
biased LayerNorms, a GELU FFN, and CLS / mean / last / none pooling
(llama_pooling_type). Weights may be any supported GGUF quant type; the
projections go through `llama.linear`, so on the card an input of fewer
than 32 tokens streams them through the dequant-GEMV kernel and a longer
one dequantizes and runs one matmul, as the JAX package's Pallas entry
routes them. Attention, LayerNorm, GELU and pooling are plain PyTorch, as
they are plain XLA in the JAX package.

jina-bert-v2 adds bidirectional ALiBi in place of position embeddings, a
gated FFN with an unbiased gate, optional q/k LayerNorms and a second
norm (attn_norm_2) that re-adds the layer input.

As in the JAX package, `BertConfig.from_gguf` accepts nomic-bert but
`load_bert_params` then raises KeyError at `position_embd.weight` (nomic-bert
uses RoPE and a fused QKV), and a text longer than n_ctx_train fails on
`pos_embd[:s]`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..gguf.reader import GGUFModel
from ..ops.layers import alibi_slopes, layer_norm
from .llama import _to_device_tensor, embed as embed_rows, linear


class PoolingType:
    NONE = 0
    MEAN = 1
    CLS = 2
    LAST = 3


@dataclass
class BertConfig:
    arch: str
    n_layers: int
    n_embd: int
    n_heads: int
    n_ff: int
    n_vocab: int
    n_ctx_train: int
    ln_eps: float
    pooling: int = PoolingType.MEAN
    name: str = ""
    # jina-bert-v2: bidirectional ALiBi (f_max_alibi_bias = 8) in place of
    # position embeddings, and a gated-GELU FFN
    alibi_max_bias: float = 0.0
    gated_ffn: bool = False

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_heads

    @classmethod
    def from_gguf(cls, m: GGUFModel) -> "BertConfig":
        arch = m.arch
        assert arch in ("bert", "nomic-bert", "jina-bert-v2"), arch
        g = m.arch_key
        extra = {}
        if arch == "jina-bert-v2":
            extra = {"alibi_max_bias": 8.0, "gated_ffn": True}
        return cls(
            arch=arch,
            n_layers=int(g("{arch}.block_count")),
            n_embd=int(g("{arch}.embedding_length")),
            n_heads=int(g("{arch}.attention.head_count")),
            n_ff=int(g("{arch}.feed_forward_length")),
            n_vocab=int(g("{arch}.vocab_size", 0) or len(m.get("tokenizer.ggml.tokens"))),
            n_ctx_train=int(g("{arch}.context_length", 512)),
            ln_eps=float(g("{arch}.attention.layer_norm_epsilon", 1e-12)),
            # pooling_type 0 (NONE) reads as MEAN, as in the JAX package
            pooling=int(g("{arch}.pooling_type", PoolingType.MEAN) or PoolingType.MEAN),
            name=str(m.get("general.name", "")),
            **extra,
        )


def load_bert_params(m: GGUFModel, cfg: BertConfig, dtype=torch.float32,
                     device=None) -> dict:
    """The encoder's tensors on `device`: projections and the token table
    as QTensors where quantized, everything else dense in `dtype`."""
    t = m.tensors
    device = resolve_device(device)

    def get(name, dense=False, required=True):
        ti = t.get(name)
        if ti is None:
            if required:
                raise KeyError(f"missing tensor {name}")
            return None
        return _to_device_tensor(ti, dtype, device, dense)

    params: dict[str, Any] = {
        "tok_embd": get("token_embd.weight"),
        "type_embd": get("token_types.weight", dense=True),
        # jina-bert-v2 has no position embeddings (ALiBi instead)
        "pos_embd": get("position_embd.weight", dense=True, required=not cfg.alibi_max_bias),
        "tok_norm": get("token_embd_norm.weight", dense=True),
        "tok_norm_b": get("token_embd_norm.bias", dense=True),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer = {
            "wq": get(p + "attn_q.weight"), "bq": get(p + "attn_q.bias", dense=True),
            "wk": get(p + "attn_k.weight"), "bk": get(p + "attn_k.bias", dense=True),
            "wv": get(p + "attn_v.weight"), "bv": get(p + "attn_v.bias", dense=True),
            "wo": get(p + "attn_output.weight"),
            "bo": get(p + "attn_output.bias", dense=True),
            "attn_norm": get(p + "attn_output_norm.weight", dense=True),
            "attn_norm_b": get(p + "attn_output_norm.bias", dense=True),
            "w_up": get(p + "ffn_up.weight"),
            "b_up": get(p + "ffn_up.bias", dense=True, required=not cfg.gated_ffn),
            "w_down": get(p + "ffn_down.weight"),
            "b_down": get(p + "ffn_down.bias", dense=True),
            "out_norm": get(p + "layer_output_norm.weight", dense=True),
            "out_norm_b": get(p + "layer_output_norm.bias", dense=True),
        }
        if cfg.gated_ffn:  # jina: the gate projection has no bias
            layer["w_gate"] = get(p + "ffn_gate.weight")
        # jina: optional q/k LayerNorms and the attn_norm_2 post-residual norm
        for nm, key in ((p + "attn_q_norm.weight", "q_norm"),
                        (p + "attn_q_norm.bias", "q_norm_b"),
                        (p + "attn_k_norm.weight", "k_norm"),
                        (p + "attn_k_norm.bias", "k_norm_b"),
                        (p + "attn_norm_2.weight", "norm_2"),
                        (p + "attn_norm_2.bias", "norm_2_b")):
            v = get(nm, dense=True, required=False)
            if v is not None:
                layer[key] = v
        params["layers"].append(layer)
    # optional classification / rank head (reranker models)
    params["cls"] = get("cls.weight", dense=True, required=False)
    params["cls_b"] = get("cls.bias", dense=True, required=False)
    params["cls_out"] = get("cls.output.weight", dense=True, required=False)
    params["cls_out_b"] = get("cls.output.bias", dense=True, required=False)
    return params


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU in f32, written out (not F.gelu) so that it
    stays the JAX package's expression."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(0.7978845608028654 * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


def bert_forward(params: dict, cfg: BertConfig, tokens: torch.Tensor,
                 attn_mask: torch.Tensor | None = None,
                 matmul_impl: str = "kernel") -> torch.Tensor:
    """tokens (b, s) int -> hidden states (b, s, e). attn_mask (b, s) 1/0."""
    b, s = tokens.shape
    h, hd = cfg.n_heads, cfg.head_dim
    dev = tokens.device
    x = embed_rows(params["tok_embd"], tokens, torch.float32)
    x = x + params["type_embd"][0].to(x.dtype)  # token type 0
    if params.get("pos_embd") is not None:
        x = x + params["pos_embd"][:s][None].to(x.dtype)
    x = layer_norm(x, params["tok_norm"], params["tok_norm_b"], cfg.ln_eps)

    if attn_mask is None:
        attn_mask = torch.ones((b, s), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias = torch.where(attn_mask[:, None, None, :] > 0, zero, float("-inf"))
    if cfg.alibi_max_bias:
        # jina-bert-v2: the scores carry slope * -|pos_i - pos_j| per head
        slopes = alibi_slopes(h, cfg.alibi_max_bias).to(dev)
        ar = torch.arange(s, device=dev)
        dist = -(ar[:, None] - ar[None, :]).abs()
        bias = bias + (slopes[:, None, None] * dist[None].float())[None]

    scale = float(np.float32(math.sqrt(hd)))
    for layer in params["layers"]:
        x_in = x
        q = linear(x, layer["wq"], matmul_impl) + layer["bq"]
        k = linear(x, layer["wk"], matmul_impl) + layer["bk"]
        v = linear(x, layer["wv"], matmul_impl) + layer["bv"]
        if layer.get("q_norm") is not None:  # jina: optional q/k LayerNorms
            q = layer_norm(q, layer["q_norm"], layer["q_norm_b"], cfg.ln_eps)
            k = layer_norm(k, layer["k_norm"], layer["k_norm_b"], cfg.ln_eps)
        q = q.reshape(b, s, h, hd)
        k = k.reshape(b, s, h, hd)
        v = v.reshape(b, s, h, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / scale
        probs = torch.softmax(scores + bias, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        attn = linear(attn.reshape(b, s, h * hd), layer["wo"], matmul_impl) + layer["bo"]
        x = layer_norm(x + attn, layer["attn_norm"], layer["attn_norm_b"], cfg.ln_eps)
        if layer.get("norm_2") is not None:
            # jina attn_norm_2: re-add the layer input and norm again
            x = layer_norm(x + x_in, layer["norm_2"], layer["norm_2_b"], cfg.ln_eps)
        if cfg.gated_ffn and layer.get("w_gate") is not None:
            up = linear(x, layer["w_up"], matmul_impl)
            gate = linear(x, layer["w_gate"], matmul_impl)
            ff = linear(_gelu(gate) * up, layer["w_down"], matmul_impl) + layer["b_down"]
        else:
            ff = linear(x, layer["w_up"], matmul_impl) + layer["b_up"]
            ff = linear(_gelu(ff), layer["w_down"], matmul_impl) + layer["b_down"]
        x = layer_norm(x + ff, layer["out_norm"], layer["out_norm_b"], cfg.ln_eps)
    return x


def pool(hidden: torch.Tensor, attn_mask: torch.Tensor, pooling: int) -> torch.Tensor:
    """(b, s, e) -> (b, e) per llama_pooling_type semantics."""
    if pooling == PoolingType.CLS:
        return hidden[:, 0]
    if pooling == PoolingType.LAST:
        last = torch.sum(attn_mask, dim=1).to(torch.int64) - 1
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
    if pooling == PoolingType.MEAN:
        m = attn_mask[:, :, None].to(hidden.dtype)
        return torch.sum(hidden * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1)
    return hidden.reshape(hidden.shape[0], -1)  # NONE: the caller handles it


@dataclass
class BertModelRuntime:
    """A loaded encoder and its tokenizer: the embedding-serving unit."""

    cfg: BertConfig
    params: dict
    tokenizer: Any
    device: torch.device

    @classmethod
    def load(cls, path: str, dtype=torch.float32, device=None) -> "BertModelRuntime":
        from ..tokenizer import Tokenizer

        device = resolve_device(device)
        m = GGUFModel.open(path)
        cfg = BertConfig.from_gguf(m)
        params = load_bert_params(m, cfg, dtype, device)
        tok = Tokenizer.from_gguf(m)
        m.close()
        return cls(cfg, params, tok, device)

    def _hidden(self, ids: list[int], matmul_impl: str) -> torch.Tensor:
        toks = torch.as_tensor([ids], dtype=torch.int64, device=self.device)
        with torch.no_grad():
            return bert_forward(self.params, self.cfg, toks, matmul_impl=matmul_impl)

    def embed(self, texts: list[str], normalize: bool = True,
              matmul_impl: str = "kernel",
              pooling: int | None = None) -> np.ndarray:
        """-> (n, e) pooled (and L2-normalized, like the server's embedding
        endpoint) sentence embeddings. pooling overrides the model's
        pooling_type (the --pooling flag of the embedding tool)."""
        if pooling is None:
            pooling = self.cfg.pooling or PoolingType.MEAN
        out = []
        for text in texts:
            ids = self.tokenizer.encode(text, add_special=True)
            hidden = self._hidden(ids, matmul_impl)
            ones = torch.ones((1, len(ids)), dtype=torch.float32, device=self.device)
            vec = pool(hidden, ones, pooling)[0].float().cpu().numpy()
            if normalize:
                vec = vec / (np.linalg.norm(vec) + 1e-8)
            out.append(vec)
        return np.stack(out)

    @property
    def has_rank_head(self) -> bool:
        return self.params.get("cls") is not None

    def rerank(self, query: str, documents: list[str],
               matmul_impl: str = "kernel") -> np.ndarray:
        """Relevance scores through the classification head (RANK pooling):
        the pair is encoded as [CLS|BOS] query [SEP|EOS] [SEP] doc [SEP|EOS]
        and the CLS hidden state goes through cls -> tanh -> cls_out. Without
        a head, the cosine of the normalized pooled embeddings."""
        if not self.has_rank_head:
            qv = self.embed([query], matmul_impl=matmul_impl)[0]
            dv = self.embed(documents, matmul_impl=matmul_impl)
            return dv @ qv
        v = self.tokenizer.vocab
        bos = v.cls_id if v.cls_id >= 0 else v.bos_id
        sep = v.sep_id if v.sep_id >= 0 else v.eos_id
        eos = sep  # WPM models: the EOS token resolves to [SEP]
        p = self.params
        scores = []
        for doc in documents:
            ids = ([bos] + self.tokenizer.encode(query, add_special=False) + [eos, sep]
                   + self.tokenizer.encode(doc, add_special=False) + [eos])
            h = self._hidden(ids, matmul_impl)[:, 0]  # the CLS token
            with torch.no_grad():
                s = torch.tanh(h @ p["cls"].t() + p["cls_b"])
                if p.get("cls_out") is not None:
                    s = s @ p["cls_out"].t() + p["cls_out_b"]
            scores.append(float(s.float().cpu()[0, 0]))
        return np.asarray(scores, np.float32)
