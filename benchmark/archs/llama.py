"""The llama block: llama.cpp's build_llama, and build_qwen2 (archs/qwen2.py).

Each layer: RMSNorm, q / k / v (with biases where the model has
`qkv_bias`), RoPE on q and k (the model's `rope_type`: NORM for llama,
NEOX for qwen2), causal grouped-query attention, the output projection
and the residual; then RMSNorm and a SwiGLU FFN, or for a model with
`n_expert` a router over stacked SwiGLU experts whose top-k weights are
renormalised (Mixtral). Every layer has the same shape.
"""

from __future__ import annotations

from benchmark.blocks import F32
from benchmark.layout import Tensor, quant
from benchmark.reference import attention, linear, rms_norm, rope, swiglu
from benchmark.roofline import KV_BYTES, BlockCost


def attention_tensors(model: dict, types: dict, p: str) -> list[Tensor]:
    """A layer's attention norm and projections, prefix p = "blk.<i>."."""
    e, h, kvh, hd = model["n_embd"], model["n_heads"], model["n_kv_heads"], model["head_dim"]
    out = [Tensor(p + "attn_norm.weight", (e,), F32, "norm")]
    for n, rows in (("q", h * hd), ("k", kvh * hd), ("v", kvh * hd)):
        out.append(quant(types, p + f"attn_{n}.weight", (rows, e)))
        if model.get("qkv_bias"):
            out.append(Tensor(p + f"attn_{n}.bias", (rows,), F32, "bias"))
    out.append(quant(types, p + "attn_output.weight", (e, h * hd)))
    return out


def ffn_tensors(types: dict, p: str, e: int, f: int, suffix: str = "") -> list[Tensor]:
    """A SwiGLU FFN of width f: ffn_gate / ffn_up / ffn_down + suffix."""
    return [quant(types, p + f"ffn_gate{suffix}.weight", (f, e)),
            quant(types, p + f"ffn_up{suffix}.weight", (f, e)),
            quant(types, p + f"ffn_down{suffix}.weight", (e, f))]


def expert_tensors(types: dict, p: str, e: int, f: int, n_exp: int) -> list[Tensor]:
    """The f32 router and n_exp stacked SwiGLU experts of width f."""
    return [Tensor(p + "ffn_gate_inp.weight", (n_exp, e), F32, "router"),
            quant(types, p + "ffn_gate_exps.weight", (n_exp, f, e)),
            quant(types, p + "ffn_up_exps.weight", (n_exp, f, e)),
            quant(types, p + "ffn_down_exps.weight", (n_exp, e, f))]


def tensors(model: dict, types: dict) -> list[Tensor]:
    e, f, v, n_exp = model["n_embd"], model["n_ff"], model["n_vocab"], model.get("n_expert", 0)
    out = [quant(types, "token_embd.weight", (v, e))]
    for i in range(model["n_layers"]):
        p = f"blk.{i}."
        out += attention_tensors(model, types, p)
        out.append(Tensor(p + "ffn_norm.weight", (e,), F32, "norm"))
        out += expert_tensors(types, p, e, f, n_exp) if n_exp else ffn_tensors(types, p, e, f)
    out.append(Tensor("output_norm.weight", (e,), F32, "norm"))
    out.append(quant(types, "output.weight", (v, e)))
    return out


def attention_residual(ref, i: int, x, pos, lens):
    """x plus layer i's attention over it."""
    m, prec, p = ref.m, ref.precision, f"blk.{i}."
    h, kvh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    a = rms_norm(x, ref.w(p + "attn_norm.weight"), m["rms_eps"])
    qkv = []
    for n, heads in (("q", h), ("k", kvh), ("v", kvh)):
        y = linear(a, ref.w(p + f"attn_{n}.weight"), prec)
        if m.get("qkv_bias"):
            y = y + ref.w(p + f"attn_{n}.bias")
        qkv.append(y.reshape(-1, heads, hd))
    q, k, v = qkv
    q, k = (rope(t, pos, m["rope_base"], m["rope_type"]) for t in (q, k))
    return x + linear(attention(q, k, v, kvh, lens), ref.w(p + "attn_output.weight"), prec)


def dense_ffn(ref, p: str, f, suffix: str = ""):
    return swiglu(f, *(ref.w(p + f"ffn_{n}{suffix}.weight") for n in ("gate", "up", "down")),
                  ref.precision)


def block(ref, i: int, x, pos, lens):
    p = f"blk.{i}."
    x = attention_residual(ref, i, x, pos, lens)
    f = rms_norm(x, ref.w(p + "ffn_norm.weight"), ref.m["rms_eps"])
    return x + (ref.experts(i, f) if ref.m.get("n_expert") else dense_ffn(ref, p, f))


def attention_params(model: dict) -> int:
    """The weights of one layer's q, k, v and output projections."""
    e, h, kvh, hd = model["n_embd"], model["n_heads"], model["n_kv_heads"], model["head_dim"]
    return e * (h + 2 * kvh) * hd + h * hd * e


def attention_cell(model: dict) -> tuple[float, float]:
    """One layer's attention FLOPs a visible cell (QK^T and PV) and its
    cache bytes a cell (K and V)."""
    h, kvh, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    return 4.0 * hd * h, 2.0 * kvh * hd * KV_BYTES


def cost(model: dict) -> BlockCost:
    e, n_exp, n = model["n_embd"], model.get("n_expert", 0), model["n_layers"]
    ffn = (model.get("n_expert_used", 0) if n_exp else 1) * 3 * e * model["n_ff"]
    per_layer = attention_params(model) + ffn + e * n_exp  # the router's too
    flops_cell, bytes_cell = attention_cell(model)
    return BlockCost(n * 2.0 * per_layer, n * flops_cell, n * bytes_cell)
