"""qwen2moe (llama.cpp build_qwen2moe) with its first `n_dense_lead`
layers dense, as DeepSeek's blocks lead with one: the qwen2 attention;
then a dense layer's SwiGLU FFN of `n_ff`, or a MoE layer's routed SwiGLU
experts of `n_ff_exp` under their top-k softmax weights as they are (not
renormalised), plus a shared SwiGLU expert of `n_ff_shexp` under a
per-token sigmoid gate (ffn_gate_inp_shexp)."""

import torch

from benchmark.archs.llama import (attention_cell, attention_params, attention_residual,
                                   attention_tensors, dense_ffn, expert_tensors, ffn_tensors)
from benchmark.blocks import F32
from benchmark.layout import Tensor, quant
from benchmark.reference import rms_norm
from benchmark.roofline import BlockCost


def tensors(model, types):
    e, v = model["n_embd"], model["n_vocab"]
    out = [quant(types, "token_embd.weight", (v, e))]
    for i in range(model["n_layers"]):
        p = f"blk.{i}."
        out += attention_tensors(model, types, p)
        out.append(Tensor(p + "ffn_norm.weight", (e,), F32, "norm"))
        if i < model["n_dense_lead"]:
            out += ffn_tensors(types, p, e, model["n_ff"])
        else:
            out += expert_tensors(types, p, e, model["n_ff_exp"], model["n_expert"])
            out.append(Tensor(p + "ffn_gate_inp_shexp.weight", (1, e), F32, "router"))
            out += ffn_tensors(types, p, e, model["n_ff_shexp"], "_shexp")
    out.append(Tensor("output_norm.weight", (e,), F32, "norm"))
    out.append(quant(types, "output.weight", (v, e)))
    return out


def block(ref, i, x, pos, lens):
    p = f"blk.{i}."
    x = attention_residual(ref, i, x, pos, lens)
    f = rms_norm(x, ref.w(p + "ffn_norm.weight"), ref.m["rms_eps"])
    if i < ref.m["n_dense_lead"]:
        return x + dense_ffn(ref, p, f)
    shared = dense_ffn(ref, p, f, "_shexp") * torch.sigmoid(
        f @ ref.w(p + "ffn_gate_inp_shexp.weight").t())
    return x + (ref.experts(i, f, norm=False) + shared)


def cost(model):
    e, n, lead = model["n_embd"], model["n_layers"], model["n_dense_lead"]
    dense = 3 * e * model["n_ff"]
    moe = (model["n_expert_used"] * 3 * e * model["n_ff_exp"] + e * model["n_expert"]
           + 3 * e * model["n_ff_shexp"] + e)
    flops_cell, bytes_cell = attention_cell(model)
    return BlockCost(2.0 * (n * attention_params(model) + lead * dense + (n - lead) * moe),
                     n * flops_cell, n * bytes_cell)
