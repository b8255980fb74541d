"""The tensors of a configuration's GGUF: names, shapes and types.

A configuration file (configs/<name>.json) states the model's sizes under
"model" and llama-quantize's type of each tensor under "types"; this module
turns them into the tensor table that both the synthetic GGUF and the
reference read. Shapes are numpy's (C order): the last axis is the GGUF
row length ne[0].
"""

from __future__ import annotations

from dataclasses import dataclass

from .blocks import F32, TYPE_IDS


@dataclass(frozen=True)
class Tensor:
    name: str
    shape: tuple
    ggml_type: int
    dense: str | None = None  # make_dense's kind for an F32 tensor


def tensor_type(types: dict, name: str) -> int:
    """The type of `name`: its own entry, else the entry of its suffix after
    "blk.<i>.", a type or a list of one type a layer."""
    if name in types:
        return TYPE_IDS[types[name]]
    parts = name.split(".", 2)
    t = types[parts[2]]
    return TYPE_IDS[t[int(parts[1])] if isinstance(t, list) else t]


def tensor_table(model: dict, types: dict) -> list[Tensor]:
    """Every tensor of the model, in the order of a llama.cpp GGUF."""
    e, h, kvh, hd = model["n_embd"], model["n_heads"], model["n_kv_heads"], model["head_dim"]
    f, v, n_exp = model["n_ff"], model["n_vocab"], model.get("n_expert", 0)
    quant = lambda name, shape: Tensor(name, shape, tensor_type(types, name))
    out = [quant("token_embd.weight", (v, e))]
    for i in range(model["n_layers"]):
        p = f"blk.{i}."
        out.append(Tensor(p + "attn_norm.weight", (e,), F32, "norm"))
        for n, rows in (("q", h * hd), ("k", kvh * hd), ("v", kvh * hd)):
            out.append(quant(p + f"attn_{n}.weight", (rows, e)))
            if model.get("qkv_bias"):
                out.append(Tensor(p + f"attn_{n}.bias", (rows,), F32, "bias"))
        out.append(quant(p + "attn_output.weight", (e, h * hd)))
        out.append(Tensor(p + "ffn_norm.weight", (e,), F32, "norm"))
        if n_exp:
            out.append(Tensor(p + "ffn_gate_inp.weight", (n_exp, e), F32, "router"))
            out += [quant(p + "ffn_gate_exps.weight", (n_exp, f, e)),
                    quant(p + "ffn_up_exps.weight", (n_exp, f, e)),
                    quant(p + "ffn_down_exps.weight", (n_exp, e, f))]
        else:
            out += [quant(p + "ffn_gate.weight", (f, e)), quant(p + "ffn_up.weight", (f, e)),
                    quant(p + "ffn_down.weight", (e, f))]
    out.append(Tensor("output_norm.weight", (e,), F32, "norm"))
    out.append(quant("output.weight", (v, e)))
    return out
