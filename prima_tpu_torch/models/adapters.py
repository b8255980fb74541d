"""LoRA adapters and control vectors.

Counterpart of prima_tpu/models/adapters.py, as plain functions on tensors
on an explicit device. LoRA (llama_lora_adapter, llm_build_lora_mm): the
adapters stay beside the quantized base weights, never merged; the
forward computes y = W x + scale * B (A x), and several adapters stack.

GGUF layout (convert_lora_to_gguf.py): tensors `<base name>.lora_a` (r, K)
and `<base name>.lora_b` (N, r), the `adapter.lora.alpha` key; scale =
user_scale * alpha / r.

Control vectors (llama_control_vector_apply): per-layer directions
`direction.<layer>` added to the hidden state after each layer.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..gguf.reader import GGUFModel
from ..quant.dequant_np import dequantize_tensor

# gguf tensor suffix -> the layer's parameter name
_NAME_MAP = {
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_gate.weight": "w_gate",
    "ffn_up.weight": "w_up",
    "ffn_down.weight": "w_down",
}


def _tensor(ti, dtype, device) -> torch.Tensor:
    return torch.from_numpy(dequantize_tensor(ti).astype(np.float32)).to(device, dtype)


def load_lora_gguf(path: str, scale: float = 1.0, dtype=torch.bfloat16,
                   device=None) -> dict:
    """{layer index: {param name: (A, B, scale)}} plus 'head' entries;
    A (r, K), B (N, r), y += scale * (x @ A^T) @ B^T."""
    device = resolve_device(device)
    m = GGUFModel.open(path)
    alpha = float(m.get("adapter.lora.alpha", 0.0))
    out: dict = {}
    pairs: dict[str, dict] = {}
    for name, ti in m.tensors.items():
        if name.endswith(".lora_a"):
            pairs.setdefault(name[: -len(".lora_a")], {})["a"] = ti
        elif name.endswith(".lora_b"):
            pairs.setdefault(name[: -len(".lora_b")], {})["b"] = ti
    for base, ab in pairs.items():
        if "a" not in ab or "b" not in ab:
            raise ValueError(f"lora adapter missing pair for {base}")
        a, b = _tensor(ab["a"], dtype, device), _tensor(ab["b"], dtype, device)
        r = a.shape[0]
        s = scale * (alpha / r if alpha > 0 else 1.0)
        if base.startswith("blk."):
            _, idx, rest = base.split(".", 2)
            pname = _NAME_MAP.get(rest)
            if pname is None:
                continue
            out.setdefault(int(idx), {})[pname] = (a, b, s)
        elif base in ("token_embd", "output"):
            out.setdefault("head", {})[base] = (a, b, s)
    m.close()
    return out


def apply_lora(params: dict, lora: dict, scale: float = 1.0) -> dict:
    """Params with the adapter's tensors beside the base weights (the
    input is not changed). Applying another adapter stacks it: each
    parameter carries a list of (A, B, s) triples; `scale` multiplies the
    adapter's alpha / r (the server's /lora-adapters rescaling)."""
    params = dict(params)
    layers = list(params["layers"])
    for idx, mods in lora.items():
        if idx == "head":
            continue
        layer = dict(layers[idx])
        for pname, (a, b, s) in mods.items():
            layer[pname + "_lora"] = list(layer.get(pname + "_lora") or []) + [(a, b, s * scale)]
        layers[idx] = layer
    params["layers"] = layers
    return params


def lora_delta(x: torch.Tensor, ab: tuple) -> torch.Tensor:
    """scale * (x @ A^T) @ B^T in f32, in x's dtype: two thin products that
    the JAX package leaves to XLA and the port to torch.matmul."""
    a, b, s = ab
    h = torch.matmul(x.float(), a.float().t())
    return (torch.matmul(h, b.float().t()) * s).to(x.dtype)


def load_control_vector(path: str, strength: float = 1.0, dtype=torch.float32,
                        device=None) -> dict[int, torch.Tensor]:
    """{layer index: (n_embd,) direction} from a control-vector GGUF."""
    device = resolve_device(device)
    m = GGUFModel.open(path)
    out: dict[int, torch.Tensor] = {}
    for name, ti in m.tensors.items():
        if name.startswith("direction."):
            vec = dequantize_tensor(ti).astype(np.float32) * np.float32(strength)
            out[int(name.split(".")[1])] = torch.from_numpy(vec).to(device, dtype)
    m.close()
    return out


def apply_control_vector(params: dict, cvec: dict[int, torch.Tensor], layer_start: int = 0,
                         layer_end: int = 10**9) -> dict:
    params = dict(params)
    layers = list(params["layers"])
    for li, vec in cvec.items():
        # control-vector GGUFs count layers from 1: direction.i follows layer i - 1
        idx = li - 1
        if 0 <= idx < len(layers) and layer_start <= idx < layer_end:
            layers[idx] = dict(layers[idx], cvec=vec)
    params["layers"] = layers
    return params
