"""The decoder of every arch in the config table: GGUF weight loading and
the forward pass.

Counterpart of prima_tpu/models/llama.py on a single device. Parameters are
a dict of tensors and QTensors on one device; KV caches are tensors (or
KVQ8 / KVQ4) written in place (the JAX forward returns updated copies
instead). Attention takes the plain `gqa_attention` or, with
attn_impl="kernel", the flash kernels (not for softcap, sliding-window or
ALiBi attention, which they do not compute). Mixture-of-experts layers run
their experts through the expert-indexed GEMV at decode. deepseek2's
latent attention (MLA) caches one normed latent and one roped key a cell
and decodes in the absorbed form (`mla_attention`). LoRA adapters
(`*_lora`, models/adapters.py) ride beside the quantized weights of the
projections the JAX package adapts, and a control vector (`cvec`) is added
after its layer.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, replace
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..gguf.constants import GGMLType, TYPE_TRAITS
from ..gguf.reader import GGUFModel, TensorInfo
from ..ops.attention import flash_attention
from ..ops.kv_write import kv_write_plain
from ..ops.kvquant import KVQ4, KVQ8, kv_seq_len, update_kv_pair, update_kv_sp
from ..ops.layers import (alibi_mask, alibi_slopes, apply_rope, causal_mask, gated_act,
                          gqa_attention, gqa_attention_sp, layer_norm, mla_rope_params,
                          rms_norm, rope_freqs)
from ..quant.dequant_np import dequantize_tensor
from ..quant.device_format import SUPPORTED_TYPES, UQTensor, to_device_format
from ..quant.qmatmul import MAX_B, qgemv_indexed_plain, qmatmul, qmatmul_indexed
from ..quant.qtensor import (QTensor, dequant, dequant_rows, dequant_slices, qmatmul_plain,
                             qtensor_from_raw)
from ..utils.perf import count, span
from .adapters import lora_delta
from .config import ModelConfig

# ---------------------------------------------------------------------------
# Linear dispatch
# ---------------------------------------------------------------------------


# The capture of a decode graph in progress (runtime/decode_graph.py), or
# None: on its thread, `linear` over a quantized weight and the experts'
# call become the boundaries between the graph's segments, and the
# forward's spans (`_span`) its cut points.
_capture = None


def _capturing():
    """The decode graph's capture in progress on this thread, or None."""
    c = _capture
    if c is not None and c.thread == threading.get_ident():
        return c
    return None


def _span(name: str):
    """span(name), or while a decode graph is captured on this thread the
    capture's stand-in for it."""
    c = _capturing()
    return span(name) if c is None else c.span(name)


def linear(x: torch.Tensor, w, impl: str = "kernel") -> torch.Tensor:
    """x (..., K) @ W(rows, K)^T -> (..., rows). impl "kernel" streams
    quantized weights through the GEMV kernel; "plain" dequantizes and
    multiplies in PyTorch (the counterpart of --matmul xla)."""
    if isinstance(w, QTensor):
        if impl == "plain":
            return qmatmul_plain(x, w)
        if impl != "kernel":
            raise ValueError(f"unknown matmul_impl {impl!r}")
        c = _capturing()
        return qmatmul(x, w) if c is None else c.gemv(x, w)
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


def linear_l(layer: dict, name: str, x: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
    """A layer's linear with its LoRA adapters: y = W x + scale * B (A x)."""
    y = linear(x, layer[name], impl)
    for ab in layer.get(name + "_lora") or ():
        y = y + lora_delta(x, ab)
    return y


def embed(tok_embd, token_ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Row gather + dequant of the embedding table."""
    if isinstance(tok_embd, QTensor):
        return dequant_rows(tok_embd, token_ids, dtype)
    return tok_embd[token_ids].to(dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _quant_tensor(raw: np.ndarray, t, shape: tuple[int, int], device) -> QTensor:
    """GGUF blocks (rows, row_bytes) -> QTensor: the native converter where
    it takes the type, else the numpy route (the same bits)."""
    qt = qtensor_from_raw(raw, t, shape, device)
    if qt is None:
        qt = QTensor.from_host(to_device_format(raw, t, shape[1]), device)
    return qt


def _to_device_tensor(ti: TensorInfo, dtype, device, dense: bool = False):
    """GGUF tensor -> QTensor (quantized) or dense tensor in `dtype`."""
    t = ti.ggml_type
    if TYPE_TRAITS[t].is_quantized and not dense and t in SUPPORTED_TYPES:
        return _quant_tensor(ti.data, t, (ti.n_elements // ti.ne[0], ti.ne[0]), device)
    return torch.from_numpy(dequantize_tensor(ti).astype(np.float32)).to(
        device=device, dtype=dtype)


def _fuse_tensor_rows(tis: Sequence[TensorInfo], device):
    """Concatenate quantized tensors along output rows at the raw block
    level; None when their types differ or are not quantized."""
    t0, k = tis[0].ggml_type, tis[0].ne[0]
    if not all(ti.ggml_type == t0 and ti.ne[0] == k for ti in tis):
        return None
    if not (TYPE_TRAITS[t0].is_quantized and t0 in SUPPORTED_TYPES):
        return None
    raw = np.ascontiguousarray(np.concatenate(
        [np.asarray(ti.data).reshape(ti.n_elements // k, -1) for ti in tis]))
    return _quant_tensor(raw, t0, (raw.shape[0], k), device)


def _split_tensor_rows(ti: TensorInfo, dtype, device, bounds: Sequence[int]) -> list:
    """A GGUF tensor cut along output rows at `bounds` (fused qkv or
    gate+up): quant blocks slice cleanly by row."""
    t, k = ti.ggml_type, ti.ne[0]
    if TYPE_TRAITS[t].is_quantized and t in SUPPORTED_TYPES:
        raw = np.asarray(ti.data).reshape(ti.n_elements // k, -1)
        return [_quant_tensor(np.ascontiguousarray(raw[r0:r1]), t, (r1 - r0, k), device)
                for r0, r1 in zip(bounds[:-1], bounds[1:])]
    full = torch.from_numpy(dequantize_tensor(ti).astype(np.float32)).reshape(-1, k)
    return [full[r0:r1].to(device=device, dtype=dtype) for r0, r1 in zip(bounds[:-1], bounds[1:])]


def _stack_experts(w, n_expert: int):
    """Stacked expert weights. A QTensor keeps its E * N rows (expert e is
    rows [e N, (e + 1) N), as the GGUF stores them, which is what the
    expert-indexed GEMV reads); a dense tensor becomes (E, N, K)."""
    if isinstance(w, QTensor) or (w.dim() == 3 and w.shape[0] == n_expert):
        return w
    return w.reshape(n_expert, w.shape[0] // n_expert, *w.shape[1:])


# optional per-layer tensors: GGUF name -> params key
_OPTIONAL = (("attn_q_norm.weight", "attn_q_norm"), ("attn_k_norm.weight", "attn_k_norm"),
             ("attn_q_norm.bias", "attn_q_norm_b"), ("attn_k_norm.bias", "attn_k_norm_b"),
             ("attn_norm.bias", "attn_norm_b"), ("ffn_norm.bias", "ffn_norm_b"),
             ("attn_output.bias", "bo"), ("ffn_up.bias", "b_up"),
             ("ffn_gate.bias", "b_gate"), ("ffn_down.bias", "b_down"),
             # bitnet: RMS sub-norms and per-tensor scales
             ("attn_sub_norm.weight", "attn_sub_norm"), ("ffn_sub_norm.weight", "ffn_sub_norm"),
             ("attn_q.scale", "wq_scale"), ("attn_k.scale", "wk_scale"),
             ("attn_v.scale", "wv_scale"), ("attn_output.scale", "wo_scale"),
             ("ffn_up.scale", "w_up_scale"), ("ffn_gate.scale", "w_gate_scale"),
             ("ffn_down.scale", "w_down_scale"))


def load_params(m: GGUFModel, cfg: ModelConfig, device, dtype=torch.bfloat16,
                fuse: bool = False, layer_filter: Callable[[int], bool] | None = None,
                with_embedding: bool = True, with_output: bool = True) -> dict:
    """Params dict from a GGUF model: the tensor tables of every arch the
    decoder serves (prima_tpu/models/llama.py:163-365). fuse=True
    concatenates Q/K/V and gate/up into wqkv / w_gateup where their quant
    types match and no bias, scale or sub-norm sits between them: fewer
    GEMV launches, identical numerics.

    Rank-aware loading (a ring rank holds only its own windows):
    layer_filter(i) False leaves layer i None and reads none of its bytes;
    with_embedding / with_output load the embedding tables and the output
    head."""
    t = m.tensors
    get = _getter(t, dtype, device)
    params: dict[str, Any] = {"layers": []}
    if with_embedding:
        params["tok_embd"] = get("token_embd.weight")
        _add_optional(params, t, get, (("position_embd.weight", "pos_embd"),
                                       ("token_embd_norm.weight", "tok_embd_norm"),
                                       ("token_embd_norm.bias", "tok_embd_norm_b")))
    for i in range(cfg.n_layers):
        if layer_filter is not None and not layer_filter(i):
            params["layers"].append(None)
            continue
        params["layers"].append(_load_layer(m, cfg, i, device, dtype, fuse))
    if with_output:
        params["output_norm"] = get("output_norm.weight", dense=True,
                                    required=cfg.norm_type == "rms")
        _add_optional(params, t, get, (("output_norm.bias", "output_norm_b"),
                                       ("output.bias", "output_b")))
        params["output"] = None if cfg.tie_embeddings else get("output.weight")
    return params


def _getter(t: dict, dtype, device):
    def get(name, dense=False, required=True):
        ti = t.get(name)
        if ti is None:
            if required:
                raise KeyError(f"missing tensor {name}")
            return None
        return _to_device_tensor(ti, dtype, device, dense)
    return get


def _add_optional(dst: dict, t: dict, get, table, prefix: str = "") -> None:
    for name, key in table:
        if prefix + name in t:
            dst[key] = get(prefix + name, dense=True)


def gguf_host_layer(m: GGUFModel, cfg: ModelConfig, i: int, dtype=torch.bfloat16,
                    fuse: bool = False) -> dict:
    """Layer i of a GGUF model in host memory, in the device format the
    kernels read: what `load_params` puts on the device for that layer, on
    the CPU (prima_tpu/models/llama.py:706). runtime/streaming.py pins it
    and streams it to the device."""
    return _load_layer(m, cfg, i, "cpu", dtype, fuse)


def _load_layer(m: GGUFModel, cfg: ModelConfig, i: int, device, dtype, fuse: bool) -> dict:
    """The params of block i on `device`."""
    t = m.tensors
    get = _getter(t, dtype, device)

    def first(*names):
        """The first of `names` the file holds, dense, or None."""
        return next((get(n, dense=True) for n in names if n in t), None)

    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ln = cfg.norm_type != "rms"
    p = f"blk.{i}."
    if cfg.kv_lora_rank:
        return _load_mla_layer(m, cfg, i, device, dtype, fuse)
    layer = {
        # LN archs may omit norm weights (OLMo's non-parametric norm) or
        # the ffn_norm (command-r's parallel block)
        "attn_norm": get(p + "attn_norm.weight", dense=True, required=not ln),
        "wo": get(p + "attn_output.weight"),
        "ffn_norm": get(p + "ffn_norm.weight", dense=True,
                        required=not (ln or cfg.parallel_block)),
    }
    if layer["ffn_norm"] is None:
        layer["ffn_norm"] = first(p + "attn_out_norm.weight")  # dbrx's pre-MoE norm
    if (p + "attn_norm_2.weight") in t:  # falcon-40b: the parallel MLP's own norm
        layer["ffn_norm"] = get(p + "attn_norm_2.weight", dense=True)
        _add_optional(layer, t, get, (("attn_norm_2.bias", "ffn_norm_b"),), p)
    if (p + "attn_qkv.weight") in t:  # phi3 / openelm: fused qkv, by rows
        hi = cfg.n_heads_arr[i] if cfg.n_heads_arr else h
        kvi = cfg.n_kv_heads_arr[i] if cfg.n_kv_heads_arr else kvh
        nq, nk = hi * hd, kvi * hd
        layer["wq"], layer["wk"], layer["wv"] = _split_tensor_rows(
            t[p + "attn_qkv.weight"], dtype, device, [0, nq, nq + nk, nq + 2 * nk])
    else:
        qkv = [t[p + n] for n in ("attn_q.weight", "attn_k.weight", "attn_v.weight")]
        fused = (_fuse_tensor_rows(qkv, device)
                 if fuse and not (cfg.n_heads_arr or cfg.n_kv_heads_arr) else None)
        if fused is not None:
            layer["wqkv"] = fused
        else:
            layer["wq"], layer["wk"], layer["wv"] = (
                _to_device_tensor(ti, dtype, device) for ti in qkv)
    if cfg.n_expert and (p + "ffn_gate_inp.weight") in t:
        # router and stacked experts (Mixtral, qwen2moe, grok, ...)
        layer["ffn_gate_inp"] = get(p + "ffn_gate_inp.weight", dense=True)
        for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
            layer[key] = _stack_experts(get(p + key + ".weight"), cfg.n_expert)
        if (p + "ffn_gate_shexp.weight") in t:
            # shared experts: qwen2moe's under a per-token sigmoid gate,
            # deepseek2's ungated (its expert_shared_count of them as one FFN)
            for key in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"):
                layer[key] = get(p + key + ".weight")
            if (p + "ffn_gate_inp_shexp.weight") in t:
                layer["ffn_gate_inp_shexp"] = get(p + "ffn_gate_inp_shexp.weight", dense=True)
        if cfg.moe_parallel_dense:  # arctic: a dense FFN beside the experts
            for key, name in (("w_gate", "ffn_gate"), ("w_up", "ffn_up"),
                              ("w_down", "ffn_down")):
                layer[key] = get(p + name + ".weight", required=False)
            layer["ffn_norm_exps"] = first(p + "ffn_norm_exps.weight")
    elif not cfg.ffn_gated:  # starcoder2 and kin: up -> act -> down
        layer["w_up"] = get(p + "ffn_up.weight")
        layer["w_down"] = get(p + "ffn_down.weight")
    elif (p + "ffn_gate.weight") not in t and (p + "ffn_up.weight") in t:
        # phi3: fused gate+up, rows [0, n_ff) the gate, [n_ff, 2 n_ff) up
        layer["w_gate"], layer["w_up"] = _split_tensor_rows(
            t[p + "ffn_up.weight"], dtype, device, [0, cfg.n_ff, 2 * cfg.n_ff])
        layer["w_down"] = get(p + "ffn_down.weight")
    else:
        gu = [t[p + "ffn_gate.weight"], t[p + "ffn_up.weight"]]
        fused = None
        if fuse and not any((p + n) in t for n in (
                "ffn_gate.bias", "ffn_up.bias", "ffn_gate.scale", "ffn_up.scale",
                "ffn_down.scale", "ffn_sub_norm.weight")):
            fused = _fuse_tensor_rows(gu, device)
        if fused is not None:
            layer["w_gateup"] = fused
        else:
            layer["w_gate"], layer["w_up"] = (
                _to_device_tensor(ti, dtype, device) for ti in gu)
        layer["w_down"] = get(p + "ffn_down.weight")
    if cfg.post_norms:  # gemma2 / grok, under three names
        layer["attn_post_norm"] = first(p + "post_attention_norm.weight",
                                        p + "attn_out_norm.weight")
        layer["ffn_post_norm"] = first(p + "post_ffw_norm.weight",
                                       p + "layer_output_norm.weight",
                                       p + "layer_out_norm.weight")
    if (p + "attn_qkv.bias") in t:  # phi2: fused qkv bias
        bqkv = get(p + "attn_qkv.bias", dense=True)
        nq, nk = h * hd, kvh * hd
        layer["bq"], layer["bk"], layer["bv"] = (
            bqkv[:nq], bqkv[nq:nq + nk], bqkv[nq + nk:nq + 2 * nk])
    elif cfg.qkv_bias or (p + "attn_q.bias") in t:
        layer["bq"] = get(p + "attn_q.bias", dense=True)
        layer["bk"] = get(p + "attn_k.bias", dense=True)
        layer["bv"] = get(p + "attn_v.bias", dense=True)
    _add_optional(layer, t, get, _OPTIONAL, p)
    return layer


def _load_mla_layer(m: GGUFModel, cfg: ModelConfig, i: int, device, dtype,
                    fuse: bool) -> dict:
    """Block i of a deepseek2 GGUF (llm_load_tensors' deepseek2 case): every
    quantized weight under its GGUF name, as its own QTensor, and beside
    them the dense key and value halves of attn_kv_b per head in `dtype`
    (`mla_k_b` (h, qk_nope, kv_lora_rank), `mla_v_b` (h, v_head_dim,
    kv_lora_rank)), which the absorbed attention multiplies; then the
    layer's FFN: dense for the first n_dense_lead layers (llama's keys),
    else the router, the stacked experts and the shared experts."""
    t = m.tensors
    get = _getter(t, dtype, device)
    p = f"blk.{i}."
    layer = {"attn_norm": get(p + "attn_norm.weight", dense=True),
             "attn_kv_a_mqa": get(p + "attn_kv_a_mqa.weight"),
             "attn_kv_a_norm": get(p + "attn_kv_a_norm.weight", dense=True),
             "attn_kv_b": get(p + "attn_kv_b.weight"),
             "attn_output": get(p + "attn_output.weight"),
             "ffn_norm": get(p + "ffn_norm.weight", dense=True)}
    if cfg.q_lora_rank:
        layer["attn_q_a"] = get(p + "attn_q_a.weight")
        layer["attn_q_a_norm"] = get(p + "attn_q_a_norm.weight", dense=True)
        layer["attn_q_b"] = get(p + "attn_q_b.weight")
    else:
        layer["attn_q"] = get(p + "attn_q.weight")
    kv_b = torch.from_numpy(dequantize_tensor(t[p + "attn_kv_b.weight"]).astype(np.float32))
    kv_b = kv_b.reshape(cfg.n_heads, cfg.qk_nope + cfg.v_head_dim, cfg.kv_lora_rank)
    layer["mla_k_b"] = kv_b[:, :cfg.qk_nope].contiguous().to(device=device, dtype=dtype)
    layer["mla_v_b"] = kv_b[:, cfg.qk_nope:].contiguous().to(device=device, dtype=dtype)
    if cfg.n_expert and (p + "ffn_gate_inp.weight") in t:
        layer["ffn_gate_inp"] = get(p + "ffn_gate_inp.weight", dense=True)
        for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
            layer[key] = _stack_experts(get(p + key + ".weight"), cfg.n_expert)
        if (p + "ffn_gate_shexp.weight") in t:
            for key in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"):
                layer[key] = get(p + key + ".weight")
    else:
        for key, name in (("w_gate", "ffn_gate"), ("w_up", "ffn_up"), ("w_down", "ffn_down")):
            layer[key] = get(p + name + ".weight")
    return layer


def params_from_numpy(tree, device, dtype=None):
    """The JAX package's params after jax.device_get -> the port's params:
a decoder's, an encoder's (models/bert.py, QTensor leaves where
quantized), an mmproj's (models/clip.py, all dense) or a dense family
runtime's (models/{deepseek2,mamba,rwkv6,t5}.py: nested lists of dicts
with None leaves, such as a missing `output`, `rope_long` / `rope_short`,
T5's `rel_b` past block 0 or `w_gate` of a ReLU T5).

    Dense arrays (bf16 ones too, as ml_dtypes arrays) carry across in
    `dtype` when it is given, else in their own dtype.

    Each JAX QTensor comes as a plain dict of its numpy fields and metadata
    (qs, scales, mins, d, dmin, sub, layout, q_offset, shape, kperm, gsub,
    packed); dense arrays come as numpy arrays. The sigma column order
    (kperm) and the sigma-ordered packed codes are undone, then the tensor
    is repacked in the port's natural layout. Stacked experts (fields with
    a leading expert axis) carry across expert by expert into the E * N
    rows the port's loader gives."""
    if isinstance(tree, dict) and "qs" in tree and "layout" in tree:
        if np.ndim(tree["qs"]) == 3:
            return QTensor.from_host(_cat_uq_rows([
                _natural_uq({k: v[e] if isinstance(v, np.ndarray) else v
                             for k, v in tree.items()})
                for e in range(tree["qs"].shape[0])]), device)
        return QTensor.from_host(_natural_uq(tree), device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":  # ml_dtypes: widened exactly, then narrowed back
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype or torch.bfloat16)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, dtype) if dtype is not None and t.is_floating_point() else t.to(device)


def _cat_uq_rows(uqs: list) -> UQTensor:
    """Host UQTensors of one format concatenated along their rows."""
    u0 = uqs[0]
    cat = lambda f: (None if getattr(u0, f) is None
                     else np.concatenate([getattr(u, f) for u in uqs]))
    return UQTensor(cat("qs"), cat("scales"), cat("mins"), u0.sub, u0.layout, u0.q_offset,
                    None, (sum(u.shape[0] for u in uqs), u0.shape[1]), d=cat("d"),
                    dmin=cat("dmin"), gsub=u0.gsub)


def _f16_bits_np(bits: np.ndarray) -> np.ndarray:
    return bits.astype(np.uint16).view(np.float16).astype(np.float32)


def _natural_uq(f: dict) -> UQTensor:
    sub, gsub, layout = int(f["sub"]), int(f["gsub"]), f["layout"]
    rows, k = (int(v) for v in f["shape"])
    qs, scales, mins, d, dmin = (f.get(n) for n in ("qs", "scales", "mins", "d", "dmin"))
    if f.get("packed"):
        a1 = scales.astype(np.int32)
        a2 = mins.astype(np.int32)
        scales = (a1 & 63).astype(np.int8)
        mins = (((a1 >> 6) << 4) | np.concatenate([a2 & 15, a2 >> 4], axis=-1)).astype(np.int8)
        du = d.view(np.uint32)
        d, dmin = _f16_bits_np(du & 0xFFFF), _f16_bits_np(du >> 16)
    if f.get("kperm"):
        s = k // sub
        g = s // gsub

        def subs(a):  # sigma order (w, g) -> natural (g, w)
            return None if a is None else np.ascontiguousarray(
                a.reshape(rows, gsub, g).swapaxes(1, 2).reshape(rows, s))

        def cols(a):  # stored (t, w, g) -> natural (g, w, t)
            return np.ascontiguousarray(
                a.reshape(rows, sub, gsub, g).transpose(0, 3, 2, 1).reshape(rows, k))

        scales, mins = subs(scales), subs(mins)
        if layout == "nib4":
            raw = cols(np.concatenate([qs & 0x0F, qs >> 4], axis=-1))
            qs = (raw[:, : k // 2] | (raw[:, k // 2:] << 4)).astype(np.uint8)
        else:
            qs = cols(qs)
    return UQTensor(qs, scales, mins, sub, layout, int(f["q_offset"]), None,
                    (rows, k), d=d, dmin=dmin, gsub=gsub)


def synth_qtensor_device(gen: torch.Generator, rows: int, k: int,
                         t: GGMLType = GGMLType.Q4_K, device=None,
                         zero_mean: bool = False) -> QTensor:
    """Random QTensor generated on the device from `gen` (no host copy),
    with the byte layout of real weights of the same format. The weights of
    a format with mins average a quarter to a half of qmax scales above 0,
    so every output of a product shares one common mode; `zero_mean` puts
    each sub-block's min at half its scale's range (w = scale (q - qmax /
    2)), centred as trained weights are. It draws the same numbers from
    `gen` either way."""
    table = {  # type -> (sub, layout, q_offset, qmax, has_mins, gsub)
        GGMLType.Q4_K: (32, "nib4", 0, 15, True, 8),
        GGMLType.Q4_0: (32, "nib4", -8, 8, False, 1),
        GGMLType.Q8_0: (32, "int8", 0, 127, False, 1),
        GGMLType.Q6_K: (16, "int8", 0, 31, False, 16),
        GGMLType.Q5_K: (32, "int8", 0, 31, True, 8),
    }
    if t not in table:
        raise NotImplementedError(f"device synth for {t.name}")
    sub, layout, off, qmax, has_mins, gsub = table[t]
    device = device or gen.device
    ri = lambda lo, hi, shape, dt: torch.randint(lo, hi, shape, generator=gen,
                                                 device=device, dtype=dt)
    if layout == "nib4":
        qs = ri(0, 256, (rows, k // 2), torch.uint8)
    else:
        qs = ri(-qmax, qmax + 1, (rows, k), torch.int8)
    s = k // sub
    if s % gsub:
        gsub = 1  # sub-superblock shapes: flat scales
    if gsub == 1:
        scales = torch.rand((rows, s), generator=gen, device=device) * (0.02 / qmax) + 1e-4
        mins = (scales * torch.rand((rows, s), generator=gen, device=device) * (qmax / 2)
                if has_mins else None)
        if has_mins and zero_mean:
            mins = scales * (qmax / 2)
        return QTensor(qs, scales, mins, sub, layout, off, (rows, k))
    g = s // gsub
    # bases rounded to f16 values, like real GGUF d / dmin
    d = (torch.randn((rows, g), generator=gen, device=device).abs()
         * (0.02 / qmax / 32) + 1e-6).half().float()
    dmin = ((torch.randn((rows, g), generator=gen, device=device).abs()
             * (0.01 / qmax / 32)).half().float() if has_mins else None)
    codes = ri(1, 64, (rows, s), torch.int8)
    mcodes = ri(0, 64, (rows, s), torch.int8) if has_mins else None
    if has_mins and zero_mean:  # the min code is the scale code, dmin = d qmax / 2
        mcodes, dmin = codes, (d * (qmax / 2)).half().float()
    if has_mins and s % 16 == 0:
        sc, mn = codes.to(torch.int32), mcodes.to(torch.int32)
        a1 = (sc | ((mn >> 4) << 6)).to(torch.uint8)
        a2 = ((mn[:, : s // 2] & 15) | ((mn[:, s // 2:] & 15) << 4)).to(torch.uint8)
        bits = lambda v: v.half().view(torch.int16).to(torch.int32) & 0xFFFF
        pair = (bits(dmin) << 16) | bits(d)
        return QTensor(qs, a1, a2, sub, layout, off, (rows, k), d=pair.contiguous(),
                       gsub=gsub, packed=True)
    return QTensor(qs, codes, mcodes, sub, layout, off, (rows, k), d=d, dmin=dmin,
                   gsub=gsub)


def synth_params_device(cfg: ModelConfig, ggml_type: GGMLType = GGMLType.Q4_K,
                        seed: int = 0, device=None) -> dict:
    """Random params generated on `device` from a seeded torch.Generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params: dict[str, Any] = synth_head_device(cfg, gen, ggml_type, device)
    params["layers"] = [synth_layer_device(cfg, gen, ggml_type, device)
                        for _ in range(cfg.n_layers)]
    return params


def synth_head_device(cfg: ModelConfig, gen: torch.Generator,
                      ggml_type: GGMLType = GGMLType.Q4_K, device=None) -> dict:
    """The embedding, output norm and output head, drawn from `gen`."""
    e = cfg.n_embd
    head: dict[str, Any] = {"tok_embd": synth_qtensor_device(gen, cfg.n_vocab, e, ggml_type,
                                                             device),
                            "output_norm": torch.ones(e, dtype=torch.float32, device=device)}
    head["output"] = (None if cfg.tie_embeddings
                      else synth_qtensor_device(gen, cfg.n_vocab, e, ggml_type, device))
    return head


def synth_layer_device(cfg: ModelConfig, gen: torch.Generator,
                       ggml_type: GGMLType = GGMLType.Q4_K, device=None) -> dict:
    """One decoder layer's params, drawn from `gen`."""
    e, h, kvh, hd, f = cfg.n_embd, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_ff
    q = lambda rows, k: synth_qtensor_device(gen, rows, k, ggml_type, device)
    ones = lambda: torch.ones(e, dtype=torch.float32, device=device)
    layer = {"attn_norm": ones(), "wq": q(h * hd, e), "wk": q(kvh * hd, e),
             "wv": q(kvh * hd, e), "wo": q(e, h * hd), "ffn_norm": ones(),
             "w_gate": q(f, e), "w_up": q(f, e), "w_down": q(e, f)}
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd)):
            layer[name] = torch.randn(n, generator=gen, device=device) * 0.02
    return layer


def synth_host_layer(cfg: ModelConfig, i: int, ggml_type: GGMLType = GGMLType.Q4_K,
                     seed: int = 0) -> dict:
    """Host (UQTensor / numpy) tensors for one synthetic layer, drawn as
    the JAX package draws them (prima_tpu/models/llama.py:653-674): the
    input unit of pipeline / tp sharding in tests against that package."""
    rng = np.random.default_rng(seed * 1000003 + i)
    e, h, kvh, hd, f = cfg.n_embd, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_ff
    layer = {
        "attn_norm": np.ones(e, dtype=np.float32),
        "wq": _synth_uq(rng, h * hd, e, ggml_type),
        "wk": _synth_uq(rng, kvh * hd, e, ggml_type),
        "wv": _synth_uq(rng, kvh * hd, e, ggml_type),
        "wo": _synth_uq(rng, e, h * hd, ggml_type),
        "ffn_norm": np.ones(e, dtype=np.float32),
        "w_gate": _synth_uq(rng, f, e, ggml_type),
        "w_up": _synth_uq(rng, f, e, ggml_type),
        "w_down": _synth_uq(rng, e, f, ggml_type),
    }
    if cfg.qkv_bias:
        layer["bq"] = rng.standard_normal(h * hd).astype(np.float32) * 0.02
        layer["bk"] = rng.standard_normal(kvh * hd).astype(np.float32) * 0.02
        layer["bv"] = rng.standard_normal(kvh * hd).astype(np.float32) * 0.02
    return layer


def synth_host_head(cfg: ModelConfig, ggml_type: GGMLType = GGMLType.Q4_K,
                    seed: int = 0) -> dict:
    """Host tensors for the embedding, output norm and head (synthetic)."""
    rng = np.random.default_rng(seed)
    return {
        "tok_embd": _synth_uq(rng, cfg.n_vocab, cfg.n_embd, ggml_type),
        "output_norm": np.ones(cfg.n_embd, dtype=np.float32),
        "output": (None if cfg.tie_embeddings
                   else _synth_uq(rng, cfg.n_vocab, cfg.n_embd, ggml_type)),
    }


def _synth_uq(rng, rows, k, t: GGMLType) -> UQTensor:
    """A UQTensor of ~N(0, 0.02) weights drawn from rng, without a GGUF
    round trip (prima_tpu/models/llama.py:782-827)."""
    if t == GGMLType.Q4_K:
        sub, layout, off = 32, "nib4", 0
        qs = rng.integers(0, 256, size=(rows, k // 2), dtype=np.uint16).astype(np.uint8)
    elif t == GGMLType.Q4_0:
        sub, layout, off = 32, "nib4", -8
        qs = rng.integers(0, 256, size=(rows, k // 2), dtype=np.uint16).astype(np.uint8)
    elif t in (GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K):
        sub = 32 if t != GGMLType.Q6_K else 16
        layout, off = "int8", 0
        lim = {GGMLType.Q8_0: 127, GGMLType.Q6_K: 31, GGMLType.Q5_K: 31}[t]
        qs = rng.integers(-lim, lim + 1, size=(rows, k), dtype=np.int16).astype(np.int8)
    else:
        raise NotImplementedError(f"synth for {t.name}")
    qmax = {GGMLType.Q4_K: 15, GGMLType.Q4_0: 8, GGMLType.Q8_0: 127, GGMLType.Q6_K: 31,
            GGMLType.Q5_K: 31}[t]
    s = k // sub
    gsub = {GGMLType.Q4_K: 8, GGMLType.Q5_K: 8, GGMLType.Q6_K: 16}.get(t, 1)
    if s % gsub:
        gsub = 1  # synthetic sub-superblock shapes: flat scales
    if gsub > 1:
        has_mins = t in (GGMLType.Q4_K, GGMLType.Q5_K)
        codes = rng.integers(1, 64, size=(rows, s), dtype=np.int16).astype(np.int8)
        mcodes = (rng.integers(0, 32, size=(rows, s), dtype=np.int16).astype(np.int8)
                  if has_mins else None)
        # bases rounded to f16 values, like real GGUF d / dmin
        d = ((np.abs(rng.standard_normal((rows, s // gsub))) * (0.02 / qmax / 32)
              + 1e-6).astype(np.float16)).astype(np.float32)
        dmin = ((np.abs(rng.standard_normal((rows, s // gsub))) * (0.01 / qmax / 32)
                 ).astype(np.float16)).astype(np.float32) if has_mins else None
        return UQTensor(qs, codes, mcodes, sub, layout, off, t, (rows, k),
                        d=d, dmin=dmin, gsub=gsub)
    scales = (np.abs(rng.standard_normal((rows, s))) * 0.02 / qmax + 1e-4).astype(np.float32)
    mins = None
    if t in (GGMLType.Q4_K, GGMLType.Q5_K):
        mins = (scales * rng.uniform(0, qmax / 2, size=scales.shape)).astype(np.float32)
    return UQTensor(qs, scales, mins, sub, layout, off, t, (rows, k))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ForwardOptions:
    matmul_impl: str = "kernel"  # "plain" = dequantize + torch.matmul
    attn_impl: str = "plain"  # "kernel" = the flash attention kernels
    dtype: torch.dtype = torch.bfloat16
    logits_dtype: torch.dtype = torch.float32
    # tensor parallelism (parallel/tp.py): wq/wk/wv/gate/up are row-sharded
    # (local heads, local FFN columns), wo/down column-sharded, and their
    # partial outputs are summed over this group (a parallel.mesh.Axis)
    tp_group: Any = None
    # sequence parallelism: the caches hold this group's shard of the T
    # axis; attention runs per shard and combines by log-sum-exp
    # (ops/layers.gqa_attention_sp)
    sp_group: Any = None


def _tp_sum(y: torch.Tensor, opts: ForwardOptions) -> torch.Tensor:
    """The sum of the tp ranks' partial outputs (the JAX psum over tp)."""
    return y if opts.tp_group is None else opts.tp_group.all_reduce(y)


def _flash_route(cfg: ModelConfig, opts: ForwardOptions) -> bool:
    """attn_impl "kernel" takes the flash kernels, except for the attention
    variants they do not compute (as llama.py:962-963 of the JAX package),
    latent attention among them."""
    if opts.attn_impl not in ("plain", "kernel"):
        raise ValueError(f"unknown attn_impl {opts.attn_impl!r}")
    return (opts.attn_impl == "kernel" and not cfg.attn_logit_softcap
            and not cfg.swa_window and not cfg.alibi_max_bias and not cfg.kv_lora_rank)


def model_norm(x: torch.Tensor, w, b, cfg: ModelConfig) -> torch.Tensor:
    """The arch's norm: RMSNorm, or LayerNorm (weight and bias optional)."""
    if cfg.norm_type == "rms":
        return rms_norm(x, w, cfg.rms_eps)
    return layer_norm(x, w, b, cfg.rms_eps)


def _scaled(y: torch.Tensor, layer: dict, key: str) -> torch.Tensor:
    """y times the layer's per-tensor scale `key` (bitnet), where it has one."""
    sc = layer.get(key)
    return y if sc is None else y * sc.to(y.dtype)


def _biased(y: torch.Tensor, layer: dict, key: str) -> torch.Tensor:
    b = layer.get(key)
    return y if b is None else y + b.to(y.dtype)


def attention_block(layer: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, kv: tuple, cache_pos: torch.Tensor,
                    mask: torch.Tensor | None, inv_freq: torch.Tensor, mscale: float,
                    opts: ForwardOptions, mask_pos: torch.Tensor | None = None,
                    heads: tuple[int, int] | None = None, taps: dict | None = None,
                    tap_prefix: str = "", kq_scale: float | None = None) -> torch.Tensor:
    """x (b, s, e) normed input. Writes this step's K/V into the caches in
    place and returns the attention output (b, s, e). Visibility follows
    mask_pos (the physical cache order) where given, else positions; the
    two differ only under Self-Extend. heads is a layer's own (h, kvh)
    (openelm). taps collects the inputs of the four projections (`_tap`),
    under their GGUF names whether or not the layer fused Q/K/V. A layer
    of latent attention takes `mla_attention`, with YaRN's kq_scale
    (`mla_rope_params`)."""
    if cfg.kv_lora_rank:
        if opts.tp_group is not None or opts.sp_group is not None:
            raise NotImplementedError("latent attention under tensor or sequence parallelism")
        return mla_attention(layer, cfg, x, positions, kv, cache_pos, mask, inv_freq, mscale,
                             kq_scale, opts)
    b, s, _ = x.shape
    hd = cfg.head_dim
    h, kvh = heads if heads is not None else (cfg.n_heads, cfg.n_kv_heads)
    for n in ("attn_q", "attn_k", "attn_v"):
        _tap(taps, tap_prefix + n + ".weight", x)
    if layer.get("wqkv") is not None:
        qkv = linear(x, layer["wqkv"], opts.matmul_impl)
        q, k, v = qkv.split([h * hd, kvh * hd, kvh * hd], dim=-1)
    else:
        q, k, v = (linear_l(layer, n, x, opts.matmul_impl) for n in ("wq", "wk", "wv"))
    q, k, v = (_biased(_scaled(a, layer, f"w{n}_scale"), layer, f"b{n}")
               for a, n in zip((q, k, v), "qkv"))
    if cfg.clamp_kqv:  # olmo / dbrx / mpt
        c = float(np.float32(cfg.clamp_kqv))
        q, k, v = (a.clamp(-c, c) for a in (q, k, v))
    if layer.get("attn_q_norm") is not None and not cfg.qk_norm_head:
        # olmoe: RMS over the whole q / k vectors
        q = rms_norm(q, layer["attn_q_norm"], cfg.rms_eps)
        k = rms_norm(k, layer["attn_k_norm"], cfg.rms_eps)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.qk_norm_head and layer.get("attn_q_norm") is not None:
        # per-head norms before RoPE: LayerNorm (chameleon) or RMS (openelm)
        if cfg.qk_norm_rms:
            q = rms_norm(q, layer["attn_q_norm"], cfg.rms_eps)
            k = rms_norm(k, layer["attn_k_norm"], cfg.rms_eps)
        else:
            q = layer_norm(q, layer["attn_q_norm"], layer.get("attn_q_norm_b"), cfg.rms_eps)
            k = layer_norm(k, layer["attn_k_norm"], layer.get("attn_k_norm_b"), cfg.rms_eps)
    if cfg.rope_dim:  # learned positions (gpt2) and ALiBi archs have no RoPE
        q = apply_rope(q, positions, inv_freq, cfg.rope_type, mscale)
        k = apply_rope(k, positions, inv_freq, cfg.rope_type, mscale)
    k_cache, v_cache = kv
    scale = cfg.attn_scale or 1.0 / np.sqrt(hd)
    if opts.sp_group is not None:
        # this shard holds global cells [offset, offset + t_loc): the write
        # drops the rows outside it and the mask is the shard's columns
        # (prima_tpu/models/llama.py:929-961)
        if cfg.attn_logit_softcap or cfg.alibi_max_bias:
            raise NotImplementedError("sequence parallelism with softcap/ALiBi attention")
        t_loc = kv_seq_len(k_cache)
        offset = opts.sp_group.index * t_loc
        update_kv_sp(k_cache, k, cache_pos, offset)
        update_kv_sp(v_cache, v, cache_pos, offset)
        mp = positions if mask_pos is None else mask_pos
        out = gqa_attention_sp(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                               causal_mask(mp - offset, t_loc), scale, opts.sp_group)
    else:
        update_kv_pair(k_cache, v_cache, k, v, cache_pos)
        if _flash_route(cfg, opts):
            # the caches as they are stored: the decode kernel reads a
            # quantized cache's codes, with no dense copy
            mp = positions if mask_pos is None else mask_pos
            out = flash_attention(q, k_cache, v_cache, mp.to(torch.int32), scale)
        else:
            slopes = (alibi_slopes(h, cfg.alibi_max_bias) if cfg.alibi_max_bias else None)
            out = gqa_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask, scale,
                                cfg.attn_logit_softcap, slopes)
    out = out.reshape(b, s, h * hd)
    if cfg.sub_norms and layer.get("attn_sub_norm") is not None:
        out = rms_norm(out, layer["attn_sub_norm"], cfg.rms_eps)  # bitnet, before wo
    _tap(taps, tap_prefix + "attn_output.weight", out)
    out = _scaled(linear_l(layer, "wo", out, opts.matmul_impl), layer, "wo_scale")
    return _biased(_tp_sum(out, opts), layer, "bo")  # the bias once, after the sum


def mla_attention(layer: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                  kv: tuple, cache_pos: torch.Tensor, mask: torch.Tensor, inv_freq: torch.Tensor,
                  mscale: float, kq_scale: float, opts: ForwardOptions) -> torch.Tensor:
    """deepseek2's multi-head latent attention (build_deepseek2) over x
    (b, s, e) normed. kv is the layer's latent cache as two views of one
    (b, T, kv_lora_rank + rope_dim) tensor: the roped keys (b, T, 1,
    rope_dim) and the normed latents (b, T, 1, kv_lora_rank); this step's
    cells are written at cache_pos in place. The absorbed form: each head's
    query dims without RoPE go through the key half of attn_kv_b into the
    latent space (`mla_k_b`), its scores are that against every cached
    latent plus its RoPE query against the shared RoPE key, times
    `kq_scale`, under `mask`; the softmax weighs the latents, and the value
    half of attn_kv_b (`mla_v_b`) takes the weighted latent to the head's
    values before attn_output. Scores and softmax in f32. Decode and prefill
    run the same form, so no cell is decompressed."""
    b, s, _ = x.shape
    h, nope, rope, r = cfg.n_heads, cfg.qk_nope, cfg.rope_dim, cfg.kv_lora_rank
    impl = opts.matmul_impl
    if layer.get("attn_q_a") is not None:  # DeepSeek-V2: queries through a LoRA bottleneck
        qa = rms_norm(linear(x, layer["attn_q_a"], impl), layer["attn_q_a_norm"], cfg.rms_eps)
        q = linear(qa, layer["attn_q_b"], impl)
    else:
        q = linear(x, layer["attn_q"], impl)
    q_nope, q_pe = q.reshape(b, s, h, nope + rope).split([nope, rope], dim=-1)
    c, k_pe = linear(x, layer["attn_kv_a_mqa"], impl).split([r, rope], dim=-1)
    c = rms_norm(c, layer["attn_kv_a_norm"], cfg.rms_eps)
    q_pe = apply_rope(q_pe, positions, inv_freq, cfg.rope_type, mscale)
    k_pe = apply_rope(k_pe[:, :, None], positions, inv_freq, cfg.rope_type, mscale)
    pe_cache, c_cache = kv
    kv_write_plain(pe_cache, k_pe, cache_pos)
    kv_write_plain(c_cache, c[:, :, None], cache_pos)
    lat, pe = c_cache[:, :, 0], pe_cache[:, :, 0]  # (b, T, r), (b, T, rope)
    q_lat = torch.einsum("bshd,hdr->bshr", q_nope, layer["mla_k_b"].to(q_nope.dtype))
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), lat.float())
              + torch.einsum("bshd,btd->bhst", q_pe.float(), pe.float()))
    probs = torch.softmax(scores * kq_scale + mask, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", probs.to(lat.dtype), lat)
    out = torch.einsum("bshr,hvr->bshv", o_lat, layer["mla_v_b"].to(o_lat.dtype))
    return linear(out.reshape(b, s, h * cfg.v_head_dim).to(x.dtype), layer["attn_output"], impl)


def _tap(taps: dict | None, name: str, x: torch.Tensor) -> None:
    """Add the per-column f32 sum of x^2 over every leading axis, and the
    row count, to taps[name]: the statistics imatrix.cpp:171-196 collects
    per mul_mat input (prima_tpu/models/llama.py:992-1002). The sum stays
    on x's device and the count is a Python int from the shape, so a
    tapped forward makes no host synchronization."""
    if taps is None:
        return
    ssq = x.float().square().sum(dim=tuple(range(x.ndim - 1)))
    cnt = math.prod(x.shape[:-1])
    prev = taps.get(name)
    if prev is not None:
        ssq, cnt = ssq + prev[0], cnt + prev[1]
    taps[name] = (ssq, cnt)


def ffn_block(layer: dict, x: torch.Tensor, opts: ForwardOptions, act_fn: str = "silu",
              gated: bool = True, eps: float = 1e-5, taps: dict | None = None,
              tap_prefix: str = "") -> torch.Tensor:
    """The dense FFN: gated (SwiGLU / GeGLU / squared ReLU), chatglm's
    [gate | up] split of one projection, or a plain up -> act -> down MLP;
    with the biases, bitnet scales and sub-norm a layer carries. taps
    collects the projections' inputs; a fused gate/up layer returns before
    the ffn_down tap, as the JAX package's does (llama.py:1013-1020)."""
    if gated:
        _tap(taps, tap_prefix + "ffn_gate.weight", x)
    _tap(taps, tap_prefix + "ffn_up.weight", x)
    if gated and layer.get("w_gateup") is not None:
        gate, up = linear(x, layer["w_gateup"], opts.matmul_impl).chunk(2, dim=-1)
        out = linear_l(layer, "w_down", gated_act(gate, up, act_fn), opts.matmul_impl)
        return _biased(_tp_sum(out, opts), layer, "b_down")
    up = _biased(_scaled(linear_l(layer, "w_up", x, opts.matmul_impl), layer, "w_up_scale"),
                 layer, "b_up")
    if gated:
        gate = _biased(_scaled(linear_l(layer, "w_gate", x, opts.matmul_impl), layer,
                               "w_gate_scale"), layer, "b_gate")
        act = gated_act(gate, up, act_fn)
    elif act_fn == "swiglu_split":  # chatglm: ffn_up holds [gate | up]
        gate, up = up.chunk(2, dim=-1)
        act = gated_act(gate, up, "silu")
    else:  # starcoder2 and kin: act(up), ggml's tanh GELU
        act = gated_act(up, torch.ones((), dtype=up.dtype, device=up.device), act_fn)
    if layer.get("ffn_sub_norm") is not None:
        act = rms_norm(act, layer["ffn_sub_norm"], eps)  # bitnet, before ffn_down
    _tap(taps, tap_prefix + "ffn_down.weight", act)
    out = _scaled(linear_l(layer, "w_down", act, opts.matmul_impl), layer, "w_down_scale")
    return _biased(_tp_sum(out, opts), layer, "b_down")


def expert_rows(w, e: int, n_expert: int):
    """Expert e of stacked expert weights: a QTensor view of its row range,
    or the (N, K) slice of a dense (E, N, K) tensor."""
    if not isinstance(w, QTensor):
        return w[e]
    n = w.n_rows // n_expert
    return w.rows(e * n, (e + 1) * n)


def expert_linear(x: torch.Tensor, w, ids: torch.Tensor, n_expert: int,
                  impl: str = "kernel", per_expert: int | None = None) -> torch.Tensor:
    """Row p of x (P, K) through expert ids[p] of stacked weights -> (P, N)
    in x's dtype: quantized experts through the expert-indexed GEMV (its
    plain version for impl "plain"; `per_expert` bounds the pairs of one
    expert), dense ones as a gathered product."""
    if isinstance(w, QTensor):
        n = w.n_rows // n_expert
        if impl == "plain":
            return qgemv_indexed_plain(x, w, ids, n, per_expert)
        if impl != "kernel":
            raise ValueError(f"unknown matmul_impl {impl!r}")
        return qmatmul_indexed(x, w, ids, n, per_expert)
    return torch.einsum("pk,pnk->pn", x.float(), w[ids.long()].float()).to(x.dtype)


def moe_combine(y: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Each row's k expert outputs y (R, k, E) under its f32 routing
    weights w (R, k) -> (R, E) in `dtype`, summed in the JAX package's
    order: top-k order for one row (prima_tpu/models/llama.py:1080-1086),
    ascending expert id for more (:1088-1094), sorted on the device. From
    zeros, each pair costs one cast of its weight, one multiply and one add
    in `dtype`. The reference also adds 0 * y for every expert a row did
    not pick: a signed zero, which leaves the bits of a finite sum alone."""
    if ids.shape[0] > 1:
        ids, order = torch.sort(ids, dim=-1)
        w = torch.gather(w, 1, order)
        y = torch.gather(y, 1, order[..., None].expand_as(y))
    out = torch.zeros((y.shape[0], y.shape[-1]), dtype=dtype, device=y.device)
    for j in range(ids.shape[1]):
        out = out + w[:, j:j + 1].to(dtype) * y[:, j]
    return out


def moe_ffn(layer: dict, cfg: ModelConfig, x: torch.Tensor,
            opts: ForwardOptions) -> torch.Tensor:
    """Mixture-of-experts FFN (prima_tpu/models/llama.py:1058-1108). The
    router runs in f32: softmax, top-k, normalized top-k weights unless
    moe_norm_w is off (qwen2moe, olmoe, deepseek2), times deepseek2's
    expert_weights_scale. Fewer than MAX_B (row, expert) pairs go through
    the expert-indexed GEMV, one launch a projection that finds the experts
    among the ids on the device and reads each chosen one once, summed in
    the reference's order (`moe_combine`). One token a row (a decode step)
    with more pairs takes the same GEMV over the pairs sorted by expert on
    the device, a launch a projection for each MAX_B of them
    (`_experts_chunked`). Wider prefill inputs loop over every expert in
    index order with zero weight for the rows that did not pick it, as the
    JAX package does. Then the shared experts: qwen2moe's under a sigmoid
    gate, deepseek2's as they are.

    The routed work is the span moe.experts (its pairs and launches); the
    counters moe.calls, moe.dense_loops (the calls that took the all-expert
    loop, prefill chunks alone), moe.indexed_launches and moe.pairs count
    it, from the shapes alone."""
    b, s, e = x.shape
    k_used, n_exp = cfg.n_expert_used, cfg.n_expert
    probs = torch.softmax(linear(x, layer["ffn_gate_inp"], opts.matmul_impl).float(), -1)
    w, ids = torch.topk(probs, k_used, dim=-1)  # (b, s, k), descending
    if cfg.moe_norm_w:
        w = w / w.sum(-1, keepdim=True)
    if cfg.expert_weights_scale != 1.0:
        w = w * float(np.float32(cfg.expert_weights_scale))
    stacked = (layer["ffn_gate_exps"], layer["ffn_up_exps"], layer["ffn_down_exps"])
    rows = b * s
    pairs = rows * k_used
    count("moe.calls")
    count("moe.pairs", pairs)
    with span("moe.experts") as sp:
        if pairs < MAX_B:
            xp = x.reshape(rows, e).repeat_interleave(k_used, dim=0)  # pair p: row p // k
            idp = ids.reshape(-1).to(torch.int32)
            # a row's k experts are distinct: one expert holds at most `rows` pairs
            gate, up = (expert_linear(xp, t, idp, n_exp, opts.matmul_impl, rows)
                        for t in stacked[:2])
            y = expert_linear(gated_act(gate, up, cfg.act), stacked[2], idp, n_exp,
                              opts.matmul_impl, rows).reshape(rows, k_used, e)
            out = moe_combine(y, w.reshape(rows, k_used), ids.reshape(rows, k_used),
                              x.dtype).reshape(b, s, e)
            launches = 3
        elif s == 1:
            out, launches = _experts_chunked(x.reshape(rows, e), w.reshape(rows, k_used),
                                             ids.reshape(rows, k_used), stacked, cfg, opts)
            out = out.reshape(b, s, e)
        else:
            count("moe.dense_loops")
            per_expert = torch.where(
                ids[..., None, :] == torch.arange(n_exp, device=x.device)[:, None],
                w[..., None, :], 0.0).sum(-1)  # (b, s, n_expert)
            out = torch.zeros_like(x)
            mm = _expert_matmuls(stacked, n_exp, x, opts)
            for ei in range(n_exp):
                gate, up = mm(0, ei, x), mm(1, ei, x)
                y = mm(2, ei, gated_act(gate, up, cfg.act))
                out = out + per_expert[..., ei:ei + 1].to(x.dtype) * y
            launches = 0
        count("moe.indexed_launches", launches)
        if sp:
            sp.set(pairs=pairs, launches=launches)
    if layer.get("ffn_gate_shexp") is not None:
        g = None
        if layer.get("ffn_gate_inp_shexp") is not None:
            # qwen2moe's shared expert: a dense FFN under a per-token sigmoid gate
            g = torch.sigmoid(linear(x, layer["ffn_gate_inp_shexp"], opts.matmul_impl).float())
        sh_gate, sh_up = (linear(x, layer[n], opts.matmul_impl)
                          for n in ("ffn_gate_shexp", "ffn_up_shexp"))
        sh = linear(gated_act(sh_gate, sh_up, cfg.act), layer["ffn_down_shexp"],
                    opts.matmul_impl)
        out = out + (sh if g is None else sh * g.to(x.dtype))
    return _tp_sum(out, opts)


MOE_DEQUANT_WEIGHTS = 1 << 27  # weights a slice of the dense loop's dequantization


def _expert_matmuls(stacked: tuple, n_exp: int, x: torch.Tensor, opts: ForwardOptions):
    """mm(j, e, a): input a through expert e of stacked weight j, as
    `linear` over `expert_rows` computes it. Where that is a dequantization
    and one matmul (qmatmul at MAX_B rows or more, or the plain matmul),
    each stacked QTensor is dequantized once for all its experts, in slices
    of MOE_DEQUANT_WEIGHTS: the same elements and the same matmul on each
    expert's rows, with one set of dequantizing ops a slice in place of
    one an expert."""
    rows = x.numel() // x.shape[-1]
    if not ((opts.matmul_impl == "plain" or rows >= MAX_B)
            and all(isinstance(t, QTensor) for t in stacked)):
        return lambda j, e, a: linear(a, expert_rows(stacked[j], e, n_exp), opts.matmul_impl)
    with dequant_slices(MOE_DEQUANT_WEIGHTS):
        mats = [dequant(t, x.dtype) for t in stacked]

    def mm(j: int, e: int, a: torch.Tensor) -> torch.Tensor:
        n = mats[j].shape[0] // n_exp
        return torch.matmul(a, mats[j][e * n:(e + 1) * n].t())
    return mm


def _experts_chunked(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor, stacked: tuple,
                     cfg: ModelConfig, opts: ForwardOptions) -> tuple[torch.Tensor, int]:
    """The routed experts of one token a row, x (R, E), through the
    expert-indexed GEMV where the (row, expert) pairs are MAX_B or more:
    the pairs sorted by expert on the device (so an expert's pairs lie in
    one chunk, or two at a boundary), then each projection launched on
    consecutive chunks of at most MAX_B pairs, an expert's pairs in a chunk
    bounded by the rows and the chunk; the outputs put back in pair order
    and summed as `moe_combine` sums them. Nothing is read on the host.
    Returns (out (R, E) in x's dtype, the launches)."""
    rows, k = ids.shape
    idp = ids.reshape(-1)
    order = torch.argsort(idp, stable=True)
    sid = idp[order].to(torch.int32)
    chunks = [(c0, min(c0 + MAX_B, rows * k)) for c0 in range(0, rows * k, MAX_B)]

    def project(a: torch.Tensor, t) -> torch.Tensor:
        # f32 rows in, so no launch casts them; the outputs rounded to x's
        # dtype once, as expert_linear rounds each launch's
        return torch.cat([expert_linear(a[c0:c1], t, sid[c0:c1], cfg.n_expert,
                                        opts.matmul_impl, min(rows, c1 - c0))
                          for c0, c1 in chunks]).to(x.dtype)

    xp = x[order // k].float()
    act = gated_act(project(xp, stacked[0]), project(xp, stacked[1]), cfg.act)
    down = project(act.float(), stacked[2])
    y = torch.empty_like(down).index_copy_(0, order, down)
    return moe_combine(y.reshape(rows, k, -1), w, ids, x.dtype), 3 * len(chunks)


def _experts(layer: dict, cfg: ModelConfig, x: torch.Tensor,
             opts: ForwardOptions) -> torch.Tensor:
    """moe_ffn, looked up on this module at each call (a wrapper set there
    sees every call); while a decode graph is captured on this thread, a
    boundary that calls it eagerly on every replay."""
    c = _capturing()
    return moe_ffn(layer, cfg, x, opts) if c is None else c.experts(layer, cfg, x, opts)


def decode_layer(layer: dict, cfg: ModelConfig, x: torch.Tensor, positions, kv,
                 cache_pos, mask, inv_freq, mscale, opts: ForwardOptions,
                 mask_pos=None, heads: tuple[int, int] | None = None,
                 taps: dict | None = None, tap_prefix: str = "", index: int = 0,
                 kq_scale: float | None = None):
    """One block (prima_tpu/models/llama.py:1111-1193): pre- or swin
    (post-) norms, sequential or parallel attention and FFN, post norms,
    the residual scale, the dense FFN or the experts (arctic: both), and
    last the layer's control vector. taps reach the attention and the
    dense FFN, never moe_ffn: as in the JAX package, no expert, router or
    shared-expert input is tapped. The attention and the FFN are the spans
    fwd.attn and fwd.ffn (fwd.moe with experts) of layer `index`."""
    cvec = layer.get("cvec")
    # the experts take the FFN's place (arctic: beside it); parallel blocks
    # keep the dense FFN
    experts = bool(not cfg.parallel_block and cfg.n_expert
                   and layer.get("ffn_gate_inp") is not None)
    with _span("fwd.attn") as sp:
        if sp:
            sp.set(layer=index)
            if cfg.kv_lora_rank:
                sp.set(kind="mla")
        attn_in = x if cfg.swin_norm else _norm(layer, cfg, x, "attn_norm")
        attn_out = attention_block(layer, cfg, attn_in, positions, kv, cache_pos, mask,
                                   inv_freq, mscale, opts, mask_pos, heads, taps, tap_prefix,
                                   kq_scale)
    with _span("fwd.moe" if experts else "fwd.ffn") as sp:
        if sp:
            sp.set(layer=index)
        out = _layer_ffn(layer, cfg, x, attn_in, attn_out, opts, taps, tap_prefix, experts)
        return out if cvec is None else out + cvec.to(out.dtype)


def _norm(layer: dict, cfg: ModelConfig, v: torch.Tensor, key: str) -> torch.Tensor:
    return model_norm(v, layer.get(key), layer.get(key + "_b"), cfg)


def _layer_ffn(layer: dict, cfg: ModelConfig, x, attn_in, attn_out, opts, taps, tap_prefix,
               experts: bool):
    """decode_layer after the attention, with its experts or its dense
    FFN: the layer's output before its control vector."""
    norm = lambda v, key: _norm(layer, cfg, v, key)
    dense_ffn = lambda v: ffn_block(layer, v, opts, cfg.act, cfg.ffn_gated, cfg.rms_eps,
                                    taps, tap_prefix)
    if cfg.parallel_block:
        # command-r / phi2: the FFN shares the attention's normed input;
        # gptneox-style blocks norm the layer input with their own ffn_norm
        ffn_in = attn_in if layer.get("ffn_norm") is None else norm(x, "ffn_norm")
        return x + attn_out + dense_ffn(ffn_in)
    if cfg.post_norms and layer.get("attn_post_norm") is not None:
        attn_out = rms_norm(attn_out, layer["attn_post_norm"], cfg.rms_eps)
    if cfg.swin_norm:  # chameleon: the same attn_norm weights, after the branch
        attn_out = norm(attn_out, "attn_norm")
    if cfg.residual_scale != 1.0:  # minicpm / granite
        attn_out = attn_out * float(np.float32(cfg.residual_scale))
    if cfg.moe_parallel_dense and experts:
        # arctic: the dense FFN off the post-attention residual, the experts
        # off the layer input (ffn_norm_exps), summed
        ffn_inp = x + attn_out
        dense = ffn_block(layer, rms_norm(ffn_inp, layer["ffn_norm"], cfg.rms_eps), opts,
                          cfg.act, True, cfg.rms_eps, taps, tap_prefix)
        moe = _experts(layer, cfg, rms_norm(x, layer["ffn_norm_exps"], cfg.rms_eps), opts)
        return moe + dense + ffn_inp
    x = x + attn_out
    ffn_in = x if cfg.swin_norm else norm(x, "ffn_norm")
    if experts:
        ffn_out = _experts(layer, cfg, ffn_in, opts)
    else:
        ffn_out = dense_ffn(ffn_in)
    if cfg.post_norms and layer.get("ffn_post_norm") is not None:
        ffn_out = rms_norm(ffn_out, layer["ffn_post_norm"], cfg.rms_eps)
    if cfg.swin_norm:
        ffn_out = norm(ffn_out, "ffn_norm")
    if cfg.residual_scale != 1.0:
        ffn_out = ffn_out * float(np.float32(cfg.residual_scale))
    return x + ffn_out


def layer_heads(cfg: ModelConfig, i: int) -> tuple[int, int]:
    """Layer i's (query heads, KV heads): per layer for openelm."""
    return ((cfg.n_heads_arr[i] if cfg.n_heads_arr else cfg.n_heads),
            (cfg.n_kv_heads_arr[i] if cfg.n_kv_heads_arr else cfg.n_kv_heads))


def _embed_in(params: dict, cfg: ModelConfig, tokens, positions, dtype) -> torch.Tensor:
    """The token embedding and what follows it up to the first layer."""
    x = embed(params["tok_embd"], tokens, dtype)
    if cfg.embd_scale != 1.0:  # gemma: sqrt(n_embd)
        x = x * float(np.float32(cfg.embd_scale))
    if params.get("pos_embd") is not None:  # gpt2 / starcoder: learned positions
        x = x + params["pos_embd"][positions.long()].to(x.dtype)
    if params.get("tok_embd_norm") is not None:  # bloom
        x = layer_norm(x, params["tok_embd_norm"], params.get("tok_embd_norm_b"),
                       cfg.rms_eps)
    return x


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor | None,
            positions: torch.Tensor, kv_caches: list, cache_pos: torch.Tensor,
            opts: ForwardOptions = ForwardOptions(), return_hidden: bool = False,
            mask_positions: torch.Tensor | None = None,
            layer_range: tuple[int, int] | None = None,
            hidden_in: torch.Tensor | None = None,
            attn_mask: torch.Tensor | None = None, taps: dict | None = None,
            inputs_embeds: torch.Tensor | None = None):
    """tokens / positions (b, s) int, kv_caches per layer (k, v) of
    (b, T, n_kv, hd), cache_pos (b,) int32 write index on the device.
    Returns (logits (b, s, V), kv_caches) — the caches are updated in place
    — or the pre-norm hidden states with return_hidden=True.

    attn_mask (b, 1, s, T) f32, additive, replaces the causal (or ALiBi)
    mask: non-causal visibility such as the lookahead decoder's token tree
    or a bidirectional encoder (prima_tpu/models/llama.py:1246-1255). The
    flash kernels derive visibility from positions alone, so a mask forces
    the plain attention whatever opts.attn_impl says; on an ALiBi model the
    slopes scale the caller's mask as they scale alibi_mask. The step's
    rows land at cache_pos + i whatever their positions.

    layer_range=(lo, hi) runs layers [lo, hi) only, the building block of
    the ring's windows (prima_tpu/models/llama.py:1196-1238): it takes
    hidden_in instead of the embedding when lo > 0 and returns the hidden
    states when hi < n_layers. Only the layers in range (and their caches)
    need to be present; the others may be None.

    taps, a dict, collects for every matmul input the forward passes a
    name -> (per-column f32 sum of x^2 on the device, row count) pair
    (`_tap`), accumulated over the calls that share the dict: the hook of
    imatrix, eval_callback and cvector_generator
    (prima_tpu/models/llama.py:1207-1286). "output.weight" is tapped only
    where the forward reaches the head.

    inputs_embeds (b, s, e) replaces the token embedding and everything
    after it up to the first layer (gemma's scale, learned positions,
    bloom's embedding norm): the multimodal path, where image patch
    embeddings are spliced into the sequence
    (prima_tpu/models/llama.py:1209,1222-1223)."""
    lo, hi = layer_range or (0, cfg.n_layers)
    if lo == 0 and inputs_embeds is not None:
        x = inputs_embeds.to(opts.dtype)
    elif lo == 0:
        with _span("fwd.embed"):
            x = _embed_in(params, cfg, tokens, positions, opts.dtype)
    else:
        if hidden_in is None:
            raise ValueError(f"a window starting at layer {lo} needs hidden_in")
        x = hidden_in
    inv_freq, mscale = rope_freqs(cfg, x.device)
    kq_scale = mla_rope_params(cfg)[2] if cfg.kv_lora_rank else None
    t_cache = kv_caches[lo][0].shape[1] if hi > lo else 0
    mpos = positions if mask_positions is None else mask_positions
    if attn_mask is not None and opts.attn_impl == "kernel":
        opts = replace(opts, attn_impl="plain")
    mask = mask_swa = None
    if not _flash_route(cfg, opts):  # the flash kernels derive visibility themselves
        if attn_mask is not None:
            mask = attn_mask
        else:
            mask = (alibi_mask(mpos, t_cache) if cfg.alibi_max_bias  # bloom / mpt
                    else causal_mask(mpos, t_cache))
        if cfg.swa_window:  # gemma2: a sliding window on even layers
            mask_swa = causal_mask(mpos, t_cache, swa_window=cfg.swa_window)
    for i in range(lo, hi):
        layer = params["layers"][i]
        if layer is None:
            raise ValueError(f"layer {i} is not loaded here")
        m = mask_swa if mask_swa is not None and i % 2 == 0 else mask
        heads = layer_heads(cfg, i) if cfg.n_heads_arr else None
        x = decode_layer(layer, cfg, x, positions, kv_caches[i], cache_pos, m, inv_freq,
                         mscale, opts, mask_positions, heads, taps, f"blk.{i}.", index=i,
                         kq_scale=kq_scale)
    if return_hidden or hi < cfg.n_layers:
        return x, kv_caches
    with _span("fwd.head"):
        return lm_head(params, cfg, x, opts, taps), kv_caches


def lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor,
            opts: ForwardOptions = ForwardOptions(), taps: dict | None = None) -> torch.Tensor:
    """The final norm and the output head over hidden states (b, s, e):
    logits (b, s, V) in opts.logits_dtype. taps collects the head's input
    as "output.weight", tied embeddings or not."""
    x = model_norm(x, params.get("output_norm"), params.get("output_norm_b"), cfg)
    if cfg.logit_scale != 1.0:  # minicpm / command-r / granite / grok
        x = x * float(np.float32(cfg.logit_scale))
    _tap(taps, "output.weight", x)
    w_out = params["output"] if params.get("output") is not None else params["tok_embd"]
    logits = linear(x, w_out, opts.matmul_impl).to(opts.logits_dtype)
    if params.get("output_b") is not None:  # phi2
        logits = logits + params["output_b"].to(logits.dtype)
    if cfg.final_logit_softcap:  # gemma2
        cap = float(np.float32(cfg.final_logit_softcap))
        logits = cap * torch.tanh(logits / cap)
    return logits


def init_kv_caches(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16, device=None,
                   layer_filter: Callable[[int], bool] | None = None) -> list:
    """Per-layer (k, v) zero buffers (batch, max_seq, kvh, head_dim), kvh
    the layer's own KV heads: dense tensors of a torch dtype, or KVQ8 /
    KVQ4 for "q8_0" / "q4_0". A layer for which layer_filter is False gets
    None (a ring rank caches only its own windows). Latent attention
    (deepseek2) caches a latent instead (`_init_latent_caches`)."""
    if cfg.kv_lora_rank:
        return _init_latent_caches(cfg, batch, max_seq, dtype, device, layer_filter)
    if isinstance(dtype, str):
        cls = {"q8_0": KVQ8, "q4_0": KVQ4}.get(dtype)
        if cls is None:
            raise ValueError(f"unknown KV cache type {dtype!r}")
        make = lambda shape: cls.zeros(shape, device)
    else:
        make = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    caches = []
    for i in range(cfg.n_layers):
        if layer_filter is not None and not layer_filter(i):
            caches.append(None)
            continue
        shape = (batch, max_seq, layer_heads(cfg, i)[1], cfg.head_dim)
        caches.append((make(shape), make(shape)))
    return caches


def _init_latent_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype, device,
                        layer_filter) -> list:
    """Latent attention's caches: per layer one (batch, max_seq,
    kv_lora_rank + rope_dim) buffer of the normed latent and the roped key
    of each cell, handed out as the pair (roped keys (batch, max_seq, 1,
    rope_dim), latents (batch, max_seq, 1, kv_lora_rank)) of views: the
    cache's sequence ops (runtime/kv.py) then re-rotate the keys alone and
    move the latents as they are."""
    if isinstance(dtype, str):
        raise NotImplementedError(f"a {dtype} cache for latent attention ({cfg.arch}): "
                                  "its latent cache is dense (f32 or bf16)")
    r = cfg.kv_lora_rank
    caches = []
    for i in range(cfg.n_layers):
        if layer_filter is not None and not layer_filter(i):
            caches.append(None)
            continue
        buf = torch.zeros((batch, max_seq, r + cfg.rope_dim), dtype=dtype, device=device)
        caches.append((buf[:, :, None, r:], buf[:, :, None, :r]))
    return caches
