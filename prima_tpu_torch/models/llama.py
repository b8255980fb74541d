"""The decoder of every arch in the config table: GGUF weight loading and
the forward pass.

Counterpart of prima_tpu/models/llama.py on a single device. Parameters are
a dict of tensors and QTensors on one device; KV caches are tensors (or
KVQ8 / KVQ4) written in place (the JAX forward returns updated copies
instead). Attention takes the plain `gqa_attention` or, with
attn_impl="kernel", the flash kernels (not for softcap, sliding-window or
ALiBi attention, which they do not compute). Mixture-of-experts layers run
their experts through the expert-indexed GEMV at decode. Control vectors
and LoRA adapters are not ported yet: a layer that carries one raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ..gguf.constants import GGMLType, TYPE_TRAITS
from ..gguf.reader import GGUFModel, TensorInfo
from ..ops.attention import flash_attention
from ..ops.kvquant import KVQ4, KVQ8, update_kv_pair
from ..ops.layers import (alibi_mask, alibi_slopes, apply_rope, causal_mask, gated_act,
                          gqa_attention, layer_norm, rms_norm, rope_freqs)
from ..quant.dequant_np import dequantize_tensor
from ..quant.device_format import SUPPORTED_TYPES, UQTensor, to_device_format
from ..quant.qmatmul import MAX_B, qgemv_indexed_plain, qmatmul, qmatmul_indexed
from ..quant.qtensor import QTensor, dequant_rows, qmatmul_plain
from .config import ModelConfig

# ---------------------------------------------------------------------------
# Linear dispatch
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w, impl: str = "kernel") -> torch.Tensor:
    """x (..., K) @ W(rows, K)^T -> (..., rows). impl "kernel" streams
    quantized weights through the GEMV kernel; "plain" dequantizes and
    multiplies in PyTorch (the counterpart of --matmul xla)."""
    if isinstance(w, QTensor):
        if impl == "plain":
            return qmatmul_plain(x, w)
        if impl != "kernel":
            raise ValueError(f"unknown matmul_impl {impl!r}")
        return qmatmul(x, w)
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


def embed(tok_embd, token_ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Row gather + dequant of the embedding table."""
    if isinstance(tok_embd, QTensor):
        return dequant_rows(tok_embd, token_ids, dtype)
    return tok_embd[token_ids].to(dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _to_device_tensor(ti: TensorInfo, dtype, device, dense: bool = False):
    """GGUF tensor -> QTensor (quantized) or dense tensor in `dtype`."""
    t = ti.ggml_type
    if TYPE_TRAITS[t].is_quantized and not dense and t in SUPPORTED_TYPES:
        return QTensor.from_host(to_device_format(ti.data, t, ti.ne[0]), device)
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
    return QTensor.from_host(to_device_format(raw, t0, k), device)


def _split_tensor_rows(ti: TensorInfo, dtype, device, bounds: Sequence[int]) -> list:
    """A GGUF tensor cut along output rows at `bounds` (fused qkv or
    gate+up): quant blocks slice cleanly by row."""
    t, k = ti.ggml_type, ti.ne[0]
    if TYPE_TRAITS[t].is_quantized and t in SUPPORTED_TYPES:
        raw = np.asarray(ti.data).reshape(ti.n_elements // k, -1)
        return [QTensor.from_host(to_device_format(np.ascontiguousarray(raw[r0:r1]), t, k),
                                  device) for r0, r1 in zip(bounds[:-1], bounds[1:])]
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
                fuse: bool = False) -> dict:
    """Params dict from a GGUF model: the tensor tables of every arch the
    decoder serves (prima_tpu/models/llama.py:163-365). fuse=True
    concatenates Q/K/V and gate/up into wqkv / w_gateup where their quant
    types match and no bias, scale or sub-norm sits between them: fewer
    GEMV launches, identical numerics."""
    t = m.tensors

    def get(name, dense=False, required=True):
        ti = t.get(name)
        if ti is None:
            if required:
                raise KeyError(f"missing tensor {name}")
            return None
        return _to_device_tensor(ti, dtype, device, dense)

    def first(*names):
        """The first of `names` the file holds, dense, or None."""
        return next((get(n, dense=True) for n in names if n in t), None)

    def add_optional(dst: dict, table, prefix: str = "") -> None:
        for name, key in table:
            if prefix + name in t:
                dst[key] = get(prefix + name, dense=True)

    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ln = cfg.norm_type != "rms"
    params: dict[str, Any] = {"tok_embd": get("token_embd.weight"), "layers": []}
    add_optional(params, (("position_embd.weight", "pos_embd"),
                          ("token_embd_norm.weight", "tok_embd_norm"),
                          ("token_embd_norm.bias", "tok_embd_norm_b")))
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
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
            add_optional(layer, (("attn_norm_2.bias", "ffn_norm_b"),), p)
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
            if (p + "ffn_gate_inp_shexp.weight") in t:  # qwen2moe's shared expert
                layer["ffn_gate_inp_shexp"] = get(p + "ffn_gate_inp_shexp.weight", dense=True)
                for key in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"):
                    layer[key] = get(p + key + ".weight")
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
        add_optional(layer, _OPTIONAL, p)
        params["layers"].append(layer)
    params["output_norm"] = get("output_norm.weight", dense=True, required=not ln)
    add_optional(params, (("output_norm.bias", "output_norm_b"), ("output.bias", "output_b")))
    params["output"] = None if cfg.tie_embeddings else get("output.weight")
    return params


def params_from_numpy(tree, device):
    """The JAX package's params after jax.device_get -> the port's params.

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
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


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
    e, h, kvh, hd, f = cfg.n_embd, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_ff

    def q(rows, k):
        return synth_qtensor_device(gen, rows, k, ggml_type, device)

    ones = lambda: torch.ones(e, dtype=torch.float32, device=device)
    params: dict[str, Any] = {"tok_embd": q(cfg.n_vocab, e), "layers": [],
                              "output_norm": ones()}
    params["output"] = None if cfg.tie_embeddings else q(cfg.n_vocab, e)
    for _ in range(cfg.n_layers):
        layer = {"attn_norm": ones(), "wq": q(h * hd, e), "wk": q(kvh * hd, e),
                 "wv": q(kvh * hd, e), "wo": q(e, h * hd), "ffn_norm": ones(),
                 "w_gate": q(f, e), "w_up": q(f, e), "w_down": q(e, f)}
        if cfg.qkv_bias:
            for name, n in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd)):
                layer[name] = torch.randn(n, generator=gen, device=device) * 0.02
        params["layers"].append(layer)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ForwardOptions:
    matmul_impl: str = "kernel"  # "plain" = dequantize + torch.matmul
    attn_impl: str = "plain"  # "kernel" = the flash attention kernels
    dtype: torch.dtype = torch.bfloat16
    logits_dtype: torch.dtype = torch.float32


def _check_layer(layer: dict) -> None:
    """Control vectors and LoRA adapters wait for the adapters slice: a
    layer that carries one raises instead of being ignored."""
    if layer.get("cvec") is not None:
        raise NotImplementedError("control vectors (cvec) are not ported yet")
    lora = [k for k in layer if k.endswith("_lora")]
    if lora:
        raise NotImplementedError(f"LoRA adapters ({', '.join(lora)}) are not ported yet")


def _flash_route(cfg: ModelConfig, opts: ForwardOptions) -> bool:
    """attn_impl "kernel" takes the flash kernels, except for the attention
    variants they do not compute (as llama.py:962-963 of the JAX package)."""
    if opts.attn_impl not in ("plain", "kernel"):
        raise ValueError(f"unknown attn_impl {opts.attn_impl!r}")
    return (opts.attn_impl == "kernel" and not cfg.attn_logit_softcap
            and not cfg.swa_window and not cfg.alibi_max_bias)


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
                    heads: tuple[int, int] | None = None) -> torch.Tensor:
    """x (b, s, e) normed input. Writes this step's K/V into the caches in
    place and returns the attention output (b, s, e). Visibility follows
    mask_pos (the physical cache order) where given, else positions; the
    two differ only under Self-Extend. heads is a layer's own (h, kvh)
    (openelm)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h, kvh = heads if heads is not None else (cfg.n_heads, cfg.n_kv_heads)
    if layer.get("wqkv") is not None:
        qkv = linear(x, layer["wqkv"], opts.matmul_impl)
        q, k, v = qkv.split([h * hd, kvh * hd, kvh * hd], dim=-1)
    else:
        q, k, v = (linear(x, layer[n], opts.matmul_impl) for n in ("wq", "wk", "wv"))
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
    update_kv_pair(k_cache, v_cache, k, v, cache_pos)
    scale = cfg.attn_scale or 1.0 / np.sqrt(hd)
    if _flash_route(cfg, opts):
        # the caches as they are stored: the decode kernel reads a quantized
        # cache's codes, with no dense copy
        mp = positions if mask_pos is None else mask_pos
        out = flash_attention(q, k_cache, v_cache, mp.to(torch.int32), scale)
    else:
        slopes = (alibi_slopes(h, cfg.alibi_max_bias) if cfg.alibi_max_bias else None)
        out = gqa_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask, scale,
                            cfg.attn_logit_softcap, slopes)
    out = out.reshape(b, s, h * hd)
    if cfg.sub_norms and layer.get("attn_sub_norm") is not None:
        out = rms_norm(out, layer["attn_sub_norm"], cfg.rms_eps)  # bitnet, before wo
    out = _scaled(linear(out, layer["wo"], opts.matmul_impl), layer, "wo_scale")
    return _biased(out, layer, "bo")


def ffn_block(layer: dict, x: torch.Tensor, opts: ForwardOptions, act_fn: str = "silu",
              gated: bool = True, eps: float = 1e-5) -> torch.Tensor:
    """The dense FFN: gated (SwiGLU / GeGLU / squared ReLU), chatglm's
    [gate | up] split of one projection, or a plain up -> act -> down MLP;
    with the biases, bitnet scales and sub-norm a layer carries."""
    if gated and layer.get("w_gateup") is not None:
        gate, up = linear(x, layer["w_gateup"], opts.matmul_impl).chunk(2, dim=-1)
        out = linear(gated_act(gate, up, act_fn), layer["w_down"], opts.matmul_impl)
        return _biased(out, layer, "b_down")
    up = _biased(_scaled(linear(x, layer["w_up"], opts.matmul_impl), layer, "w_up_scale"),
                 layer, "b_up")
    if gated:
        gate = _biased(_scaled(linear(x, layer["w_gate"], opts.matmul_impl), layer,
                               "w_gate_scale"), layer, "b_gate")
        act = gated_act(gate, up, act_fn)
    elif act_fn == "swiglu_split":  # chatglm: ffn_up holds [gate | up]
        gate, up = up.chunk(2, dim=-1)
        act = gated_act(gate, up, "silu")
    else:  # starcoder2 and kin: act(up), ggml's tanh GELU
        act = gated_act(up, torch.ones((), dtype=up.dtype, device=up.device), act_fn)
    if layer.get("ffn_sub_norm") is not None:
        act = rms_norm(act, layer["ffn_sub_norm"], eps)  # bitnet, before ffn_down
    out = _scaled(linear(act, layer["w_down"], opts.matmul_impl), layer, "w_down_scale")
    return _biased(out, layer, "b_down")


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
    moe_norm_w is off (qwen2moe, olmoe). Fewer than MAX_B (row, expert)
    pairs go through the expert-indexed GEMV, one launch a projection that
    finds the experts among the ids on the device and reads each chosen
    one once, summed in the reference's order (`moe_combine`); wider
    inputs loop over every expert in index order with zero weight for the
    rows that did not pick it, as the JAX package does."""
    b, s, e = x.shape
    k_used, n_exp = cfg.n_expert_used, cfg.n_expert
    probs = torch.softmax(linear(x, layer["ffn_gate_inp"], opts.matmul_impl).float(), -1)
    w, ids = torch.topk(probs, k_used, dim=-1)  # (b, s, k), descending
    if cfg.moe_norm_w:
        w = w / w.sum(-1, keepdim=True)
    stacked = (layer["ffn_gate_exps"], layer["ffn_up_exps"], layer["ffn_down_exps"])
    rows = b * s
    if rows * k_used < MAX_B:
        xp = x.reshape(rows, e).repeat_interleave(k_used, dim=0)  # pair p: row p // k
        idp = ids.reshape(-1).to(torch.int32)
        # a row's k experts are distinct: one expert holds at most `rows` pairs
        gate, up = (expert_linear(xp, t, idp, n_exp, opts.matmul_impl, rows)
                    for t in stacked[:2])
        y = expert_linear(gated_act(gate, up, cfg.act), stacked[2], idp, n_exp,
                          opts.matmul_impl, rows).reshape(rows, k_used, e)
        out = moe_combine(y, w.reshape(rows, k_used), ids.reshape(rows, k_used),
                          x.dtype).reshape(b, s, e)
    else:
        per_expert = torch.where(
            ids[..., None, :] == torch.arange(n_exp, device=x.device)[:, None],
            w[..., None, :], 0.0).sum(-1)  # (b, s, n_expert)
        out = torch.zeros_like(x)
        for ei in range(n_exp):
            ge, ue, de = (expert_rows(t, ei, n_exp) for t in stacked)
            gate, up = (linear(x, t, opts.matmul_impl) for t in (ge, ue))
            y = linear(gated_act(gate, up, cfg.act), de, opts.matmul_impl)
            out = out + per_expert[..., ei:ei + 1].to(x.dtype) * y
    if layer.get("ffn_gate_inp_shexp") is not None:
        # qwen2moe's shared expert: a dense FFN under a per-token sigmoid gate
        g = torch.sigmoid(linear(x, layer["ffn_gate_inp_shexp"], opts.matmul_impl).float())
        sh_gate, sh_up = (linear(x, layer[n], opts.matmul_impl)
                          for n in ("ffn_gate_shexp", "ffn_up_shexp"))
        sh = linear(gated_act(sh_gate, sh_up, cfg.act), layer["ffn_down_shexp"],
                    opts.matmul_impl)
        out = out + sh * g.to(x.dtype)
    return out


def decode_layer(layer: dict, cfg: ModelConfig, x: torch.Tensor, positions, kv,
                 cache_pos, mask, inv_freq, mscale, opts: ForwardOptions,
                 mask_pos=None, heads: tuple[int, int] | None = None):
    """One block (prima_tpu/models/llama.py:1111-1193): pre- or swin
    (post-) norms, sequential or parallel attention and FFN, post norms,
    the residual scale, the dense FFN or the experts (arctic: both)."""
    _check_layer(layer)
    norm = lambda v, key: model_norm(v, layer.get(key), layer.get(key + "_b"), cfg)
    attn_in = x if cfg.swin_norm else norm(x, "attn_norm")
    attn_out = attention_block(layer, cfg, attn_in, positions, kv, cache_pos, mask,
                               inv_freq, mscale, opts, mask_pos, heads)
    dense_ffn = lambda v: ffn_block(layer, v, opts, cfg.act, cfg.ffn_gated, cfg.rms_eps)
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
    if cfg.moe_parallel_dense and layer.get("ffn_gate_inp") is not None:
        # arctic: the dense FFN off the post-attention residual, the experts
        # off the layer input (ffn_norm_exps), summed
        ffn_inp = x + attn_out
        dense = ffn_block(layer, rms_norm(ffn_inp, layer["ffn_norm"], cfg.rms_eps), opts,
                          cfg.act, True, cfg.rms_eps)
        moe = moe_ffn(layer, cfg, rms_norm(x, layer["ffn_norm_exps"], cfg.rms_eps), opts)
        return moe + dense + ffn_inp
    x = x + attn_out
    ffn_in = x if cfg.swin_norm else norm(x, "ffn_norm")
    if cfg.n_expert and layer.get("ffn_gate_inp") is not None:
        ffn_out = moe_ffn(layer, cfg, ffn_in, opts)
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


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv_caches: list, cache_pos: torch.Tensor,
            opts: ForwardOptions = ForwardOptions(), return_hidden: bool = False,
            mask_positions: torch.Tensor | None = None):
    """tokens / positions (b, s) int, kv_caches per layer (k, v) of
    (b, T, n_kv, hd), cache_pos (b,) int32 write index on the device.
    Returns (logits (b, s, V), kv_caches) — the caches are updated in place
    — or the pre-norm hidden states with return_hidden=True."""
    x = embed(params["tok_embd"], tokens, opts.dtype)
    if cfg.embd_scale != 1.0:  # gemma: sqrt(n_embd)
        x = x * float(np.float32(cfg.embd_scale))
    if params.get("pos_embd") is not None:  # gpt2 / starcoder: learned positions
        x = x + params["pos_embd"][positions.long()].to(x.dtype)
    if params.get("tok_embd_norm") is not None:  # bloom
        x = layer_norm(x, params["tok_embd_norm"], params.get("tok_embd_norm_b"),
                       cfg.rms_eps)
    inv_freq, mscale = rope_freqs(cfg, x.device)
    t_cache = kv_caches[0][0].shape[1]
    mpos = positions if mask_positions is None else mask_positions
    mask = mask_swa = None
    if not _flash_route(cfg, opts):  # the flash kernels derive visibility themselves
        mask = (alibi_mask(mpos, t_cache) if cfg.alibi_max_bias  # bloom / mpt
                else causal_mask(mpos, t_cache))
        if cfg.swa_window:  # gemma2: a sliding window on even layers
            mask_swa = causal_mask(mpos, t_cache, swa_window=cfg.swa_window)
    for i, (layer, kv) in enumerate(zip(params["layers"], kv_caches)):
        m = mask_swa if mask_swa is not None and i % 2 == 0 else mask
        heads = layer_heads(cfg, i) if cfg.n_heads_arr else None
        x = decode_layer(layer, cfg, x, positions, kv, cache_pos, m, inv_freq, mscale,
                         opts, mask_positions, heads)
    if return_hidden:
        return x, kv_caches
    x = model_norm(x, params.get("output_norm"), params.get("output_norm_b"), cfg)
    if cfg.logit_scale != 1.0:  # minicpm / command-r / granite / grok
        x = x * float(np.float32(cfg.logit_scale))
    w_out = params["output"] if params.get("output") is not None else params["tok_embd"]
    logits = linear(x, w_out, opts.matmul_impl).to(opts.logits_dtype)
    if params.get("output_b") is not None:  # phi2
        logits = logits + params["output_b"].to(logits.dtype)
    if cfg.final_logit_softcap:  # gemma2
        cap = float(np.float32(cfg.final_logit_softcap))
        logits = cap * torch.tanh(logits / cap)
    return logits, kv_caches


def init_kv_caches(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16, device=None) -> list:
    """Per-layer (k, v) zero buffers (batch, max_seq, kvh, head_dim), kvh
    the layer's own KV heads: dense tensors of a torch dtype, or KVQ8 /
    KVQ4 for "q8_0" / "q4_0"."""
    if isinstance(dtype, str):
        cls = {"q8_0": KVQ8, "q4_0": KVQ4}.get(dtype)
        if cls is None:
            raise ValueError(f"unknown KV cache type {dtype!r}")
        make = lambda shape: cls.zeros(shape, device)
    else:
        make = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    caches = []
    for i in range(cfg.n_layers):
        shape = (batch, max_seq, layer_heads(cfg, i)[1], cfg.head_dim)
        caches.append((make(shape), make(shape)))
    return caches
