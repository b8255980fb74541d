"""Llama / Qwen2 decoder: GGUF weight loading and the forward pass.

Counterpart of prima_tpu/models/llama.py. Parameters are a dict of tensors
and QTensors on one device; KV caches are tensors (or KVQ8 / KVQ4) written
in place (the JAX forward returns updated copies instead). Attention takes
the plain `gqa_attention` or, with attn_impl="kernel", the flash kernels.
This slice ports the dense llama / qwen2 path: arch flags of other
families raise NotImplementedError instead of being ignored.
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
from ..ops.layers import (apply_rope, causal_mask, gated_act, gqa_attention,
                          rms_norm, rope_freqs)
from ..quant.dequant_np import dequantize_tensor
from ..quant.device_format import SUPPORTED_TYPES, UQTensor, to_device_format
from ..quant.qmatmul import qmatmul
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


def load_params(m: GGUFModel, cfg: ModelConfig, device, dtype=torch.bfloat16,
                fuse: bool = False) -> dict:
    """Params dict from a GGUF model (the llama / qwen2 tensor tables).
    fuse=True concatenates Q/K/V and gate/up into wqkv / w_gateup where
    their quant types match: fewer GEMV launches, identical numerics."""
    _check_arch(cfg)
    t = m.tensors

    def get(name, dense=False, required=True):
        ti = t.get(name)
        if ti is None:
            if required:
                raise KeyError(f"missing tensor {name}")
            return None
        return _to_device_tensor(ti, dtype, device, dense)

    params: dict[str, Any] = {"tok_embd": get("token_embd.weight"), "layers": []}
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer = {
            "attn_norm": get(p + "attn_norm.weight", dense=True),
            "wo": get(p + "attn_output.weight"),
            "ffn_norm": get(p + "ffn_norm.weight", dense=True),
            "w_down": get(p + "ffn_down.weight"),
        }
        qkv = [t[p + n] for n in ("attn_q.weight", "attn_k.weight", "attn_v.weight")]
        fused = _fuse_tensor_rows(qkv, device) if fuse else None
        if fused is not None:
            layer["wqkv"] = fused
        else:
            layer["wq"], layer["wk"], layer["wv"] = (
                _to_device_tensor(ti, dtype, device) for ti in qkv)
        gu = [t[p + "ffn_gate.weight"], t[p + "ffn_up.weight"]]
        fused = _fuse_tensor_rows(gu, device) if fuse else None
        if fused is not None:
            layer["w_gateup"] = fused
        else:
            layer["w_gate"], layer["w_up"] = (
                _to_device_tensor(ti, dtype, device) for ti in gu)
        if cfg.qkv_bias or (p + "attn_q.bias") in t:
            layer["bq"] = get(p + "attn_q.bias", dense=True)
            layer["bk"] = get(p + "attn_k.bias", dense=True)
            layer["bv"] = get(p + "attn_v.bias", dense=True)
        params["layers"].append(layer)
    params["output_norm"] = get("output_norm.weight", dense=True)
    params["output"] = None if cfg.tie_embeddings else get("output.weight")
    return params


def params_from_numpy(tree, device):
    """The JAX package's params after jax.device_get -> the port's params.

    Each JAX QTensor comes as a plain dict of its numpy fields and metadata
    (qs, scales, mins, d, dmin, sub, layout, q_offset, shape, kperm, gsub,
    packed); dense arrays come as numpy arrays. The sigma column order
    (kperm) and the sigma-ordered packed codes are undone, then the tensor
    is repacked in the port's natural layout."""
    if isinstance(tree, dict) and "qs" in tree and "layout" in tree:
        return QTensor.from_host(_natural_uq(tree), device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


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
                         t: GGMLType = GGMLType.Q4_K, device=None) -> QTensor:
    """Random QTensor generated on the device from `gen` (no host copy),
    with the byte layout of real weights of the same format."""
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
        return QTensor(qs, scales, mins, sub, layout, off, (rows, k))
    g = s // gsub
    # bases rounded to f16 values, like real GGUF d / dmin
    d = (torch.randn((rows, g), generator=gen, device=device).abs()
         * (0.02 / qmax / 32) + 1e-6).half().float()
    dmin = ((torch.randn((rows, g), generator=gen, device=device).abs()
             * (0.01 / qmax / 32)).half().float() if has_mins else None)
    codes = ri(1, 64, (rows, s), torch.int8)
    mcodes = ri(0, 64, (rows, s), torch.int8) if has_mins else None
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


_UNPORTED = (  # ModelConfig flags whose forward branches are not ported yet
    ("n_expert", "mixture-of-experts FFN"), ("alibi_max_bias", "ALiBi"),
    ("attn_logit_softcap", "attention softcap"),
    ("final_logit_softcap", "final logit softcap"),
    ("swa_window", "sliding-window attention"), ("post_norms", "post norms"),
    ("sub_norms", "sub norms"), ("parallel_block", "parallel block"),
    ("clamp_kqv", "q/k/v clamping"), ("qk_norm_head", "q/k norms"),
    ("swin_norm", "swin norm"), ("moe_parallel_dense", "parallel MoE"),
    ("pos_embd", "learned positions"), ("tok_embd_norm", "embedding norm"),
    ("n_heads_arr", "per-layer head counts"),
)


def _check_arch(cfg: ModelConfig) -> None:
    for flag, what in _UNPORTED:
        if getattr(cfg, flag):
            raise NotImplementedError(f"{what} ({cfg.arch}) is not ported yet")
    if cfg.norm_type != "rms" or not cfg.ffn_gated or not cfg.rope_dim:
        raise NotImplementedError(f"the {cfg.arch} block layout is not ported yet")
    if (cfg.embd_scale, cfg.logit_scale, cfg.residual_scale) != (1.0, 1.0, 1.0):
        raise NotImplementedError(f"{cfg.arch} scale factors are not ported yet")


def _flash_route(cfg: ModelConfig, opts: ForwardOptions) -> bool:
    """attn_impl "kernel" takes the flash kernels, except for the attention
    variants they do not compute (as llama.py:962-963 of the JAX package)."""
    if opts.attn_impl not in ("plain", "kernel"):
        raise ValueError(f"unknown attn_impl {opts.attn_impl!r}")
    return (opts.attn_impl == "kernel" and not cfg.attn_logit_softcap
            and not cfg.swa_window and not cfg.alibi_max_bias)


def attention_block(layer: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, kv: tuple, cache_pos: torch.Tensor,
                    mask: torch.Tensor | None, inv_freq: torch.Tensor, mscale: float,
                    opts: ForwardOptions,
                    mask_pos: torch.Tensor | None = None) -> torch.Tensor:
    """x (b, s, e) normed input. Writes this step's K/V into the caches in
    place and returns the attention output (b, s, e). Visibility follows
    mask_pos (the physical cache order) where given, else positions; the
    two differ only under Self-Extend."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if layer.get("wqkv") is not None:
        qkv = linear(x, layer["wqkv"], opts.matmul_impl)
        q, k, v = qkv.split([h * hd, kvh * hd, kvh * hd], dim=-1)
    else:
        q, k, v = (linear(x, layer[n], opts.matmul_impl) for n in ("wq", "wk", "wv"))
    if layer.get("bq") is not None:
        q = q + layer["bq"].to(q.dtype)
        k = k + layer["bk"].to(k.dtype)
        v = v + layer["bv"].to(v.dtype)
    q = apply_rope(q.reshape(b, s, h, hd), positions, inv_freq, cfg.rope_type, mscale)
    k = apply_rope(k.reshape(b, s, kvh, hd), positions, inv_freq, cfg.rope_type, mscale)
    v = v.reshape(b, s, kvh, hd)
    k_cache, v_cache = kv
    update_kv_pair(k_cache, v_cache, k, v, cache_pos)
    scale = cfg.attn_scale or 1.0 / np.sqrt(hd)
    if _flash_route(cfg, opts):
        # the caches as they are stored: the decode kernel reads a quantized
        # cache's codes, with no dense copy
        mp = positions if mask_pos is None else mask_pos
        out = flash_attention(q, k_cache, v_cache, mp.to(torch.int32), scale)
    else:
        out = gqa_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask, scale)
    return linear(out.reshape(b, s, h * hd), layer["wo"], opts.matmul_impl)


def ffn_block(layer: dict, x: torch.Tensor, opts: ForwardOptions,
              act_fn: str = "silu") -> torch.Tensor:
    if layer.get("w_gateup") is not None:
        gate, up = linear(x, layer["w_gateup"], opts.matmul_impl).chunk(2, dim=-1)
    else:
        gate = linear(x, layer["w_gate"], opts.matmul_impl)
        up = linear(x, layer["w_up"], opts.matmul_impl)
    return linear(gated_act(gate, up, act_fn), layer["w_down"], opts.matmul_impl)


def decode_layer(layer: dict, cfg: ModelConfig, x: torch.Tensor, positions, kv,
                 cache_pos, mask, inv_freq, mscale, opts: ForwardOptions,
                 mask_pos=None):
    attn_in = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    x = x + attention_block(layer, cfg, attn_in, positions, kv, cache_pos, mask,
                            inv_freq, mscale, opts, mask_pos)
    ffn_in = rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
    return x + ffn_block(layer, ffn_in, opts, cfg.act)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv_caches: list, cache_pos: torch.Tensor,
            opts: ForwardOptions = ForwardOptions(), return_hidden: bool = False,
            mask_positions: torch.Tensor | None = None):
    """tokens / positions (b, s) int, kv_caches per layer (k, v) of
    (b, T, n_kv, hd), cache_pos (b,) int32 write index on the device.
    Returns (logits (b, s, V), kv_caches) — the caches are updated in place
    — or the pre-norm hidden states with return_hidden=True."""
    _check_arch(cfg)
    x = embed(params["tok_embd"], tokens, opts.dtype)
    inv_freq, mscale = rope_freqs(cfg, x.device)
    t_cache = kv_caches[0][0].shape[1]
    # the flash kernels derive visibility from the positions themselves
    mask = None if _flash_route(cfg, opts) else causal_mask(
        positions if mask_positions is None else mask_positions, t_cache)
    for layer, kv in zip(params["layers"], kv_caches):
        x = decode_layer(layer, cfg, x, positions, kv, cache_pos, mask, inv_freq,
                         mscale, opts, mask_positions)
    if return_hidden:
        return x, kv_caches
    x = rms_norm(x, params["output_norm"], cfg.rms_eps)
    w_out = params["output"] if params.get("output") is not None else params["tok_embd"]
    return linear(x, w_out, opts.matmul_impl).to(opts.logits_dtype), kv_caches


def init_kv_caches(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16, device=None) -> list:
    """Per-layer (k, v) zero buffers (batch, max_seq, n_kv, head_dim): dense
    tensors of a torch dtype, or KVQ8 / KVQ4 for "q8_0" / "q4_0"."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    if isinstance(dtype, str):
        cls = {"q8_0": KVQ8, "q4_0": KVQ4}.get(dtype)
        if cls is None:
            raise ValueError(f"unknown KV cache type {dtype!r}")
        return [(cls.zeros(shape, device), cls.zeros(shape, device))
                for _ in range(cfg.n_layers)]
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]
