"""Pure-numpy reference forward pass (tests only).

An independent implementation of the same architecture used to cross-check
the forward — the analogue of the reference's CPU-vs-backend comparison
harness (tests/test-backend-ops.cpp pattern).
"""

from __future__ import annotations

import numpy as np

from ..models.config import ModelConfig, RopeType


def rms_norm(x, w, eps):
    var = np.mean(x.astype(np.float64) ** 2, axis=-1, keepdims=True)
    return (x / np.sqrt(var + eps) * w).astype(np.float32)


def layer_norm(x, w, b, eps):
    xf = x.astype(np.float64)
    mean = xf.mean(axis=-1, keepdims=True)
    var = ((xf - mean) ** 2).mean(axis=-1, keepdims=True)
    y = (xf - mean) / np.sqrt(var + eps)
    if w is not None:
        y = y * w
    if b is not None:
        y = y + b
    return y.astype(np.float32)


def rope(x, positions, base, rope_dim, rope_type):
    # x: (b, s, h, hd)
    half = rope_dim // 2
    inv_freq = 1.0 / (base ** (np.arange(half, dtype=np.float64) * 2.0 / rope_dim))
    theta = positions[..., None] * inv_freq  # (b, s, half)
    cos = np.cos(theta)[:, :, None, :]
    sin = np.sin(theta)[:, :, None, :]
    y = x.astype(np.float64).copy()
    if rope_type == RopeType.NORM:
        x0 = x[..., 0:rope_dim:2]
        x1 = x[..., 1:rope_dim:2]
        y[..., 0:rope_dim:2] = x0 * cos - x1 * sin
        y[..., 1:rope_dim:2] = x0 * sin + x1 * cos
    else:
        x0 = x[..., :half]
        x1 = x[..., half:rope_dim]
        y[..., :half] = x0 * cos - x1 * sin
        y[..., half:rope_dim] = x0 * sin + x1 * cos
    return y.astype(np.float32)


def _alibi_slopes_np(n_heads: int, max_bias: float) -> np.ndarray:
    import math

    n_log2 = 1 << int(math.floor(math.log2(n_heads)))
    m0 = 2.0 ** (-max_bias / n_log2)
    m1 = 2.0 ** (-max_bias / 2.0 / n_log2)
    hidx = np.arange(n_heads)
    return np.where(hidx < n_log2, m0 ** (hidx + 1),
                    m1 ** (2 * (hidx - n_log2) + 1))


def forward_np(weights: dict, cfg: ModelConfig, tokens: np.ndarray) -> np.ndarray:
    """weights: dict of dense f32 arrays keyed by GGUF tensor names.
    tokens: (b, s). Returns logits (b, s, vocab). Full-sequence prefill.

    Covers the decoder families the JAX forward supports: rope/ALiBi,
    LN/RMS norms (with biases), fused qkv, parallel blocks, per-head q/k
    norms, swin (post) norm placement, gated/plain/split-gate FFNs."""
    b, s = tokens.shape
    hd = cfg.head_dim
    x = weights["token_embd.weight"][tokens]  # (b, s, e)
    if cfg.embd_scale != 1.0:
        x = x * np.float32(cfg.embd_scale)
    positions = np.broadcast_to(np.arange(s, dtype=np.float64), (b, s))
    rscale = np.float32(cfg.residual_scale)
    scale = cfg.attn_scale or 1.0 / np.sqrt(hd)

    def norm(v, wkey):
        if cfg.norm_type == "ln":
            return layer_norm(v, weights.get(wkey), weights.get(
                wkey.replace(".weight", ".bias")), cfg.rms_eps)
        return rms_norm(v, weights[wkey], cfg.rms_eps)

    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        h = cfg.n_heads_arr[i] if cfg.n_heads_arr else cfg.n_heads
        kvh = cfg.n_kv_heads_arr[i] if cfg.n_kv_heads_arr else cfg.n_kv_heads
        slopes = (_alibi_slopes_np(h, cfg.alibi_max_bias)
                  if cfg.alibi_max_bias else None)
        xin = x if cfg.swin_norm else norm(x, p + "attn_norm.weight")
        if (p + "attn_qkv.weight") in weights:
            qkv = xin @ weights[p + "attn_qkv.weight"].T
            if (p + "attn_qkv.bias") in weights:
                qkv = qkv + weights[p + "attn_qkv.bias"]
            nq, nk = h * hd, kvh * hd
            q, k, v = qkv[..., :nq], qkv[..., nq:nq + nk], qkv[..., nq + nk:]
        else:
            q = xin @ weights[p + "attn_q.weight"].T
            k = xin @ weights[p + "attn_k.weight"].T
            v = xin @ weights[p + "attn_v.weight"].T
            if (p + "attn_q.scale") in weights:  # bitnet per-tensor scales
                q = q * weights[p + "attn_q.scale"]
                k = k * weights[p + "attn_k.scale"]
                v = v * weights[p + "attn_v.scale"]
            if cfg.qkv_bias:
                q = q + weights[p + "attn_q.bias"]
                k = k + weights[p + "attn_k.bias"]
                v = v + weights[p + "attn_v.bias"]
        q = q.reshape(b, s, h, hd)
        k = k.reshape(b, s, kvh, hd)
        v = v.reshape(b, s, kvh, hd)
        if cfg.qk_norm_head and (p + "attn_q_norm.weight") in weights:
            if cfg.qk_norm_rms:  # openelm per-head RMS
                q = rms_norm(q, weights[p + "attn_q_norm.weight"], cfg.rms_eps)
                k = rms_norm(k, weights[p + "attn_k_norm.weight"], cfg.rms_eps)
            else:
                q = layer_norm(q, weights[p + "attn_q_norm.weight"],
                               weights.get(p + "attn_q_norm.bias"), cfg.rms_eps)
                k = layer_norm(k, weights[p + "attn_k_norm.weight"],
                               weights.get(p + "attn_k_norm.bias"), cfg.rms_eps)
        if cfg.rope_dim:
            q = rope(q, positions, cfg.rope_base, cfg.rope_dim, cfg.rope_type)
            k = rope(k, positions, cfg.rope_base, cfg.rope_dim, cfg.rope_type)
        group = h // kvh
        qg = q.reshape(b, s, kvh, group, hd)
        scores = np.einsum("bsngh,btnh->bngst", qg, k) * scale
        if cfg.attn_logit_softcap:
            cap = cfg.attn_logit_softcap
            scores = cap * np.tanh(scores / cap)
        if slopes is not None:
            dist = -np.abs(np.arange(s)[:, None] - np.arange(s)[None, :])
            bias = slopes.reshape(kvh, group, 1, 1) * dist[None, None]
            scores = scores + bias[None]
        mask = np.triu(np.full((s, s), -np.inf), 1)
        scores = scores + mask
        scores = scores - scores.max(axis=-1, keepdims=True)
        probs = np.exp(scores)
        probs /= probs.sum(axis=-1, keepdims=True)
        attn = np.einsum("bngst,btnh->bsngh", probs, v).reshape(b, s, h * hd)
        if cfg.sub_norms and (p + "attn_sub_norm.weight") in weights:
            attn = rms_norm(attn, weights[p + "attn_sub_norm.weight"],
                            cfg.rms_eps)
        attn_out = attn @ weights[p + "attn_output.weight"].T
        if (p + "attn_output.scale") in weights:  # bitnet
            attn_out = attn_out * weights[p + "attn_output.scale"]
        if (p + "attn_output.bias") in weights:
            attn_out = attn_out + weights[p + "attn_output.bias"]
        if cfg.swin_norm:
            attn_out = norm(attn_out, p + "attn_norm.weight")
        if cfg.post_norms and (p + "attn_out_norm.weight") in weights:
            attn_out = rms_norm(attn_out, weights[p + "attn_out_norm.weight"],
                                cfg.rms_eps)

        if cfg.moe_parallel_dense and (p + "ffn_gate_inp.weight") in weights:
            # arctic: dense FFN + parallel MoE off the layer input
            ffn_inp = x + attn_out
            dense = _ffn_np(weights, p, cfg,
                            rms_norm(ffn_inp, weights[p + "ffn_norm.weight"],
                                     cfg.rms_eps))
            moe = _moe_np(weights, p, cfg,
                          rms_norm(x, weights[p + "ffn_norm_exps.weight"],
                                   cfg.rms_eps))
            x = moe + dense + ffn_inp
            continue
        if (p + "ffn_gate_inp.weight") in weights:
            # MoE layer (mixtral/grok)
            x = x + rscale * attn_out
            fin = norm(x, p + "ffn_norm.weight")
            moe = _moe_np(weights, p, cfg, fin)
            if cfg.post_norms and (p + "layer_out_norm.weight") in weights:
                moe = rms_norm(moe, weights[p + "layer_out_norm.weight"],
                               cfg.rms_eps)
            x = x + rscale * moe
            continue

        if cfg.parallel_block:
            # plamo/command-r: ffn off the shared attention norm (or its
            # own ffn_norm when present), residual added once
            fin = (norm(x, p + "ffn_norm.weight")
                   if (p + "ffn_norm.weight") in weights else xin)
            ffn_out = _ffn_np(weights, p, cfg, fin)
            x = x + rscale * attn_out + rscale * ffn_out
            continue

        x = x + rscale * attn_out
        fin = x if cfg.swin_norm else norm(x, p + "ffn_norm.weight")
        ffn_out = _ffn_np(weights, p, cfg, fin)
        if cfg.swin_norm:
            ffn_out = norm(ffn_out, p + "ffn_norm.weight")
        x = x + rscale * ffn_out

    x = norm(x, "output_norm.weight")
    if cfg.logit_scale != 1.0:
        x = x * np.float32(cfg.logit_scale)
    w_out = weights.get("output.weight", weights["token_embd.weight"])
    return x @ w_out.T


def _moe_np(weights: dict, p: str, cfg: ModelConfig, fin: np.ndarray):
    """Dense-loop MoE reference (llm_build_moe_ffn semantics)."""
    b, s, e = fin.shape
    router = fin @ weights[p + "ffn_gate_inp.weight"].T  # (b,s,E)
    rl = router.astype(np.float64)
    rl -= rl.max(-1, keepdims=True)
    probs = np.exp(rl)
    probs /= probs.sum(-1, keepdims=True)
    k_used = cfg.n_expert_used
    idx = np.argsort(-probs, axis=-1)[..., :k_used]
    w = np.take_along_axis(probs, idx, axis=-1)
    if cfg.moe_norm_w:
        w = w / w.sum(-1, keepdims=True)
    gate_e = weights[p + "ffn_gate_exps.weight"].reshape(cfg.n_expert, -1, e)
    up_e = weights[p + "ffn_up_exps.weight"].reshape(cfg.n_expert, -1, e)
    down_e = weights[p + "ffn_down_exps.weight"].reshape(cfg.n_expert, e, -1)
    out = np.zeros((b, s, e))
    for bi in range(b):
        for si in range(s):
            v = fin[bi, si].astype(np.float64)
            for j in range(k_used):
                ei = idx[bi, si, j]
                g = gate_e[ei] @ v
                u = up_e[ei] @ v
                a = (_gelu_tanh(g) if cfg.act == "gelu"
                     else g / (1.0 + np.exp(-g))) * u
                out[bi, si] += w[bi, si, j] * (down_e[ei] @ a)
    return out.astype(np.float32)


def _gelu_tanh(v):
    return 0.5 * v * (1.0 + np.tanh(
        np.sqrt(2.0 / np.pi) * (v + 0.044715 * v ** 3)))


def _ffn_np(weights: dict, p: str, cfg: ModelConfig, fin: np.ndarray):
    up = fin @ weights[p + "ffn_up.weight"].T
    if (p + "ffn_up.scale") in weights:  # bitnet
        up = up * weights[p + "ffn_up.scale"]
    if (p + "ffn_up.bias") in weights:
        up = up + weights[p + "ffn_up.bias"]
    if cfg.ffn_gated and (p + "ffn_gate.weight") in weights:
        gate = fin @ weights[p + "ffn_gate.weight"].T
        if (p + "ffn_gate.scale") in weights:  # bitnet
            gate = gate * weights[p + "ffn_gate.scale"]
        if (p + "ffn_gate.bias") in weights:
            gate = gate + weights[p + "ffn_gate.bias"]
        gf = gate.astype(np.float64)
        act = (_gelu_tanh(gf) if cfg.act == "gelu"
               else gf / (1.0 + np.exp(-gf))) * up
    elif cfg.act == "swiglu_split":
        nf = up.shape[-1] // 2
        a = up[..., :nf].astype(np.float64)
        act = a / (1.0 + np.exp(-a)) * up[..., nf:]
    else:
        uf = up.astype(np.float64)
        act = _gelu_tanh(uf) if cfg.act == "gelu" else np.maximum(uf, 0)
    act = act.astype(np.float32)
    if cfg.sub_norms and (p + "ffn_sub_norm.weight") in weights:  # bitnet
        act = rms_norm(act, weights[p + "ffn_sub_norm.weight"], cfg.rms_eps)
    out = act @ weights[p + "ffn_down.weight"].T
    if (p + "ffn_down.scale") in weights:  # bitnet
        out = out * weights[p + "ffn_down.scale"]
    if (p + "ffn_down.bias") in weights:
        out = out + weights[p + "ffn_down.bias"]
    return out
