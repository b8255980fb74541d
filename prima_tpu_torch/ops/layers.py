"""Core transformer ops: RMS/LayerNorm, RoPE (norm/neox, YaRN), attention
(softcap, ALiBi, sliding window), SwiGLU.

Counterpart of prima_tpu/ops/layers.py in plain PyTorch. Semantics follow
the reference kernels (ggml_rope_ext, ggml_rms_norm, ggml_soft_max_ext);
every reduction and rotation runs in f32 and casts back to the input dtype
as the JAX functions do.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..models.config import ModelConfig, RopeType


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32 (ggml_rms_norm + ggml_mul)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None,
               eps: float) -> torch.Tensor:
    """LayerNorm in f32 (ggml_norm + optional mul/add). weight / bias None
    is the non-parametric form (OLMo)."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _yarn_ramp(low: float, high: float, dims: torch.Tensor) -> torch.Tensor:
    y = (dims - low) / max(high - low, 1e-3)
    return 1.0 - torch.clamp(y, 0.0, 1.0)


def _yarn_corr_dim(n_dims: int, n_ctx_orig: int, n_rot: float, base: float) -> float:
    return n_dims * math.log(n_ctx_orig / (n_rot * 2 * math.pi)) / (2 * math.log(base))


def _yarn_ramp_np(low: float, high: float, dims: np.ndarray) -> np.ndarray:
    y = (dims - low) / max(high - low, 1e-3)
    return 1.0 - np.clip(y, 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def yarn_params(d: int, qk: int, base: float, scaling: str, factor: float,
                attn_factor: float, log_mul: float, orig_ctx: int, beta_fast: float,
                beta_slow: float) -> tuple[np.ndarray, float, float]:
    """(inv_freq over the d rope dims, rope magnitude scale, kq_scale) for
    query / key heads of qk dims, computed on the host in the same f32
    numpy expressions as the JAX package, so the frequencies agree to the
    last bit before they reach the device. Cached: callers must not write
    into the array.

    YaRN mirrors build_deepseek2 (src/llama.cpp:15456-15460): the attention
    scale is pre-multiplied by mscale^2 (mscale uses the GGUF
    yarn_log_multiplier) and rope runs with attn_factor_scaled =
    1/(1 + 0.1*ln(1/freq_scale)), which cancels ggml rope_yarn's own
    (1 + 0.1*ln(1/freq_scale)) magnitude factor.
    """
    half = d // 2
    inv = 1.0 / (base ** (np.arange(half, dtype=np.float32) * 2.0 / d))
    if scaling != "yarn" or factor <= 0:
        return inv, 1.0, 1.0 / math.sqrt(qk)
    freq_scale = 1.0 / factor
    mscale = attn_factor * (1.0 + log_mul * math.log(1.0 / freq_scale))
    kq_scale = mscale * mscale / math.sqrt(qk)
    attn_factor_scaled = attn_factor / (1.0 + 0.1 * math.log(1.0 / freq_scale))
    orig = orig_ctx or 4096
    low = max(0.0, math.floor(_yarn_corr_dim(d, orig, beta_fast, base)))
    high = min(d / 2.0 - 1.0, math.ceil(_yarn_corr_dim(d, orig, beta_slow, base)))
    ramp = _yarn_ramp_np(low, high, np.arange(half, dtype=np.float32))
    inv_yarn = inv * freq_scale * (1.0 - ramp) + inv * ramp
    # net rope magnitude: ggml rope_yarn multiplies the passed attn_factor
    # by (1 + 0.1*ln(1/freq_scale)) when ext_factor != 0
    rope_mscale = attn_factor_scaled * (1.0 + 0.1 * math.log(1.0 / freq_scale))
    return inv_yarn.astype(np.float32), float(rope_mscale), float(kq_scale)


def mla_rope_params(cfg: ModelConfig) -> tuple[np.ndarray, float, float]:
    """`yarn_params` of a decoder config of latent attention (deepseek2):
    the constants models/deepseek2.py's runtime takes for the same GGUF."""
    s = cfg.rope_scaling
    return yarn_params(cfg.rope_dim, cfg.head_dim, cfg.rope_base, s.kind, s.factor,
                       s.attn_factor, cfg.yarn_log_mul, s.orig_ctx, s.beta_fast, s.beta_slow)


_rope_cache: dict = {}  # (RoPE parameters, device) -> (inv_freq, mscale)


def rope_freqs(cfg: ModelConfig, device=None) -> tuple[torch.Tensor, float]:
    """Per-pair inverse frequencies (rope_dim // 2,) f32 and the YaRN mscale.
    Built on `device` once per set of RoPE parameters and device, and the
    same tensor on every later call (callers must not write into it): a
    forward makes no device tensor and no host-to-device copy for it, so a
    decode step can be captured as a CUDA graph."""
    s = cfg.rope_scaling
    key = (cfg.rope_dim, cfg.rope_base, cfg.n_ctx_train, s.kind, s.factor, s.orig_ctx,
           s.ext_factor, s.attn_factor, s.beta_fast, s.beta_slow, cfg.kv_lora_rank,
           cfg.head_dim, cfg.yarn_log_mul,
           torch.device("cpu") if device is None else torch.device(device))
    got = _rope_cache.get(key)
    if got is None:
        got = _rope_cache[key] = _rope_freqs(cfg, device)
    return got


def _rope_freqs(cfg: ModelConfig, device) -> tuple[torch.Tensor, float]:
    if cfg.kv_lora_rank:
        # latent attention (deepseek2): build_deepseek2's YaRN
        inv, mscale, _ = mla_rope_params(cfg)
        return torch.from_numpy(inv.copy()).to(device), mscale
    half = cfg.rope_dim // 2
    base = cfg.rope_base
    exps = torch.arange(0, half, dtype=torch.float32, device=device) * 2.0 / cfg.rope_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32, device=device), exps)
    s = cfg.rope_scaling
    mscale = 1.0
    if s.kind == "linear":
        inv_freq = inv_freq / s.factor
    elif s.kind == "yarn":
        freq_scale = 1.0 / s.factor
        orig = s.orig_ctx or cfg.n_ctx_train
        # corr dims are PAIR indices (ggml compares them against i0/2)
        low = max(0.0, math.floor(_yarn_corr_dim(cfg.rope_dim, orig, s.beta_fast, base)))
        high = min(cfg.rope_dim / 2.0 - 1.0,
                   math.ceil(_yarn_corr_dim(cfg.rope_dim, orig, s.beta_slow, base)))
        ramp = _yarn_ramp(low, high, torch.arange(half, dtype=torch.float32, device=device))
        ext = 1.0 if s.ext_factor < 0 else s.ext_factor  # -1 = auto
        ramp_mix = ramp * ext
        inv_freq = inv_freq * freq_scale * (1.0 - ramp_mix) + inv_freq * ramp_mix
        mscale = s.attn_factor
        if ext != 0.0:
            mscale = float(s.attn_factor * (1.0 + 0.1 * math.log(s.factor)))
    return inv_freq, mscale


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           rope_type: str) -> torch.Tensor:
    """Rotate the first 2*half dims of f32 x (..., D) by (cos, sin) (..., half)."""
    half = cos.shape[-1]
    rot = 2 * half
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    if rope_type == RopeType.NORM:  # adjacent pairs
        xr = x_rot.reshape(*x_rot.shape[:-1], half, 2)
        x0, x1 = xr[..., 0], xr[..., 1]
        y = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                        dim=-1).reshape(x_rot.shape)
    else:  # neox: split halves
        x0, x1 = x_rot[..., :half], x_rot[..., half:]
        y = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return torch.cat([y, x_pass], dim=-1) if x_pass.shape[-1] else y


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
               rope_type: str, mscale: float = 1.0) -> torch.Tensor:
    """Rotate q/k. x: (batch, seq, heads, head_dim); positions: (batch, seq)."""
    theta = positions[..., None].float() * inv_freq  # (b, s, half)
    cos = (torch.cos(theta) * mscale)[:, :, None, :]
    sin = (torch.sin(theta) * mscale)[:, :, None, :]
    return rotate(x.float(), cos, sin, rope_type).to(x.dtype)


def alibi_slopes(n_heads: int, max_bias: float) -> torch.Tensor:
    """Per-head ALiBi slopes (n_heads,) f32, the two-regime formula of
    ggml_soft_max_ext."""
    n_log2 = 1 << int(math.floor(math.log2(n_heads)))
    m0 = 2.0 ** (-max_bias / n_log2)
    m1 = 2.0 ** (-max_bias / 2.0 / n_log2)
    h = torch.arange(n_heads, dtype=torch.float64)
    return torch.where(h < n_log2, m0 ** (h + 1), m1 ** (2 * (h - n_log2) + 1)).float()


def alibi_mask(pos_q: torch.Tensor, t: int) -> torch.Tensor:
    """Causal mask (b, 1, s, t) that carries -|pos_i - j| where visible
    (the softmax adds slope * mask per head)."""
    cols = torch.arange(t, device=pos_q.device)[None, None, :]
    visible = cols <= pos_q[:, :, None]
    dist = -(pos_q[:, :, None] - cols).abs().float()
    return torch.where(visible, dist, float("-inf"))[:, None]


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None, scale: float, logit_softcap: float = 0.0,
                  slopes: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped-query attention with an f32 softmax.
    q (b, s, H, hd), k/v (b, t, KVH, hd), mask (b, 1, s, t) additive.
    logit_softcap > 0 caps the scores at cap * tanh(s / cap) (gemma2);
    slopes (H,) scale the mask per head (ALiBi). Returns (b, s, H, hd) in
    q's dtype."""
    b, s, n_heads, hd = q.shape
    n_kv = k.shape[2]
    group = n_heads // n_kv
    qg = q.reshape(b, s, n_kv, group, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(), k.float()) * scale
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    if mask is not None:
        m = mask[:, None]  # (b,1,1,s,t)
        if slopes is not None:
            m = m * slopes.reshape(1, n_kv, group, 1, 1).to(m.device)
        scores = scores + m
    probs = torch.softmax(scores, dim=-1)
    # probs in v's dtype, as the JAX package does; half types accumulate
    # in f32 inside the product on either device
    out = torch.einsum("bngst,btnh->bsngh", probs.to(v.dtype), v)
    return out.reshape(b, s, n_heads, hd).to(q.dtype)


def mm_t(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T for a dense weight, both promoted as jnp.matmul promotes them
    (bf16 with f32 computes in f32); torch.matmul itself refuses mixed
    dtypes."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt).T


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SiLU(gate) * up (ggml_silu + ggml_mul)."""
    return (torch.nn.functional.silu(gate.float()) * up.float()).to(gate.dtype)


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """GELU(gate) * up with ggml's tanh approximation."""
    g = gate.float()
    gelu = 0.5 * g * (1.0 + torch.tanh(0.7978845608028654 * (g + 0.044715 * g * g * g)))
    return (gelu * up.float()).to(gate.dtype)


def gated_act(gate: torch.Tensor, up: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return geglu(gate, up)
    if act == "relu2":  # sqr(relu(x))
        r = torch.clamp(gate.float(), min=0.0)
        return (r * r * up.float()).to(gate.dtype)
    return swiglu(gate, up)


def causal_mask(pos_q: torch.Tensor, t: int, seq_lens: torch.Tensor | None = None,
                swa_window: int = 0) -> torch.Tensor:
    """Additive causal mask (b, 1, s, t): slot j is visible to a query at
    absolute position p iff j <= p (and j < seq_lens when given, and
    j > p - swa_window for a sliding window, gemma2's KQ_mask_swa)."""
    cols = torch.arange(t, device=pos_q.device)[None, None, :]
    visible = cols <= pos_q[:, :, None]
    if swa_window:
        visible &= cols > pos_q[:, :, None] - swa_window
    if seq_lens is not None:
        visible &= cols < seq_lens[:, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=pos_q.device)
    return torch.where(visible, zero, float("-inf"))[:, None]


def gqa_attention_sp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, scale: float, group) -> torch.Tensor:
    """Sequence-parallel GQA (prima_tpu/ops/layers.py:210-245): k / v
    (b, t_loc, KVH, hd) are this rank's block of the cache and mask
    (b, 1, s, t_loc) its columns. Each rank scores its block, then the
    softmax combines over `group` (a parallel.mesh.Axis) by log-sum-exp:
    an all-reduce MAX of the row maxima, then SUMs of the exponentials and
    of their products with v. A block that is wholly masked adds
    exp(-inf - m) = 0; position 0 is visible on the first block, so every
    row's maximum is finite."""
    b, s, n_heads, hd = q.shape
    n_kv = k.shape[2]
    group_sz = n_heads // n_kv
    qg = q.reshape(b, s, n_kv, group_sz, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(), k.float()) * scale
    scores = scores + mask[:, None]
    m = group.all_reduce(scores.amax(dim=-1, keepdim=True), "max")  # (b,n,g,s,1)
    p = torch.exp(scores - m)
    l = group.all_reduce(p.sum(dim=-1, keepdim=True), "sum")
    acc = group.all_reduce(
        torch.einsum("bngst,btnh->bsngh", p.to(v.dtype).float(), v.float()), "sum")
    l_t = torch.clamp(l[..., 0], min=1e-30).permute(0, 3, 1, 2)  # (b,s,n,g)
    out = acc / l_t[..., None]
    return out.reshape(b, s, n_heads, hd).to(q.dtype)
