"""DeepSeek-V2: multi-head latent attention (MLA) + fine-grained MoE.

Counterpart of prima_tpu/models/deepseek2.py on one device (CUDA unless
the caller asks for the CPU). The LLM_ARCH_DEEPSEEK2 analogue
(build_deepseek2, src/llama.cpp, the "naive" full multi-head MLA
formulation): queries optionally go through a LoRA bottleneck (q_a ->
RMSNorm -> q_b), keys/values decompress from one shared latent (kv_a_mqa ->
RMSNorm -> kv_b) with a single shared RoPE key head; per-head dims differ
between q/k (qk_nope + qk_rope) and v. The FFN is dense for the first
`leading_dense_block_count` layers, then MoE with unnormalized softmax
router weights scaled by expert_weights_scale plus an ungated shared
expert. minicpm3 rides the same attention with NEOX rope, its residual /
embedding / logit scalings and LongRoPE factors.

As in the JAX package this is a correctness-tier runtime: every weight is
dequantized on the host and held dense, the matmuls are `torch.matmul`
(the JAX package leaves them to XLA and reaches no Pallas kernel), every
token goes through every expert, and generation recomputes the whole
prefix at each token. The CLI runs minicpm3 GGUFs here; deepseek2 GGUFs
are served by the decoder (models/llama.py: latent attention over a latent
cache, the routed experts through the expert-indexed GEMV) under Engine in
the CLI and the server; both take YaRN's constants from `ops.layers.yarn_params`.
Dtypes promote as jnp promotes them: numpy f32 scalars are strong in JAX,
so with bf16 weights the residual stream turns f32 at the first residual
add, and bf16 weights meet f32 activations in f32 matmuls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFModel
from ..ops.layers import mm_t, rms_norm, yarn_params
from .family import dense_getter, open_runtime, tokens_tensor


@dataclass
class DeepseekV2Config:
    arch: str
    n_layers: int
    n_embd: int
    n_heads: int
    qk_rope: int
    qk_nope: int
    v_head_dim: int
    q_lora_rank: int  # 0 = lite (direct wq)
    kv_lora_rank: int
    n_ff: int
    n_dense_lead: int
    n_expert: int
    n_expert_used: int
    n_expert_shared: int
    expert_weights_scale: float
    n_vocab: int
    rms_eps: float
    rope_base: float
    # YaRN rope-scaling metadata ({arch}.rope.scaling.*): the reference
    # pre-scales kq_scale by mscale^2 and cancels the rope magnitude scale
    # (build_deepseek2, src/llama.cpp:15456-15460)
    rope_scaling: str = "none"
    rope_factor: float = 1.0
    rope_orig_ctx: int = 0
    rope_attn_factor: float = 1.0
    yarn_log_mul: float = 0.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    # minicpm3 (build_minicpm3, src/llama.cpp:14016-14023)
    embd_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0

    @classmethod
    def from_gguf(cls, m: GGUFModel) -> "DeepseekV2Config":
        g = m.arch_key
        tokens = m.get("tokenizer.ggml.tokens")
        qk_rope = int(g("{arch}.rope.dimension_count"))
        key_len = int(g("{arch}.attention.key_length"))
        extra = {}
        if m.arch == "minicpm3":
            n_layer = int(g("{arch}.block_count"))
            n_embd = int(g("{arch}.embedding_length"))
            extra = dict(
                embd_scale=float(g("{arch}.embedding_scale", 12.0) or 12.0),
                residual_scale=float(g("{arch}.residual_scale", 1.4 / n_layer ** 0.5)
                                     or 1.4 / n_layer ** 0.5),
                logit_scale=float(g("{arch}.logit_scale", 256.0 / n_embd) or 256.0 / n_embd),
            )
        return cls(
            **extra,
            arch=m.arch,
            n_layers=int(g("{arch}.block_count")),
            n_embd=int(g("{arch}.embedding_length")),
            n_heads=int(g("{arch}.attention.head_count")),
            qk_rope=qk_rope,
            qk_nope=key_len - qk_rope,
            v_head_dim=int(g("{arch}.attention.value_length")),
            q_lora_rank=int(g("{arch}.attention.q_lora_rank", 0) or 0),
            kv_lora_rank=int(g("{arch}.attention.kv_lora_rank")),
            n_ff=int(g("{arch}.feed_forward_length")),
            n_dense_lead=int(g("{arch}.leading_dense_block_count", 0) or 0),
            n_expert=int(g("{arch}.expert_count", 0) or 0),
            n_expert_used=int(g("{arch}.expert_used_count", 0) or 0),
            n_expert_shared=int(g("{arch}.expert_shared_count", 0) or 0),
            expert_weights_scale=float(g("{arch}.expert_weights_scale", 1.0) or 1.0),
            n_vocab=int(g("{arch}.vocab_size", len(tokens) if tokens is not None else 0)),
            rms_eps=float(g("{arch}.attention.layer_norm_rms_epsilon", 1e-6)),
            rope_base=float(g("{arch}.rope.freq_base", 10000.0)),
            rope_scaling=str(g("{arch}.rope.scaling.type", "none") or "none"),
            rope_factor=float(g("{arch}.rope.scaling.factor", 1.0) or 1.0),
            rope_orig_ctx=int(g("{arch}.rope.scaling.original_context_length", 0) or 0),
            rope_attn_factor=float(g("{arch}.rope.scaling.attention_factor", 1.0) or 1.0),
            yarn_log_mul=float(g("{arch}.rope.scaling.yarn_log_multiplier", 0.0) or 0.0),
            beta_fast=float(g("{arch}.rope.scaling.yarn_beta_fast", 32.0) or 32.0),
            beta_slow=float(g("{arch}.rope.scaling.yarn_beta_slow", 1.0) or 1.0),
        )


def load_deepseek2_params(m: GGUFModel, cfg: DeepseekV2Config, dtype=torch.float32,
                          device=None) -> dict:
    """Every tensor dequantized on the host, dense in `dtype` on `device`;
    stacked experts as (n_expert, rows, cols)."""
    get = dense_getter(m, dtype, device)
    params: dict = {"tok_embd": get("token_embd.weight"), "layers": []}
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer = {
            "attn_norm": get(p + "attn_norm.weight"),
            "kv_a_mqa": get(p + "attn_kv_a_mqa.weight"),
            "kv_a_norm": get(p + "attn_kv_a_norm.weight"),
            "kv_b": get(p + "attn_kv_b.weight"),
            "wo": get(p + "attn_output.weight"),
            "ffn_norm": get(p + "ffn_norm.weight"),
        }
        if cfg.q_lora_rank:
            layer["wq_a"] = get(p + "attn_q_a.weight")
            layer["q_a_norm"] = get(p + "attn_q_a_norm.weight")
            layer["wq_b"] = get(p + "attn_q_b.weight")
        else:
            layer["wq"] = get(p + "attn_q.weight")
        if i < cfg.n_dense_lead or not cfg.n_expert:
            layer["w_gate"] = get(p + "ffn_gate.weight")
            layer["w_up"] = get(p + "ffn_up.weight")
            layer["w_down"] = get(p + "ffn_down.weight")
        else:
            layer["gate_inp"] = get(p + "ffn_gate_inp.weight")
            for nm in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
                t = get(p + nm + ".weight")
                if t.ndim == 2:
                    t = t.reshape(cfg.n_expert, t.shape[0] // cfg.n_expert, t.shape[1])
                layer[nm] = t
            layer["gate_shexp"] = get(p + "ffn_gate_shexp.weight")
            layer["up_shexp"] = get(p + "ffn_up_shexp.weight")
            layer["down_shexp"] = get(p + "ffn_down_shexp.weight")
        params["layers"].append(layer)
    params["output_norm"] = get("output_norm.weight")
    params["output"] = get("output.weight", required=False)
    # minicpm3 LongRoPE per-dim frequency factors (loader @7746; chosen by
    # context length in build_rope_factors @10816)
    params["rope_long"] = get("rope_factors_long.weight", required=False)
    params["rope_short"] = get("rope_factors_short.weight", required=False)
    return params


def _rope_params(cfg: DeepseekV2Config) -> tuple[np.ndarray, float, float]:
    """(inv_freq over rope dims, rope magnitude scale, kq_scale) of this
    runtime's config: `ops.layers.yarn_params`, which the served decoder's
    latent attention takes too (`ops.layers.mla_rope_params`)."""
    return yarn_params(cfg.qk_rope, cfg.qk_nope + cfg.qk_rope, cfg.rope_base, cfg.rope_scaling,
                       cfg.rope_factor, cfg.rope_attn_factor, cfg.yarn_log_mul,
                       cfg.rope_orig_ctx, cfg.beta_fast, cfg.beta_slow)


def _rope_interleaved(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor,
                      mscale: float = 1.0, factors: torch.Tensor | None = None,
                      neox: bool = False) -> torch.Tensor:
    """Rope over the full last dim of x (b, s, h, d): NORM (adjacent pairs,
    deepseek2) or NEOX (split halves, minicpm3). `factors` are per-dim
    LongRoPE divisors (ggml rope freq_factors semantics). The result is f32,
    as x times the f32 cos / sin is in JAX."""
    half = x.shape[-1] // 2
    if factors is not None:
        inv = inv / factors.to(inv.dtype)
    theta = pos[..., None].float() * inv  # (b, s, half)
    cos = (torch.cos(theta) * mscale)[:, :, None, :]
    sin = (torch.sin(theta) * mscale)[:, :, None, :]
    if neox:
        x0, x1 = x[..., :half], x[..., half:]
        return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    xr = x.reshape(*x.shape[:-1], half, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(x.shape)


def _silu_mlp(x, wg, wu, wd):
    return mm_t(F.silu(mm_t(x, wg)) * mm_t(x, wu), wd)


def _moe(layer: dict, cfg: DeepseekV2Config, fin: torch.Tensor) -> torch.Tensor:
    """The routed experts and the shared expert. The router's softmax and
    top-k run in f32; the chosen weights are scaled (norm_w false, scale_w
    true) and cast to fin's dtype; every token goes through every expert
    and the experts are summed in ascending expert id, the reference's
    order, with the shared expert added last.

    torch.topk does not promise jax.lax.top_k's order among equal values.
    Only the set of chosen experts matters here (sel sums over k), and it
    changes only when the k-th and (k+1)-th router probabilities are equal
    in f32, which trained or random weights make vanishingly rare."""
    pr = torch.softmax(mm_t(fin, layer["gate_inp"]).float(), dim=-1)
    w, ids = torch.topk(pr, cfg.n_expert_used, dim=-1)
    w = (w * np.float32(cfg.expert_weights_scale)).to(fin.dtype)
    moe = torch.zeros_like(fin)
    for e in range(cfg.n_expert):
        sel = torch.where(ids == e, w, 0.0).sum(dim=-1)
        ye = _silu_mlp(fin, layer["ffn_gate_exps"][e], layer["ffn_up_exps"][e],
                       layer["ffn_down_exps"][e])
        moe = moe + sel[..., None] * ye
    return moe + _silu_mlp(fin, layer["gate_shexp"], layer["up_shexp"], layer["down_shexp"])


def deepseek2_forward(params: dict, cfg: DeepseekV2Config, tokens) -> torch.Tensor:
    """Teacher-forced full-sequence forward: tokens (b, s) -> logits
    (b, s, vocab)."""
    dev = params["tok_embd"].device
    tokens = tokens_tensor(tokens, dev)
    b, s = tokens.shape
    h = cfg.n_heads
    qk = cfg.qk_nope + cfg.qk_rope
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    x = params["tok_embd"][tokens]
    # np.float32 scalars are strong in JAX: each product below is f32
    if cfg.embd_scale != 1.0:  # minicpm3 (@14035)
        x = x.float() * float(np.float32(cfg.embd_scale))
    rope_inv, rope_mscale, kq_scale = _rope_params(cfg)
    neox = cfg.arch == "minicpm3"  # rope-type table @21548
    if neox:
        kq_scale = float(np.float32(1.0 / np.sqrt(qk)))  # @14023, even under YaRN
    inv = torch.from_numpy(rope_inv).to(dev)
    # LongRoPE: long factors past the original context, short inside
    # (@10816), chosen on the whole recomputed sequence
    factors = None
    if params.get("rope_short") is not None:
        factors = (params["rope_long"]
                   if cfg.rope_orig_ctx and s > cfg.rope_orig_ctx
                   and params.get("rope_long") is not None
                   else params["rope_short"])
    rscale = float(np.float32(cfg.residual_scale))
    mask = torch.triu(torch.full((s, s), float("-inf"), dtype=torch.float32, device=dev), 1)

    for layer in params["layers"]:
        xin = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        if cfg.q_lora_rank:
            q = rms_norm(mm_t(xin, layer["wq_a"]), layer["q_a_norm"], cfg.rms_eps)
            q = mm_t(q, layer["wq_b"])
        else:
            q = mm_t(xin, layer["wq"])
        q = q.reshape(b, s, h, qk)
        q_nope, q_pe = q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]

        kv_c = mm_t(xin, layer["kv_a_mqa"])  # (b, s, kv_lora + qk_rope)
        k_pe = kv_c[..., cfg.kv_lora_rank:][:, :, None, :]  # one shared head
        kv_c = rms_norm(kv_c[..., :cfg.kv_lora_rank], layer["kv_a_norm"], cfg.rms_eps)
        kv = mm_t(kv_c, layer["kv_b"]).reshape(b, s, h, cfg.qk_nope + cfg.v_head_dim)
        k_nope, v = kv[..., :cfg.qk_nope], kv[..., cfg.qk_nope:]

        q_pe = _rope_interleaved(q_pe, pos, inv, rope_mscale, factors=factors, neox=neox)
        k_pe = _rope_interleaved(k_pe, pos, inv, rope_mscale, factors=factors, neox=neox)
        qs = torch.cat([q_nope.to(q_pe.dtype), q_pe], dim=-1)
        ks = torch.cat([k_nope.to(k_pe.dtype),
                        k_pe.expand(*k_nope.shape[:-1], cfg.qk_rope)], dim=-1)

        scores = torch.einsum("bshd,bthd->bhst", qs, ks) * kq_scale + mask
        probs = torch.softmax(scores.float(), dim=-1)
        attn = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)
        x = x + mm_t(attn.reshape(b, s, h * cfg.v_head_dim), layer["wo"]).float() * rscale

        fin = rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
        if "w_gate" in layer:
            y = _silu_mlp(fin, layer["w_gate"], layer["w_up"], layer["w_down"])
        else:
            y = _moe(layer, cfg, fin)
        x = x + y.float() * rscale
    x = rms_norm(x, params["output_norm"], cfg.rms_eps)
    if cfg.logit_scale != 1.0:  # minicpm3 n_embd_base / n_embd (@14212)
        x = x.float() * float(np.float32(cfg.logit_scale))
    w_out = params["output"] if params["output"] is not None else params["tok_embd"]
    return mm_t(x, w_out)


class DeepseekV2Runtime:
    """Load + greedy generation for deepseek2 and minicpm3 GGUFs; each token
    recomputes the whole prefix, as the JAX runtime does (eagerly here,
    where the JAX jit compiles once per length)."""

    def __init__(self, cfg: DeepseekV2Config, params: dict, tokenizer=None, eog_ids=None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.eog_ids = eog_ids or set()

    @classmethod
    def load(cls, path: str, dtype=torch.float32, device=None) -> "DeepseekV2Runtime":
        _, cfg, params, tok, eog = open_runtime(path, DeepseekV2Config,
                                                load_deepseek2_params, dtype, device)
        return cls(cfg, params, tok, eog)

    def generate(self, prompt_tokens: list[int], n_predict: int = 32) -> list[int]:
        toks = list(prompt_tokens)
        out: list[int] = []
        with torch.no_grad():
            for _ in range(n_predict):
                logits = deepseek2_forward(self.params, self.cfg, [toks])
                tok = int(torch.argmax(logits[0, -1]))
                out.append(tok)
                if tok in self.eog_ids:
                    break
                toks.append(tok)
        return out
