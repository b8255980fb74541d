"""deepseek2: llama.cpp's build_deepseek2, the DeepSeek-V2(-Lite) block.

Each layer: RMSNorm; multi-head latent attention (MLA): the query heads
from attn_q (qk_nope dims without RoPE, then qk_rope with it; no query
LoRA, as in V2-Lite), one latent of kv_lora_rank and one shared RoPE key
of qk_rope from attn_kv_a_mqa, the latent RMS-normed (attn_kv_a_norm) and
decompressed through attn_kv_b into each head's key without RoPE and its
value (v_head_dim); RoPE on adjacent pairs (the GGUF's layout of HF's
interleaved rotary) under DeepSeek's YaRN; causal attention scaled by
mscale(mscale_all_dim)^2 / sqrt(qk_nope + qk_rope); attn_output and the
residual. Then RMSNorm and the FFN: a SwiGLU of n_ff in the first
n_dense_lead layers, else a softmax router over n_expert SwiGLU experts of
n_ff_exp whose top-k weights are taken as they are (norm_topk_prob false)
times expert_weights_scale, plus the shared experts as one ungated SwiGLU
of n_ff_shexp (n_shared_experts x n_ff_exp, as the GGUF stores them).

This is the published form, computed in f32 over whole sequences with
every latent decompressed. Departures from the published description:
- RoPE rotates adjacent pairs where HF permutes each head's rope dims into
  halves first: the scores, all that reads them, are the same;
- the YaRN correction range is clamped to [0, qk_rope - 1] as HF clamps
  it; ggml and the program clamp at qk_rope / 2 - 1, which is the same
  range wherever the bound is not reached (V2-Lite's range is [10, 23]);
- the shared experts are one SwiGLU of their summed width, as llama.cpp's
  GGUF and HF's DeepseekV2MoE (intermediate_size x n_shared_experts) both
  hold them.

The cache bytes of a cell are the latent and the RoPE key in bf16, as the
program caches them; the attention FLOPs of a cell are the absorbed form's
(scores against the latent and the RoPE key, the weighted latent), which
is what the program computes.
"""

from __future__ import annotations

import math

import torch

from benchmark.archs.llama import dense_ffn, expert_tensors, ffn_tensors
from benchmark.blocks import F32
from benchmark.layout import Tensor, quant
from benchmark.reference import attention, linear, rms_norm
from benchmark.roofline import KV_BYTES, BlockCost


def tensors(model: dict, types: dict) -> list[Tensor]:
    e, v, h = model["n_embd"], model["n_vocab"], model["n_heads"]
    nope, rope, vd, r = (model["qk_nope"], model["qk_rope"], model["v_head_dim"],
                         model["kv_lora_rank"])
    out = [quant(types, "token_embd.weight", (v, e))]
    for i in range(model["n_layers"]):
        p = f"blk.{i}."
        out += [Tensor(p + "attn_norm.weight", (e,), F32, "norm"),
                quant(types, p + "attn_q.weight", (h * (nope + rope), e)),
                quant(types, p + "attn_kv_a_mqa.weight", (r + rope, e)),
                Tensor(p + "attn_kv_a_norm.weight", (r,), F32, "norm"),
                quant(types, p + "attn_kv_b.weight", (h * (nope + vd), r)),
                quant(types, p + "attn_output.weight", (e, h * vd)),
                Tensor(p + "ffn_norm.weight", (e,), F32, "norm")]
        if i < model["n_dense_lead"]:
            out += ffn_tensors(types, p, e, model["n_ff"])
        else:
            out += expert_tensors(types, p, e, model["n_ff_exp"], model["n_expert"])
            out += ffn_tensors(types, p, e, model["n_ff_shexp"], "_shexp")
    out.append(Tensor("output_norm.weight", (e,), F32, "norm"))
    out.append(quant(types, "output.weight", (v, e)))
    return out


def yarn(model: dict, device) -> tuple[torch.Tensor, float, float]:
    """(inverse frequencies of the qk_rope / 2 pairs (f64), the RoPE
    magnitude, the attention scale) of DeepSeek's YaRN
    (DeepseekV2YarnRotaryEmbedding and DeepseekV2Attention's softmax_scale),
    or plain RoPE where the model has none."""
    d, base = model["qk_rope"], model["rope_base"]
    qk = model["qk_nope"] + d
    inv = base ** (-torch.arange(0, d // 2, device=device, dtype=torch.float64) * 2 / d)
    y = model.get("yarn")
    if not y:
        return inv, 1.0, 1.0 / math.sqrt(qk)
    f = y["factor"]

    def corr(rotations):
        return d * math.log(y["original_context"] / (rotations * 2 * math.pi)) / (2 * math.log(base))

    def get_mscale(m):
        return 0.1 * m * math.log(f) + 1.0 if f > 1 else 1.0

    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), d - 1)
    ramp = (torch.arange(d // 2, device=device, dtype=torch.float64) - low) / max(high - low,
                                                                                  1e-3)
    extra = 1.0 - ramp.clamp(0.0, 1.0)  # the share of the unscaled frequency
    inv = inv / f * (1.0 - extra) + inv * extra
    magnitude = get_mscale(y["mscale"]) / get_mscale(y["mscale_all_dim"])
    return inv, magnitude, get_mscale(y["mscale_all_dim"]) ** 2 / math.sqrt(qk)


def rope_pairs(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor,
               magnitude: float) -> torch.Tensor:
    """x (T, heads, d) rotated on its pairs (2i, 2i+1) by pos * inv_i, times
    the magnitude."""
    th = (pos.double()[:, None] * inv[None]).float()[:, None, :]
    cos, sin = torch.cos(th) * magnitude, torch.sin(th) * magnitude
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], -1).reshape(x.shape)


def block(ref, i: int, x, pos, lens):
    m, prec, p = ref.m, ref.precision, f"blk.{i}."
    h, nope, rope, vd, r = (m["n_heads"], m["qk_nope"], m["qk_rope"], m["v_head_dim"],
                            m["kv_lora_rank"])
    a = rms_norm(x, ref.w(p + "attn_norm.weight"), m["rms_eps"])
    q = linear(a, ref.w(p + "attn_q.weight"), prec).reshape(-1, h, nope + rope)
    kv_a = linear(a, ref.w(p + "attn_kv_a_mqa.weight"), prec)
    latent = rms_norm(kv_a[:, :r], ref.w(p + "attn_kv_a_norm.weight"), m["rms_eps"])
    kv = linear(latent, ref.w(p + "attn_kv_b.weight"), prec).reshape(-1, h, nope + vd)
    inv, magnitude, scale = yarn(m, x.device)
    q_pe = rope_pairs(q[..., nope:], pos, inv, magnitude)
    k_pe = rope_pairs(kv_a[:, None, r:], pos, inv, magnitude).expand(-1, h, rope)
    # `attention` divides the scores by sqrt(nope + rope): the query carries
    # the rest of YaRN's scale
    qs = torch.cat([q[..., :nope], q_pe], -1) * (scale * math.sqrt(nope + rope))
    ks = torch.cat([kv[..., :nope], k_pe], -1)
    out = attention(qs, ks, kv[..., nope:], h, lens)
    x = x + linear(out, ref.w(p + "attn_output.weight"), prec)
    f = rms_norm(x, ref.w(p + "ffn_norm.weight"), m["rms_eps"])
    if i < m["n_dense_lead"]:
        return x + dense_ffn(ref, p, f)
    routed = ref.experts(i, f, norm=False, scale=m["expert_weights_scale"])
    return x + (routed + dense_ffn(ref, p, f, "_shexp"))


def cost(model: dict) -> BlockCost:
    """Per token: the weights of every layer at the published form (q,
    the latent's down and up projections, the output; the dense FFN, or
    the chosen experts, the router and the shared experts); a visible
    cell's attention FLOPs at the absorbed form; a cell's cache bytes."""
    e, n, lead, h = model["n_embd"], model["n_layers"], model["n_dense_lead"], model["n_heads"]
    nope, rope, vd, r = (model["qk_nope"], model["qk_rope"], model["v_head_dim"],
                         model["kv_lora_rank"])
    attn = e * h * (nope + rope) + e * (r + rope) + r * h * (nope + vd) + h * vd * e
    dense = 3 * e * model["n_ff"]
    moe = (model["n_expert_used"] * 3 * e * model["n_ff_exp"] + e * model["n_expert"]
           + 3 * e * model["n_ff_shexp"])
    flops_cell = 2.0 * h * ((r + rope) + r)  # a head's score and its weighted latent
    bytes_cell = (r + rope) * KV_BYTES
    return BlockCost(2.0 * (n * attn + lead * dense + (n - lead) * moe), n * flops_cell,
                     n * bytes_cell)
