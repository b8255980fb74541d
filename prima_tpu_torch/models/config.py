"""Model configuration from GGUF metadata.

Covers the architectures the reference's distributed path supports —
LLM_ARCH_LLAMA and LLM_ARCH_QWEN2 (assert at src/llama.cpp:17003) including
MoE llama (Mixtral: llama.expert_count > 0) — plus the single-node families
gemma / gemma2 (llm_load_hparams src/llama.cpp:6242-6263, build_gemma2
@14333) and phi3 (fused qkv + fused gate/up, build_phi3 @13185).
Hparam keys mirror llm_load_hparams (src/llama.cpp:5823).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..gguf.reader import GGUFModel


class RopeType:
    NORM = "norm"  # adjacent pairs (GGML_ROPE_TYPE_NORM) — llama
    NEOX = "neox"  # split halves (GGML_ROPE_TYPE_NEOX) — qwen2


@dataclass
class RopeScaling:
    kind: str = "none"  # none | linear | yarn
    factor: float = 1.0
    orig_ctx: int = 0
    # -1 = auto: 1.0 for yarn, like the reference's cparams resolution
    # (llama_new_context_with_model); 0 degrades yarn to pure interpolation
    ext_factor: float = -1.0
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0


@dataclass
class ModelConfig:
    arch: str
    n_layers: int
    n_embd: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_ff: int
    n_vocab: int
    n_ctx_train: int
    rms_eps: float
    rope_base: float
    rope_dim: int
    rope_type: str
    rope_scaling: RopeScaling = field(default_factory=RopeScaling)
    qkv_bias: bool = False  # qwen2: bias on q/k/v projections
    tie_embeddings: bool = False
    name: str = ""
    # arch-specific behavior (defaults = llama)
    act: str = "silu"  # FFN gate activation: silu | gelu (gemma)
    embd_scale: float = 1.0  # gemma: sqrt(n_embd) on the embedding
    attn_scale: float = 0.0  # 0 = default 1/sqrt(head_dim); gemma2-27b differs
    attn_logit_softcap: float = 0.0  # gemma2: softcap * tanh(s / softcap)
    final_logit_softcap: float = 0.0
    post_norms: bool = False  # gemma2: post-attention / post-ffn RMSNorms
    swa_window: int = 0  # gemma2: sliding-window attention on even layers
    n_expert: int = 0  # MoE (Mixtral): expert count
    n_expert_used: int = 0  # top-k experts per token
    moe_norm_w: bool = True  # normalize top-k router weights (Mixtral yes,
    #                          qwen2moe no — llm_build_moe_ffn norm_w arg)
    residual_scale: float = 1.0  # minicpm: scale_depth / sqrt(n_layer)
    logit_scale: float = 1.0  # minicpm: 256/n_embd; command-r: f_logit_scale
    norm_type: str = "rms"  # "rms" | "ln" (LLM_NORM; weight/bias optional)
    ffn_gated: bool = True  # False: plain up -> act -> down MLP (starcoder2)
    parallel_block: bool = False  # command-r: attn + ffn share the norm input
    clamp_kqv: float = 0.0  # olmo: clamp q/k/v to +-clamp_kqv
    pos_embd: bool = False  # gpt2/starcoder: learned position embeddings
    alibi_max_bias: float = 0.0  # bloom/mpt: ALiBi attention biases
    tok_embd_norm: bool = False  # bloom: LayerNorm right after the embedding
    qk_norm_head: bool = False  # chameleon: per-head LayerNorm on q/k
    qk_norm_rms: bool = False  # openelm: the per-head q/k norm is RMS
    swin_norm: bool = False  # chameleon variant: post-norm placement
    moe_parallel_dense: bool = False  # arctic: dense FFN + parallel MoE
    sub_norms: bool = False  # bitnet: RMS sub-norms before wo / ffn_down
    # openelm: per-layer head/kv-head/ffn widths (GGUF array-valued KVs,
    # llm_load_hparams n_head_arr; empty = uniform cfg.n_heads etc.)
    n_heads_arr: tuple = ()
    n_kv_heads_arr: tuple = ()
    n_ff_arr: tuple = ()

    @property
    def n_embd_k_gqa(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def n_embd_v_gqa(self) -> int:
        return self.n_kv_heads * self.head_dim

    @classmethod
    def from_gguf(cls, m: GGUFModel) -> "ModelConfig":
        arch = m.arch
        if arch not in ("llama", "qwen2", "gemma", "gemma2", "phi3",
                        "internlm2", "minicpm", "qwen2moe", "starcoder2",
                        "olmo", "command-r", "phi2", "stablelm", "gptneox",
                        "falcon", "gpt2", "starcoder", "granite", "nemotron",
                        "olmoe", "bloom", "mpt", "gptj", "dbrx",
                        "granitemoe", "xverse", "exaone", "orion",
                        "baichuan", "refact", "plamo", "codeshell", "jais",
                        "chatglm", "chameleon", "grok", "arctic", "openelm",
                        "bitnet"):
            raise NotImplementedError(
                f"arch {arch!r} is not in the decoder arch table (see "
                "PARITY.md for the full list; mamba/t5/bert load through "
                "their own runtime modules)"
            )
        g = m.arch_key

        def scalar_or_arr(v):
            """openelm carries array-valued head-count / ffn-length KVs
            (llm_load_hparams n_head_arr); scalar archs get an empty arr."""
            if v is not None and not isinstance(v, (int, float, str)) \
                    and hasattr(v, "__len__"):
                arr = tuple(int(x) for x in v)
                return max(arr), arr
            return (int(v) if v is not None else None), ()

        n_embd = int(g("{arch}.embedding_length"))
        n_heads, n_heads_arr = scalar_or_arr(g("{arch}.attention.head_count"))
        n_kv, n_kv_arr = scalar_or_arr(
            g("{arch}.attention.head_count_kv", n_heads))
        head_dim = int(g("{arch}.attention.key_length", n_embd // n_heads))
        n_layers = int(g("{arch}.block_count"))
        rope_dim = int(g("{arch}.rope.dimension_count", head_dim))

        scaling = RopeScaling()
        stype = g("{arch}.rope.scaling.type")
        if stype in ("linear", "yarn"):
            scaling.kind = stype
            scaling.factor = float(g("{arch}.rope.scaling.factor", 1.0))
            scaling.orig_ctx = int(g("{arch}.rope.scaling.original_context_length", 0))
            if stype == "yarn":
                scaling.ext_factor = 1.0
                scaling.beta_fast = float(g("{arch}.rope.scaling.yarn_beta_fast", 32.0) or 32.0)
                scaling.beta_slow = float(g("{arch}.rope.scaling.yarn_beta_slow", 1.0) or 1.0)

        tokens = m.get("tokenizer.ggml.tokens")
        n_vocab = g("{arch}.vocab_size", len(tokens) if tokens is not None else 0)

        tie = "output.weight" not in m.tensors

        extra = {}
        if arch in ("gemma", "gemma2"):
            extra["act"] = "gelu"
            extra["embd_scale"] = float(n_embd) ** 0.5
        if arch == "gemma2":
            extra["attn_logit_softcap"] = float(
                g("{arch}.attn_logit_softcapping", 50.0))
            extra["final_logit_softcap"] = float(
                g("{arch}.final_logit_softcapping", 30.0))
            extra["post_norms"] = True
            extra["swa_window"] = int(g("{arch}.attention.sliding_window", 4096))
            if n_layers == 46:  # 27B: 1/sqrt(n_embd / n_head) (llama.cpp:14387)
                extra["attn_scale"] = 1.0 / float(n_embd / n_heads) ** 0.5
            else:
                extra["attn_scale"] = 1.0 / float(head_dim) ** 0.5
        if arch == "minicpm":
            # the reference hardcodes scale_embd=12, scale_depth=1.4 and
            # n_embd_base=256 (build_minicpm, src/llama.cpp:13880-13884);
            # newer GGUFs carry them as KVs
            extra["embd_scale"] = float(g("{arch}.embedding_scale", 12.0))
            extra["residual_scale"] = float(
                g("{arch}.residual_scale", 1.4 / n_layers ** 0.5))
            extra["logit_scale"] = float(g("{arch}.logit_scale", 256.0 / n_embd))
        if arch in ("qwen2moe", "olmoe"):
            extra["moe_norm_w"] = False  # norm_w=false in both builders
        if arch == "starcoder2":
            # LayerNorm + biased projections + gateless GELU MLP
            # (build_starcoder2, src/llama.cpp:14469)
            extra["norm_type"] = "ln"
            extra["ffn_gated"] = False
            extra["act"] = "gelu"
        if arch == "olmo":
            # non-parametric LayerNorm, optional q/k/v clamping
            # (build_olmo, src/llama.cpp:14797)
            extra["norm_type"] = "ln"
            extra["clamp_kqv"] = float(g("{arch}.attention.clamp_kqv", 0.0) or 0.0)
        if arch == "phi2":
            # LayerNorm+bias, parallel attn+MLP off one norm, biased lm_head
            # (build_phi2, src/llama.cpp:13064)
            extra["norm_type"] = "ln"
            extra["parallel_block"] = True
            extra["ffn_gated"] = False
            extra["act"] = "gelu"
        if arch in ("granite", "granitemoe"):
            # llama with four scale knobs (LLM_ARCH_GRANITE,
            # src/llama.cpp:6556-6560); logits are DIVIDED by logit_scale
            extra["embd_scale"] = float(g("{arch}.embedding_scale", 1.0) or 1.0)
            extra["residual_scale"] = float(
                g("{arch}.residual_scale", 1.0) or 1.0)
            ls = float(g("{arch}.logit_scale", 0.0) or 0.0)
            if ls:
                extra["logit_scale"] = 1.0 / ls
            ats = float(g("{arch}.attention.scale", 0.0) or 0.0)
            if ats:
                extra["attn_scale"] = ats
        if arch == "nemotron":
            # layernorm1p folded into +1 weights at conversion; squared-ReLU
            # MLP, partial rope (build_nemotron, src/llama.cpp:16369)
            extra["norm_type"] = "ln"
            extra["ffn_gated"] = False
            extra["act"] = "relu2"
        if arch == "orion":
            extra["norm_type"] = "ln"  # build_orion uses LLM_NORM
        if arch == "dbrx":
            # LayerNorm (no bias), fused clamped qkv, MoE with normalized
            # top-k weights (build_dbrx)
            extra["norm_type"] = "ln"
            extra["clamp_kqv"] = float(g("{arch}.attention.clamp_kqv", 0.0) or 0.0)
        if arch == "gptj":
            # parallel attn+MLP off one LayerNorm, partial interleaved
            # rotary, biased lm_head (build_gptj)
            extra["norm_type"] = "ln"
            extra["parallel_block"] = True
            extra["ffn_gated"] = False
            extra["act"] = "gelu"
        if arch == "bloom":
            # embedding LayerNorm, per-head-interleaved fused qkv
            # (de-interleaved at conversion), ALiBi (f_max_alibi_bias = 8)
            extra["norm_type"] = "ln"
            extra["ffn_gated"] = False
            extra["act"] = "gelu"
            extra["alibi_max_bias"] = 8.0
            extra["tok_embd_norm"] = True
        if arch == "mpt":
            extra["norm_type"] = "ln"
            extra["ffn_gated"] = False
            extra["act"] = "gelu"
            extra["alibi_max_bias"] = float(
                g("{arch}.attention.max_alibi_bias", 8.0) or 0.0)
            extra["clamp_kqv"] = float(
                g("{arch}.attention.clamp_kqv", 0.0) or 0.0)
        if arch in ("gpt2", "starcoder"):
            # learned position embeddings (LLM_TENSOR_POS_EMBD), LayerNorm
            # +bias, fused qkv with biases, gateless GELU MLP, no rope
            # (build_gpt2 / build_starcoder)
            extra["norm_type"] = "ln"
            extra["ffn_gated"] = False
            extra["act"] = "gelu"
            extra["pos_embd"] = True
        if arch == "falcon":
            # LayerNorm+bias, fused qkv ([q;k;v] after the converter's
            # "jploski" reorder), parallel attn+MLP; attn_norm_2 (when
            # present, falcon-40b) norms the MLP input (build_falcon)
            extra["norm_type"] = "ln"
            extra["ffn_gated"] = False
            extra["act"] = "gelu"
            extra["parallel_block"] = True
        if arch == "gptneox":
            # LayerNorm+bias, gateless GELU MLP, optionally parallel residual
            # with its own ffn_norm (build_gptneox)
            extra["norm_type"] = "ln"
            extra["ffn_gated"] = False
            extra["act"] = "gelu"
            extra["parallel_block"] = bool(
                g("{arch}.use_parallel_residual", True))
        if arch == "stablelm":
            # LayerNorm+bias norms, partial rope (build_stablelm)
            extra["norm_type"] = "ln"
        if arch == "command-r":
            # parallel attn+ffn off one LayerNorm, scaled logits
            # (build_command_r, src/llama.cpp:14642)
            extra["norm_type"] = "ln"
            extra["parallel_block"] = True
            extra["logit_scale"] = float(g("{arch}.logit_scale", 1.0) or 1.0)
        if arch == "baichuan" and n_layers >= 40:
            # Baichuan-13B: ALiBi instead of rope (build_baichuan MODEL_13B
            # branch, src/llama.cpp:11271; f_max_alibi_bias=8 @6010)
            extra["alibi_max_bias"] = 8.0
        if arch == "refact":
            # no rope, ALiBi 8 (build_refact; rope table LLAMA_ROPE_TYPE_NONE)
            extra["alibi_max_bias"] = 8.0
        if arch == "plamo":
            # parallel attn+ffn sharing the attention norm (build_plamo:
            # ffn input = attention_norm output, no ffn_norm tensor)
            extra["parallel_block"] = True
        if arch == "codeshell":
            # LN norms with bias, fused qkv, NEOX rope, plain GELU MLP
            # (build_codeshell, src/llama.cpp:13522)
            extra["norm_type"] = "ln"
            extra["ffn_gated"] = False
            extra["act"] = "gelu"
        if arch == "jais":
            # no rope + ALiBi, LN norms, fused qkv, 1/head_dim attention
            # scale, gated SILU ffn with biases (build_jais @16163)
            extra["norm_type"] = "ln"
            extra["alibi_max_bias"] = 8.0
            extra["attn_scale"] = 1.0 / head_dim
        if arch == "chatglm":
            # fused qkv+bias, partial NORM rope, ffn_up holds [gate|up]
            # (LLM_FFN_SWIGLU split, build_chatglm @16255)
            extra["act"] = "swiglu_split"
            extra["ffn_gated"] = False
        if arch == "grok":
            # build_grok (src/llama.cpp:11558): scaled embeddings, tanh
            # attention softcap (llm_build_kqv @10106-10118), GELU MoE,
            # post attn/ffn norms (attn_out_norm / layer_out_norm),
            # 1/sqrt(3) logit multiplier
            extra["act"] = "gelu"
            extra["embd_scale"] = 78.38367176906169
            extra["attn_scale"] = 0.08838834764831845
            extra["attn_logit_softcap"] = 30.0
            extra["logit_scale"] = 0.5773502691896257
            extra["post_norms"] = True
        if arch == "arctic":
            # build_arctic (@15316): dense FFN residual + PARALLEL MoE
            # branch normed from the LAYER INPUT (ffn_norm_exps)
            extra["moe_parallel_dense"] = True
        if arch == "chameleon":
            # per-head q/k LayerNorms before rope; optional swin (post)
            # norm placement (build_chameleon @16734)
            extra["qk_norm_head"] = True
            extra["swin_norm"] = bool(g("{arch}.swin_norm", False))
        if arch == "openelm":
            # per-layer head/kv/ffn widths (array KVs), fused qkv, per-head
            # RMS q/k norms before NEOX rope (build_openelm @15049)
            extra["qk_norm_head"] = True
            extra["qk_norm_rms"] = True
            extra["n_heads_arr"] = n_heads_arr
            extra["n_kv_heads_arr"] = n_kv_arr
        if arch == "bitnet":
            # ternary-weight llama variant: per-tensor .scale multipliers,
            # RMS sub-norms before wo and ffn_down (build_bitnet @15676)
            extra["sub_norms"] = True
        n_expert = int(g("{arch}.expert_count", 0) or 0)
        if n_expert:
            extra["n_expert"] = n_expert
            extra["n_expert_used"] = int(g("{arch}.expert_used_count", 2))

        n_ff, n_ff_arr = scalar_or_arr(g("{arch}.feed_forward_length"))
        if n_ff_arr:
            extra["n_ff_arr"] = n_ff_arr

        return cls(
            arch=arch,
            n_layers=n_layers,
            n_embd=n_embd,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            n_ff=n_ff,
            n_vocab=int(n_vocab),
            n_ctx_train=int(g("{arch}.context_length", 4096)),
            rms_eps=float(g("{arch}.attention.layer_norm_rms_epsilon",
                            g("{arch}.attention.layer_norm_epsilon", 1e-5))),
            rope_base=float(g("{arch}.rope.freq_base", 10000.0)),
            rope_dim=(0 if arch in ("gpt2", "starcoder", "bloom", "mpt",
                                    "refact", "jais")
                      or (arch == "baichuan" and n_layers >= 40)
                      else rope_dim),
            rope_type=(RopeType.NORM
                       if arch in ("llama", "internlm2", "minicpm", "olmo",
                                   "command-r", "granite", "granitemoe",
                                   "gptj", "xverse", "orion", "baichuan",
                                   "plamo", "chatglm", "chameleon", "arctic")
                       else RopeType.NEOX),
            rope_scaling=scaling,
            qkv_bias=arch in ("qwen2", "qwen2moe", "starcoder2", "phi2"),
            tie_embeddings=tie,
            name=str(m.get("general.name", "")),
            **extra,
        )

    def flops_per_token(self) -> float:
        """Approximate forward FLOPs per token (2*params for matmuls)."""
        attn = 2 * self.n_embd * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        attn += 2 * self.n_heads * self.head_dim * self.n_embd
        ffn = 3 * 2 * self.n_embd * self.n_ff
        return self.n_layers * (attn + ffn) + 2 * self.n_embd * self.n_vocab


def apply_rope_overrides(cfg: ModelConfig, *, rope_scaling: str | None = None,
                         rope_freq_base: float = 0.0,
                         rope_freq_scale: float = 0.0,
                         yarn_orig_ctx: int = 0,
                         yarn_ext_factor: float = -1.0,
                         yarn_attn_factor: float = -1.0,
                         yarn_beta_fast: float = -1.0,
                         yarn_beta_slow: float = -1.0) -> ModelConfig:
    """Command-line RoPE overrides on top of the GGUF metadata — the
    analogue of the reference's cparams plumbing (--rope-scaling,
    --rope-freq-base, --rope-freq-scale, --yarn-* in common/arg.cpp;
    defaults resolved against model metadata in llama_new_context_with_model
    src/llama.cpp:20940-20980). Zero / -1 / None mean "from model"; the
    reference's freq_scale is 1/factor (GGUF stores the factor)."""
    s = cfg.rope_scaling
    if rope_scaling is not None:
        s.kind = rope_scaling
        if rope_scaling == "none":
            s.factor = 1.0
        s.ext_factor = 1.0 if rope_scaling == "yarn" else 0.0
    if rope_freq_base:
        cfg.rope_base = float(rope_freq_base)
    if rope_freq_scale:
        s.factor = 1.0 / float(rope_freq_scale)
        if s.kind == "none":
            s.kind = "linear"
    if yarn_orig_ctx:
        s.orig_ctx = int(yarn_orig_ctx)
    if yarn_ext_factor >= 0:
        s.ext_factor = float(yarn_ext_factor)
    if yarn_attn_factor >= 0:
        s.attn_factor = float(yarn_attn_factor)
    if yarn_beta_fast >= 0:
        s.beta_fast = float(yarn_beta_fast)
    if yarn_beta_slow >= 0:
        s.beta_slow = float(yarn_beta_slow)
    return cfg


def tiny_config(**overrides: Any) -> ModelConfig:
    """A small llama config for tests."""
    cfg = ModelConfig(
        arch="llama",
        n_layers=2,
        n_embd=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        n_ff=128,
        n_vocab=256,
        n_ctx_train=128,
        rms_eps=1e-5,
        rope_base=10000.0,
        rope_dim=16,
        rope_type=RopeType.NORM,
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
