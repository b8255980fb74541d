"""Second-wave HF -> GGUF converters: the remote-code / niche architectures.

The analogue of the remaining converter classes in the reference's
convert_hf_to_gguf.py (BaichuanModel @1104, XverseModel @1184, OrionModel
@1069, InternLM2Model @2346, MiniCPMModel @1826, ExaoneModel @4044, ...).
Unlike the mainline families in convert_hf.py, most of these models ship
with remote modeling code, so conversion is driven purely by checkpoint
tensor names (safetensors) + config.json — no transformers class needed.

Design: a small spec per architecture (rename map + optional tensor
transform + arch KVs) executed by one generic driver, instead of the
reference's per-class inheritance.  Specs are registered by HF
`architectures` entry and dispatched from convert_hf.convert_hf_to_gguf.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.writer import GGUFWriter
from .quantize import FTYPES, _encode, _target_type_simple

Emit = Iterable[tuple]  # (gguf_name, np.ndarray) or (gguf_name, arr, ne)


@dataclass
class ArchSpec:
    arch: str
    # rename-only map entries: exact top-level names + per-layer suffixes
    top: list = field(default_factory=list)          # (hf_name, gguf_name)
    layer: list = field(default_factory=list)        # (suffix, gguf_suffix)
    layer_prefix: str = "model.layers."
    eps_key: str = "rms"                             # "rms" | "ln" | "both"
    # mutate the derived-dims dict before the generic KV block: derive(hf, d)
    derive: Callable | None = None
    # False: skip the generic dims/eps/rope KV block entirely — the kv hook
    # writes everything (archs with array-valued or non-standard KVs)
    generic_kv: bool = True
    # arch-specific KVs, called after the generic block: kv(w, hf, d)
    kv: Callable | None = None
    # custom vocabulary writer: vocab(w, src_dir, hf); None -> the shared
    # tokenizer.json / tokenizer.model path (rwkv6's world vocab differs)
    vocab: Callable | None = None
    # full-control tensor hook: yields emits, or None -> fall back to maps
    transform: Callable | None = None
    # post-iteration hook for buffered tensors (MoE stacking etc.)
    finish: Callable | None = None


def _permute_qk(w: np.ndarray, n_heads: int) -> np.ndarray:
    """HF interleaved rotary order -> GGUF adjacent-pair ('norm') order."""
    rows, k = w.shape
    hd = rows // n_heads
    return (w.reshape(n_heads, 2, hd // 2, k)
            .transpose(0, 2, 1, 3)
            .reshape(rows, k))


def _rename(spec: ArchSpec, hf_name: str) -> str | None:
    for src, dst in spec.top:
        if hf_name == src:
            return dst
    if hf_name.startswith(spec.layer_prefix):
        rest = hf_name[len(spec.layer_prefix):]
        idx, _, rest = rest.partition(".")
        for src, dst in spec.layer:
            if rest == src:
                return f"blk.{idx}.{dst}"
    return None


def _derived(hf: dict) -> dict:
    def scalar(*keys, default=0):
        # list-valued entries (openelm per-layer head counts) are the
        # arch hook's job — the generic dims only take scalars
        for k in keys:
            v = hf.get(k)
            if v is not None and not isinstance(v, (list, tuple)):
                return int(v)
        return int(default)

    n_embd = scalar("hidden_size", "n_embd", "d_model")
    n_heads = scalar("num_attention_heads", "n_head", "n_heads")
    n_kv = scalar("num_key_value_heads", "num_kv_heads",
                  "multi_query_group_num", "num_query_groups",
                  default=n_heads)
    n_layers = scalar("num_hidden_layers", "n_layer", "n_layers",
                      "num_layers")
    return {
        "n_embd": n_embd, "n_heads": n_heads, "n_kv": n_kv,
        "n_layers": n_layers,
        "head_dim": (n_embd // n_heads) if n_heads else 0,
        "n_ff": int(hf.get("intermediate_size") or hf.get("n_inner")
                    or hf.get("ffn_hidden_size") or (4 * n_embd)),
        "n_ctx": int(hf.get("max_sequence_length")
                     or hf.get("max_position_embeddings")
                     or hf.get("model_max_length")
                     or hf.get("seq_length") or hf.get("n_positions") or 4096),
    }


def convert_extra(src_dir: str, dst_path: str, hf: dict, ftype: str,
                  logfile=sys.stderr) -> int | None:
    """Convert via the spec registry; None if no spec covers `hf`."""
    spec = None
    for a in hf.get("architectures") or []:
        if a in _SPECS:
            spec = _SPECS[a]
            break
    if spec is None:
        return None
    # local imports to avoid a cycle (convert_hf imports this module)
    from .convert_hf import _iter_hf_tensors, _write_tokenizer

    d = _derived(hf)
    if spec.derive is not None:
        spec.derive(hf, d)
    arch = spec.arch
    w = GGUFWriter(dst_path, arch=arch)
    w.add_kv("general.name", os.path.basename(os.path.normpath(src_dir)))
    if spec.generic_kv:
        w.add_kv(f"{arch}.block_count", d["n_layers"])
        w.add_kv(f"{arch}.embedding_length", d["n_embd"])
        w.add_kv(f"{arch}.feed_forward_length", d["n_ff"])
        w.add_kv(f"{arch}.attention.head_count", d["n_heads"])
        w.add_kv(f"{arch}.attention.head_count_kv", d["n_kv"])
        w.add_kv(f"{arch}.context_length", d["n_ctx"])
        eps = float(hf.get("rms_norm_eps") or hf.get("layer_norm_epsilon")
                    or hf.get("layer_norm_eps") or hf.get("layernorm_epsilon")
                    or hf.get("norm_eps") or 1e-5)
        if spec.eps_key in ("rms", "both"):
            w.add_kv(f"{arch}.attention.layer_norm_rms_epsilon", eps)
        if spec.eps_key in ("ln", "both"):
            w.add_kv(f"{arch}.attention.layer_norm_epsilon", eps)
        w.add_kv(f"{arch}.rope.freq_base",
                 float(hf.get("rope_theta", 10000.0)))
        rot_pct = hf.get("partial_rotary_factor") or hf.get("rope_pct") or 1.0
        w.add_kv(f"{arch}.rope.dimension_count",
                 int(d["head_dim"] * float(rot_pct)))
        if hf.get("vocab_size"):
            w.add_kv(f"{arch}.vocab_size", int(hf["vocab_size"]))
        rs = hf.get("rope_scaling") or {}
        if rs.get("type") in ("linear", "yarn") and rs.get("factor"):
            w.add_kv(f"{arch}.rope.scaling.type", rs["type"])
            w.add_kv(f"{arch}.rope.scaling.factor", float(rs["factor"]))
            if rs.get("original_max_position_embeddings"):
                w.add_kv(f"{arch}.rope.scaling.original_context_length",
                         rs["original_max_position_embeddings"])
    if spec.kv is not None:
        spec.kv(w, hf, d)
    if spec.vocab is not None:
        spec.vocab(w, src_dir, hf)
    else:
        _write_tokenizer(w, src_dir, hf)

    default_t, out_t = FTYPES[ftype.upper()]
    n = 0

    def emit(name, data, ne=None):
        nonlocal n
        t = _target_type_simple(name, ne or tuple(reversed(data.shape)),
                         default_t, out_t)
        flat = data.reshape(-1, data.shape[-1])
        enc, t = _encode(flat, t)
        if t in (GGMLType.F32, GGMLType.F16):
            enc = enc.reshape(data.shape) if ne is None else enc
            w.add_tensor(name, enc, ne=ne, ggml_type=t if ne else None)
        else:
            w.add_tensor(name, enc, ne=ne or tuple(reversed(data.shape)),
                         ggml_type=t)
        n += 1
        print(f"[{n:4d}] {name} ({t.name})", file=logfile)

    state: dict = {}
    for hf_name, data in _iter_hf_tensors(src_dir):
        outs = None
        if spec.transform is not None:
            outs = spec.transform(hf_name, data, hf, d, state)
        if outs is None:
            name = _rename(spec, hf_name)
            outs = [] if name is None else [(name, data)]
        for out in outs:
            emit(*out)
    if spec.finish is not None:
        for out in spec.finish(hf, d, state):
            emit(*out)
    w.write()
    return n


# ---------------------------------------------------------------------------
# llama-shaped name fragments shared by several specs

_LLAMA_TOP = [
    ("model.embed_tokens.weight", "token_embd.weight"),
    ("model.norm.weight", "output_norm.weight"),
    ("model.norm.bias", "output_norm.bias"),
    ("lm_head.weight", "output.weight"),
]
_LLAMA_LAYER = [
    ("input_layernorm.weight", "attn_norm.weight"),
    ("input_layernorm.bias", "attn_norm.bias"),
    ("self_attn.q_proj.weight", "attn_q.weight"),
    ("self_attn.k_proj.weight", "attn_k.weight"),
    ("self_attn.v_proj.weight", "attn_v.weight"),
    ("self_attn.o_proj.weight", "attn_output.weight"),
    ("post_attention_layernorm.weight", "ffn_norm.weight"),
    ("post_attention_layernorm.bias", "ffn_norm.bias"),
    ("mlp.gate_proj.weight", "ffn_gate.weight"),
    ("mlp.up_proj.weight", "ffn_up.weight"),
    ("mlp.down_proj.weight", "ffn_down.weight"),
]


def _llama_permute_transform(hf_name, data, hf, d, state):
    """Permute q/k to GGUF NORM-rope order, defer the rest to the maps."""
    if hf_name.endswith("self_attn.q_proj.weight"):
        idx = hf_name.split(".")[2]
        return [(f"blk.{idx}.attn_q.weight", _permute_qk(data, d["n_heads"]))]
    if hf_name.endswith("self_attn.k_proj.weight"):
        idx = hf_name.split(".")[2]
        return [(f"blk.{idx}.attn_k.weight", _permute_qk(data, d["n_kv"]))]
    return None


def _baichuan_transform(hf_name, data, hf, d, state):
    """Split the fused W_pack into permuted q/k + v (BaichuanModel
    modify_tensors — _reverse_hf_permute_part)."""
    if hf_name.endswith("self_attn.W_pack.weight"):
        idx = hf_name.split(".")[2]
        r = data.shape[0] // 3
        return [
            (f"blk.{idx}.attn_q.weight", _permute_qk(data[:r], d["n_heads"])),
            (f"blk.{idx}.attn_k.weight", _permute_qk(data[r:2 * r], d["n_kv"])),
            (f"blk.{idx}.attn_v.weight", data[2 * r:]),
        ]
    return None


def _internlm2_transform(hf_name, data, hf, d, state):
    """Split the grouped wqkv layout: (groups, q_per_kv+2, hd, n_embd) ->
    permuted q/k + v (InternLM2Model modify_tensors @2490)."""
    if ".attention.wqkv." in hf_name:
        idx = hf_name.split(".")[2]
        q_per_kv = d["n_heads"] // d["n_kv"]
        hd = d["head_dim"]
        qkv = data.reshape(d["n_kv"], q_per_kv + 2, hd, d["n_embd"])
        q = qkv[:, :q_per_kv].reshape(-1, d["n_embd"])
        k = qkv[:, -2].reshape(-1, d["n_embd"])
        v = qkv[:, -1].reshape(-1, d["n_embd"])
        return [
            (f"blk.{idx}.attn_q.weight", _permute_qk(q, d["n_heads"])),
            (f"blk.{idx}.attn_k.weight", _permute_qk(k, d["n_kv"])),
            (f"blk.{idx}.attn_v.weight", v),
        ]
    return None


_SPECS: dict[str, ArchSpec] = {}


def _register(cls_names, spec: ArchSpec) -> None:
    for c in ([cls_names] if isinstance(cls_names, str) else cls_names):
        _SPECS[c] = spec


_register(["BaichuanForCausalLM", "BaiChuanForCausalLM"], ArchSpec(
    arch="baichuan",
    top=_LLAMA_TOP, layer=_LLAMA_LAYER,
    transform=_baichuan_transform,
))

_register("XverseForCausalLM", ArchSpec(
    arch="xverse",
    top=_LLAMA_TOP, layer=_LLAMA_LAYER,
    transform=_llama_permute_transform,
))

# note: the reference converter does NOT permute orion q/k (OrionModel has
# no modify_tensors) — mirror that; eps comes from rms_norm_eps but the
# model is LayerNorm (OrionModel set_gguf_parameters comment)
_register("OrionForCausalLM", ArchSpec(
    arch="orion",
    top=_LLAMA_TOP, layer=_LLAMA_LAYER,
    eps_key="ln",
))

_register("InternLM2ForCausalLM", ArchSpec(
    arch="internlm2",
    top=[("model.tok_embeddings.weight", "token_embd.weight"),
         ("model.norm.weight", "output_norm.weight"),
         ("output.weight", "output.weight")],
    layer=[("attention_norm.weight", "attn_norm.weight"),
           ("attention.wo.weight", "attn_output.weight"),
           ("ffn_norm.weight", "ffn_norm.weight"),
           ("feed_forward.w1.weight", "ffn_gate.weight"),
           ("feed_forward.w3.weight", "ffn_up.weight"),
           ("feed_forward.w2.weight", "ffn_down.weight")],
    transform=_internlm2_transform,
))

_register("MiniCPMForCausalLM", ArchSpec(
    arch="minicpm",
    top=_LLAMA_TOP, layer=_LLAMA_LAYER,
    transform=_llama_permute_transform,
    # newer MiniCPM configs carry the scale knobs; the reference hardcodes
    # them in build_minicpm (scale_embd=12, scale_depth=1.4, base=256)
    kv=lambda w, hf, d: [
        w.add_kv("minicpm.embedding_scale", float(hf.get("scale_emb", 12.0))),
        w.add_kv("minicpm.residual_scale",
                 float(hf.get("scale_depth", 1.4)) / d["n_layers"] ** 0.5),
        w.add_kv("minicpm.logit_scale",
                 float(hf.get("dim_model_base", 256)) / d["n_embd"]),
    ] and None,
))

# ---------------------------------------------------------------------------
# batch 2: refact / plamo / codeshell / jais / chatglm / chameleon
# (reference converter classes RefactModel @1362, PlamoModel @2262,
#  CodeShellModel @2310, JaisModel @3731, ChatGLMModel @3820,
#  ChameleonModel @4172 in convert_hf_to_gguf.py)


def _refact_ff(n_embd: int) -> int:
    """Refact's implied FFN width (RefactModel set_gguf_parameters)."""
    hidden = int(2 * (4 * n_embd) / 3)
    return 256 * ((hidden + 255) // 256)


def _refact_derive(hf, d):
    d["n_kv"] = 1  # multi-query attention, not in config.json
    d["n_ff"] = _refact_ff(d["n_embd"])


def _refact_transform(hf_name, data, hf, d, state):
    if ".attn.kv.weight" in hf_name:
        idx = hf_name.split(".")[2]
        hd = d["head_dim"]
        return [(f"blk.{idx}.attn_k.weight", data[:hd]),
                (f"blk.{idx}.attn_v.weight", data[hd:])]
    if ".mlp.gate_up_proj.weight" in hf_name:
        idx = hf_name.split(".")[2]
        ff = d["n_ff"]
        return [(f"blk.{idx}.ffn_gate.weight", data[:ff]),
                (f"blk.{idx}.ffn_up.weight", data[ff:])]
    return None


_register("GPTRefactForCausalLM", ArchSpec(
    arch="refact",
    layer_prefix="transformer.h.",
    top=[("transformer.wte.weight", "token_embd.weight"),
         ("ln_f.weight", "output_norm.weight"),
         ("lm_head.weight", "output.weight")],
    layer=[("ln_1.weight", "attn_norm.weight"),
           ("ln_2.weight", "ffn_norm.weight"),
           ("attn.q.weight", "attn_q.weight"),
           ("attn.c_proj.weight", "attn_output.weight"),
           ("mlp.linear_1.weight", "ffn_gate.weight"),
           ("mlp.linear_3.weight", "ffn_up.weight"),
           ("mlp.c_proj.weight", "ffn_down.weight")],
    derive=_refact_derive,
    transform=_refact_transform,
))


def _plamo_derive(hf, d):
    # plamo-13b's config.json carries a wrong num_key_value_heads; the
    # reference hardcodes 5 for the 40-head/5120-wide model (PlamoModel
    # set_gguf_parameters comment) — special-case that shape only.
    if d["n_embd"] == 5120 and d["n_heads"] == 40:
        d["n_kv"] = 5


def _plamo_transform(hf_name, data, hf, d, state):
    """De-interleave q heads across kv groups (PlamoModel shuffle_attn_*):
    HF head a*n_kv+b -> GGUF head b*q_per_kv+a, inverse on o_proj cols."""
    nh, nkv, hd, ne = d["n_heads"], d["n_kv"], d["head_dim"], d["n_embd"]
    qpk = nh // nkv
    idx = hf_name.split(".")[3] if hf_name.count(".") > 3 else "?"
    if hf_name.endswith("self_attn.q_proj.weight"):
        q = (data.reshape(qpk, nkv, hd, ne).transpose(1, 0, 2, 3)
             .reshape(nh * hd, ne))
        return [(f"blk.{idx}.attn_q.weight", q)]
    if hf_name.endswith("self_attn.o_proj.weight"):
        o = (data.reshape(ne, qpk, nkv, hd).transpose(0, 2, 1, 3)
             .reshape(ne, nh * hd))
        return [(f"blk.{idx}.attn_output.weight", o)]
    return None


_register("PlamoForCausalLM", ArchSpec(
    arch="plamo",
    layer_prefix="model.layers.layers.",
    top=[("model.embed_tokens.weight", "token_embd.weight"),
         ("model.norm.weight", "output_norm.weight"),
         ("lm_head.weight", "output.weight")],
    layer=[("norm.weight", "attn_norm.weight"),  # shared attn+ffn norm
           ("self_attn.k_proj.weight", "attn_k.weight"),
           ("self_attn.v_proj.weight", "attn_v.weight"),
           ("mlp.gate_proj.weight", "ffn_gate.weight"),
           ("mlp.up_proj.weight", "ffn_up.weight"),
           ("mlp.down_proj.weight", "ffn_down.weight")],
    derive=_plamo_derive,
    transform=_plamo_transform,
))


def _codeshell_derive(hf, d):
    d["n_ff"] = int(hf.get("n_inner") or 0) or 4 * d["n_embd"]


def _codeshell_transform(hf_name, data, hf, d, state):
    if hf_name == "transformer.wte.weight":
        state["embd"] = data
        return [("token_embd.weight", data)]
    if hf_name in ("lm_head.weight", "output.weight"):
        state["has_output"] = True
        return [("output.weight", data)]
    return None


def _codeshell_finish(hf, d, state):
    # tied output head: reference copies tok_embd into output.weight when
    # the checkpoint ships neither lm_head nor output (CodeShellModel)
    if not state.get("has_output") and "embd" in state:
        yield ("output.weight", state["embd"])


_register("CodeShellForCausalLM", ArchSpec(
    arch="codeshell",
    layer_prefix="transformer.h.",
    eps_key="ln",
    top=[("transformer.ln_f.weight", "output_norm.weight"),
         ("transformer.ln_f.bias", "output_norm.bias")],
    layer=[("ln_1.weight", "attn_norm.weight"),
           ("ln_1.bias", "attn_norm.bias"),
           ("attn.c_attn.weight", "attn_qkv.weight"),
           ("attn.c_attn.bias", "attn_qkv.bias"),
           ("attn.c_proj.weight", "attn_output.weight"),
           ("attn.c_proj.bias", "attn_output.bias"),
           ("ln_2.weight", "ffn_norm.weight"),
           ("ln_2.bias", "ffn_norm.bias"),
           ("mlp.c_fc.weight", "ffn_up.weight"),
           ("mlp.c_fc.bias", "ffn_up.bias"),
           ("mlp.c_proj.weight", "ffn_down.weight"),
           ("mlp.c_proj.bias", "ffn_down.bias")],
    derive=_codeshell_derive,
    transform=_codeshell_transform,
    finish=_codeshell_finish,
))


def _jais_transform(hf_name, data, hf, d, state):
    """gpt2-style Conv1D weights are stored (in, out): transpose the four
    projection weights; scale wte/output by the muP factors (JaisModel)."""
    if hf_name.endswith((".attn.bias", ".attn.masked_bias",
                         "relative_pe.slopes")):
        return []  # causal-mask buffers / precomputed ALiBi slopes
    emb_scale = float(hf.get("mup_embeddings_scale")
                      or hf.get("embeddings_scale") or 1.0)
    width = 1.0
    if hf.get("mup_output_alpha") is not None:
        width = float(hf["mup_output_alpha"]) * float(hf["mup_width_scale"])
    elif hf.get("width_scale") is not None:
        width = float(hf["width_scale"])
    if hf_name == "transformer.wte.weight":
        outs = [("token_embd.weight", data * emb_scale)]
        if hf.get("mup_embeddings_scale") is not None:
            # mup flavors tie the output head to wte, scaled differently
            outs.append(("output.weight", data * width))
        return outs
    if hf_name == "lm_head.weight":
        return [("output.weight", data * width)]
    if hf_name.endswith((".attn.c_attn.weight", ".attn.c_proj.weight",
                         ".mlp.c_fc.weight", ".mlp.c_fc2.weight",
                         ".mlp.c_proj.weight")):
        idx = hf_name.split(".")[2]
        suffix = {"c_attn": "attn_qkv.weight", "c_fc": "ffn_up.weight",
                  "c_fc2": "ffn_gate.weight"}.get(hf_name.split(".")[-2])
        if suffix is None:
            suffix = ("attn_output.weight" if ".attn." in hf_name
                      else "ffn_down.weight")
        return [(f"blk.{idx}.{suffix}", np.ascontiguousarray(data.T))]
    return None


_register("JAISLMHeadModel", ArchSpec(
    arch="jais",
    layer_prefix="transformer.h.",
    eps_key="ln",
    top=[("transformer.ln_f.weight", "output_norm.weight"),
         ("transformer.ln_f.bias", "output_norm.bias")],
    layer=[("ln_1.weight", "attn_norm.weight"),
           ("ln_1.bias", "attn_norm.bias"),
           ("attn.c_attn.bias", "attn_qkv.bias"),
           ("attn.c_proj.bias", "attn_output.bias"),
           ("ln_2.weight", "ffn_norm.weight"),
           ("ln_2.bias", "ffn_norm.bias"),
           ("mlp.c_fc.bias", "ffn_up.bias"),
           ("mlp.c_fc2.bias", "ffn_gate.bias"),
           ("mlp.c_proj.bias", "ffn_down.bias")],
    transform=_jais_transform,
    # all public JAIS checkpoints precompute slopes for max_alibi_bias=8
    # (the runtime hardcodes 8.0 too, models/config.py jais branch)
    kv=lambda w, hf, d: w.add_kv("jais.attention.max_alibi_bias", 8.0),
))


def _chatglm_derive(hf, d):
    # generic-block inputs that chatglm spells differently: rope base is
    # 10000*rope_ratio, rotary dim is half the head dim (ChatGLMModel
    # writes 64 for the 128-wide heads), vocab may only be padded_
    hf.setdefault("rope_theta", 10000.0 * float(hf.get("rope_ratio", 1.0)))
    hf.setdefault("partial_rotary_factor", 0.5)
    if hf.get("padded_vocab_size") and not hf.get("vocab_size"):
        hf["vocab_size"] = hf["padded_vocab_size"]


_register(["ChatGLMModel", "ChatGLMForConditionalGeneration"], ArchSpec(
    arch="chatglm",
    layer_prefix="transformer.encoder.layers.",
    top=[("transformer.embedding.word_embeddings.weight",
          "token_embd.weight"),
         ("transformer.encoder.final_layernorm.weight",
          "output_norm.weight"),
         ("transformer.output_layer.weight", "output.weight")],
    layer=[("input_layernorm.weight", "attn_norm.weight"),
           ("self_attention.query_key_value.weight", "attn_qkv.weight"),
           ("self_attention.query_key_value.bias", "attn_qkv.bias"),
           ("self_attention.dense.weight", "attn_output.weight"),
           ("post_attention_layernorm.weight", "ffn_norm.weight"),
           # dense_h_to_4h holds [gate|up]; the runtime splits it
           # (LLM_FFN_SWIGLU, build_chatglm)
           ("mlp.dense_h_to_4h.weight", "ffn_up.weight"),
           ("mlp.dense_4h_to_h.weight", "ffn_down.weight")],
    derive=_chatglm_derive,
))


def _chameleon_qk_norm(data, hd):
    """Per-head norm params: reference takes head 0, un-interleaves the
    rotary halves, and replicates across heads (ChameleonModel
    _reverse_hf_permute) — we emit the shared (hd,) row the runtime
    broadcasts over heads."""
    row = np.asarray(data).reshape(-1, hd)[0]
    return np.ascontiguousarray(row.reshape(2, hd // 2).T.reshape(-1))


def _chameleon_transform(hf_name, data, hf, d, state):
    if hf_name.startswith("model.vqmodel"):
        return []  # image tokenizer: not converted (reference skips too)
    base = _llama_permute_transform(hf_name, data, hf, d, state)
    if base is not None:
        return base
    for part, gg in (("q_norm", "attn_q_norm"), ("k_norm", "attn_k_norm")):
        for kind in ("weight", "bias"):
            if hf_name.endswith(f"self_attn.{part}.{kind}"):
                idx = hf_name.split(".")[2]
                return [(f"blk.{idx}.{gg}.{kind}",
                         _chameleon_qk_norm(data, d["head_dim"]))]
    return None


_register("ChameleonForCausalLM", ArchSpec(
    arch="chameleon",
    top=_LLAMA_TOP, layer=_LLAMA_LAYER,
    transform=_chameleon_transform,
    kv=lambda w, hf, d: w.add_kv("chameleon.swin_norm",
                                 bool(hf.get("swin_norm", False))),
))


_register("ExaoneForCausalLM", ArchSpec(
    arch="exaone",
    top=[("transformer.wte.weight", "token_embd.weight"),
         ("transformer.ln_f.weight", "output_norm.weight"),
         ("lm_head.weight", "output.weight")],
    layer_prefix="transformer.h.",
    layer=[("ln_1.weight", "attn_norm.weight"),
           ("attn.attention.q_proj.weight", "attn_q.weight"),
           ("attn.attention.k_proj.weight", "attn_k.weight"),
           ("attn.attention.v_proj.weight", "attn_v.weight"),
           ("attn.attention.out_proj.weight", "attn_output.weight"),
           ("ln_2.weight", "ffn_norm.weight"),
           ("mlp.c_fc_0.weight", "ffn_gate.weight"),
           ("mlp.c_fc_1.weight", "ffn_up.weight"),
           ("mlp.c_proj.weight", "ffn_down.weight")],
))


# ---------------------------------------------------------------------------
# batch 3: minicpm3 / openelm / bitnet / grok / arctic / rwkv6
# (reference converter classes MiniCPM3Model @1870, OpenELMModel @3144,
#  BitnetModel @1663, GrokModel @1704, ArcticModel @3219, Rwkv6Model @2835
#  in convert_hf_to_gguf.py)


_MCPM3_LAYER = [
    ("input_layernorm.weight", "attn_norm.weight"),
    ("post_attention_layernorm.weight", "ffn_norm.weight"),
    ("self_attn.q_a_proj.weight", "attn_q_a.weight"),
    ("self_attn.q_a_layernorm.weight", "attn_q_a_norm.weight"),
    ("self_attn.q_b_proj.weight", "attn_q_b.weight"),
    ("self_attn.kv_a_proj_with_mqa.weight", "attn_kv_a_mqa.weight"),
    ("self_attn.kv_a_layernorm.weight", "attn_kv_a_norm.weight"),
    ("self_attn.kv_b_proj.weight", "attn_kv_b.weight"),
    ("self_attn.o_proj.weight", "attn_output.weight"),
    ("mlp.gate_proj.weight", "ffn_gate.weight"),
    ("mlp.up_proj.weight", "ffn_up.weight"),
    ("mlp.down_proj.weight", "ffn_down.weight"),
]


def _minicpm3_kv(w, hf, d):
    """MLA geometry + minicpm scale knobs (MiniCPM3Model
    set_gguf_parameters; loaded by DeepseekV2Config.from_gguf)."""
    arch = "minicpm3"
    w.add_kv(f"{arch}.block_count", d["n_layers"])
    w.add_kv(f"{arch}.embedding_length", d["n_embd"])
    w.add_kv(f"{arch}.feed_forward_length", d["n_ff"])
    w.add_kv(f"{arch}.attention.head_count", d["n_heads"])
    w.add_kv(f"{arch}.attention.head_count_kv", d["n_kv"])
    w.add_kv(f"{arch}.context_length", d["n_ctx"])
    w.add_kv(f"{arch}.attention.layer_norm_rms_epsilon",
             float(hf.get("rms_norm_eps", 1e-6)))
    w.add_kv(f"{arch}.vocab_size", int(hf["vocab_size"]))
    if hf.get("q_lora_rank"):
        w.add_kv(f"{arch}.attention.q_lora_rank", int(hf["q_lora_rank"]))
    w.add_kv(f"{arch}.attention.kv_lora_rank", int(hf["kv_lora_rank"]))
    w.add_kv(f"{arch}.attention.key_length",
             int(hf["qk_nope_head_dim"]) + int(hf["qk_rope_head_dim"]))
    w.add_kv(f"{arch}.attention.value_length",
             int(hf.get("v_head_dim") or d["n_embd"] // d["n_heads"]))
    w.add_kv(f"{arch}.rope.dimension_count", int(hf["qk_rope_head_dim"]))
    w.add_kv(f"{arch}.rope.freq_base", float(hf.get("rope_theta", 10000.0)))
    # the runtime defaults these to the reference's hardcoded values
    # (build_minicpm3 @14016-14023) but newer configs carry them
    if hf.get("scale_emb"):
        w.add_kv(f"{arch}.embedding_scale", float(hf["scale_emb"]))
    if hf.get("scale_depth"):
        w.add_kv(f"{arch}.residual_scale",
                 float(hf["scale_depth"]) / d["n_layers"] ** 0.5)
    if hf.get("dim_model_base"):
        w.add_kv(f"{arch}.logit_scale",
                 float(hf["dim_model_base"]) / d["n_embd"])


def _minicpm3_finish(hf, d, state):
    """LongRoPE per-dim frequency factors -> model-level tensors
    (MiniCPM3Model generate_extra_tensors)."""
    rs = hf.get("rope_scaling") or {}
    lf, sf = rs.get("long_factor"), rs.get("short_factor")
    if lf is None or sf is None:
        return
    rope_dims = int(hf["qk_rope_head_dim"])
    if len(lf) != len(sf) or 2 * len(lf) != rope_dims:
        raise ValueError(
            f"rope long/short factors must have length {rope_dims // 2}")
    yield ("rope_factors_long.weight", np.asarray(lf, np.float32))
    yield ("rope_factors_short.weight", np.asarray(sf, np.float32))


_register("MiniCPM3ForCausalLM", ArchSpec(
    arch="minicpm3",
    generic_kv=False,
    top=_LLAMA_TOP,
    layer=_MCPM3_LAYER,
    kv=_minicpm3_kv,
    finish=_minicpm3_finish,
))


def _openelm_make_divisible(v, divisor: int) -> int:
    """OpenELM's rounded FFN width (OpenELMModel._make_divisible)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _openelm_ffn_dims(hf: dict) -> list[int]:
    return [_openelm_make_divisible(m * int(hf["model_dim"]),
                                    int(hf["ffn_dim_divisor"]))
            for m in hf["ffn_multipliers"]]


def _openelm_derive(hf, d):
    d["n_layers"] = int(hf["num_transformer_layers"])
    d["n_embd"] = int(hf["model_dim"])
    d["head_dim"] = int(hf["head_dim"])


def _openelm_kv(w, hf, d):
    """Array-valued per-layer widths (OpenELMModel set_gguf_parameters;
    read back via ModelConfig's scalar_or_arr)."""
    arch = "openelm"
    w.add_kv(f"{arch}.block_count", d["n_layers"])
    w.add_kv(f"{arch}.context_length", int(hf["max_context_length"]))
    w.add_kv(f"{arch}.embedding_length", d["n_embd"])
    w.add_kv(f"{arch}.feed_forward_length", _openelm_ffn_dims(hf))
    w.add_kv(f"{arch}.attention.head_count",
             [int(x) for x in hf["num_query_heads"]])
    w.add_kv(f"{arch}.attention.head_count_kv",
             [int(x) for x in hf["num_kv_heads"]])
    w.add_kv(f"{arch}.rope.freq_base", float(hf["rope_freq_constant"]))
    # hardcoded in modeling_openelm.py, absent from config.json
    w.add_kv(f"{arch}.attention.layer_norm_rms_epsilon", 1e-6)
    w.add_kv(f"{arch}.rope.dimension_count", d["head_dim"])
    w.add_kv(f"{arch}.attention.key_length", d["head_dim"])
    w.add_kv(f"{arch}.attention.value_length", d["head_dim"])
    if hf.get("vocab_size"):
        w.add_kv(f"{arch}.vocab_size", int(hf["vocab_size"]))


def _openelm_transform(hf_name, data, hf, d, state):
    """Split the fused gate|up projection at the per-layer FFN width
    (OpenELMModel modify_tensors)."""
    if hf_name.endswith("ffn.proj_1.weight"):
        idx = int(hf_name.split(".")[2])
        ff = _openelm_ffn_dims(hf)[idx]
        return [(f"blk.{idx}.ffn_gate.weight", data[:ff]),
                (f"blk.{idx}.ffn_up.weight", data[ff:])]
    return None


_register("OpenELMForCausalLM", ArchSpec(
    arch="openelm",
    generic_kv=False,
    layer_prefix="transformer.layers.",
    top=[("transformer.token_embeddings.weight", "token_embd.weight"),
         ("transformer.norm.weight", "output_norm.weight")],
    layer=[("attn_norm.weight", "attn_norm.weight"),
           ("attn.qkv_proj.weight", "attn_qkv.weight"),
           ("attn.q_norm.weight", "attn_q_norm.weight"),
           ("attn.k_norm.weight", "attn_k_norm.weight"),
           ("attn.out_proj.weight", "attn_output.weight"),
           ("ffn_norm.weight", "ffn_norm.weight"),
           ("ffn.proj_2.weight", "ffn_down.weight")],
    derive=_openelm_derive,
    kv=_openelm_kv,
    transform=_openelm_transform,
))


def _bitnet_weight_quant(w: np.ndarray) -> np.ndarray:
    """Ternarize to {-1,0,+1}*scale with the abs-mean scale (BitnetModel
    weight_quant — the b1.58 quantization, scale baked into the weight)."""
    x = w.astype(np.float64)
    scale = max(float(np.abs(x).mean()), 1e-5)
    return (np.clip(np.round(x / scale), -1, 1) * scale).astype(np.float32)


_BITNET_PROJ = ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                "self_attn.v_proj.weight", "self_attn.o_proj.weight",
                "mlp.gate_proj.weight", "mlp.up_proj.weight",
                "mlp.down_proj.weight")


def _bitnet_transform(hf_name, data, hf, d, state):
    if hf_name.endswith(_BITNET_PROJ):
        name = _rename(_SPECS["BitnetForCausalLM"], hf_name)
        return [(name, _bitnet_weight_quant(data))]
    return None


_register(["BitnetForCausalLM", "BitNetForCausalLM"], ArchSpec(
    arch="bitnet",
    top=_LLAMA_TOP,
    layer=_LLAMA_LAYER + [
        # RMS sub-norms before wo / ffn_down (loader LLM_ARCH_BITNET case)
        ("self_attn.inner_attn_ln.weight", "attn_sub_norm.weight"),
        ("mlp.ffn_layernorm.weight", "ffn_sub_norm.weight"),
    ],
    transform=_bitnet_transform,
    # BitnetModel pins rope_scaling to linear/1.0
    kv=lambda w, hf, d: [
        w.add_kv("bitnet.rope.scaling.type", "linear"),
        w.add_kv("bitnet.rope.scaling.factor", 1.0),
    ] and None,
))


def _grok_transform(hf_name, data, hf, d, state):
    """Buffer per-expert MoE weights; merged in finish (GrokModel
    modify_tensors merges once all num_local_experts arrive — here the
    buffered dict makes order irrelevant)."""
    if ".moe." in hf_name:
        parts = hf_name.split(".")  # transformer.decoder_layer.L.moe.X.w.weight
        li, xi, wname = int(parts[2]), int(parts[4]), parts[5]
        state.setdefault(li, {}).setdefault(wname, {})[xi] = data
        return []
    return None


def _grok_finish(hf, d, state):
    gg = {"linear": "ffn_gate_exps", "linear_1": "ffn_down_exps",
          "linear_v": "ffn_up_exps"}
    for li in sorted(k for k in state if isinstance(k, int)):
        for wname, exps in sorted(state[li].items()):
            stacked = np.stack([exps[x] for x in sorted(exps)])
            yield (f"blk.{li}.{gg[wname]}.weight", stacked,
                   tuple(reversed(stacked.shape)))


_register(["GrokForCausalLM", "Grok1ForCausalLM"], ArchSpec(
    arch="grok",
    layer_prefix="transformer.decoder_layer.",
    top=[("transformer.in_out_embed.weight", "token_embd.weight"),
         ("transformer.rms_norm.weight", "output_norm.weight"),
         ("lm_head.weight", "output.weight")],
    layer=[("rms_norm.weight", "attn_norm.weight"),
           ("rms_norm_1.weight", "attn_out_norm.weight"),
           ("rms_norm_2.weight", "ffn_norm.weight"),
           ("rms_norm_3.weight", "layer_out_norm.weight"),
           ("multi_head_attention.query.weight", "attn_q.weight"),
           ("multi_head_attention.key.weight", "attn_k.weight"),
           ("multi_head_attention.value.weight", "attn_v.weight"),
           ("multi_head_attention.linear.weight", "attn_output.weight"),
           ("router.weight", "ffn_gate_inp.weight")],
    transform=_grok_transform,
    finish=_grok_finish,
    kv=lambda w, hf, d: [
        w.add_kv("grok.expert_count", int(hf.get("num_local_experts", 8))),
        w.add_kv("grok.expert_used_count",
                 int(hf.get("num_experts_per_tok", 2))),
    ] and None,
))


def _arctic_transform(hf_name, data, hf, d, state):
    """q/k permute + per-expert buffering (ArcticModel modify_tensors)."""
    base = _llama_permute_transform(hf_name, data, hf, d, state)
    if base is not None:
        return base
    if ".block_sparse_moe.experts." in hf_name:
        parts = hf_name.split(".")  # model.layers.L.block_sparse_moe.experts.X.wN.weight
        li, xi, wname = int(parts[2]), int(parts[5]), parts[6]
        state.setdefault(li, {}).setdefault(wname, {})[xi] = data
        return []
    return None


def _arctic_finish(hf, d, state):
    gg = {"w1": "ffn_gate_exps", "w2": "ffn_down_exps", "w3": "ffn_up_exps"}
    for li in sorted(k for k in state if isinstance(k, int)):
        for wname, exps in sorted(state[li].items()):
            stacked = np.stack([exps[x] for x in sorted(exps)])
            yield (f"blk.{li}.{gg[wname]}.weight", stacked,
                   tuple(reversed(stacked.shape)))


_register("ArcticForCausalLM", ArchSpec(
    arch="arctic",
    top=_LLAMA_TOP,
    layer=[("input_layernorm.weight", "attn_norm.weight"),
           ("self_attn.v_proj.weight", "attn_v.weight"),
           ("self_attn.o_proj.weight", "attn_output.weight"),
           # arctic renames: residual_layernorm norms the DENSE ffn branch,
           # post_attention_layernorm norms the parallel MoE branch off the
           # layer input (arch_block_mappings_cfg[MODEL_ARCH.ARCTIC])
           ("residual_layernorm.weight", "ffn_norm.weight"),
           ("post_attention_layernorm.weight", "ffn_norm_exps.weight"),
           ("residual_mlp.w1.weight", "ffn_gate.weight"),
           ("residual_mlp.w3.weight", "ffn_up.weight"),
           ("residual_mlp.w2.weight", "ffn_down.weight"),
           ("block_sparse_moe.gate.weight", "ffn_gate_inp.weight")],
    transform=_arctic_transform,
    finish=_arctic_finish,
    kv=lambda w, hf, d: [
        w.add_kv("arctic.expert_count", int(hf.get("num_local_experts", 0))),
        w.add_kv("arctic.expert_used_count",
                 int(hf.get("num_experts_per_tok", 1))),
    ] and None,
))


def _rwkv6_kv(w, hf, d):
    """RWKV6 geometry (Rwkv6Model set_gguf_parameters; read back by
    Rwkv6Config.from_gguf)."""
    arch = "rwkv6"
    n_embd = int(hf["hidden_size"])
    n_ff = int(hf.get("intermediate_size")
               or (int(n_embd * 3.5) // 32) * 32)
    w.add_kv(f"{arch}.block_count", int(hf["num_hidden_layers"]))
    w.add_kv(f"{arch}.embedding_length", n_embd)
    w.add_kv(f"{arch}.feed_forward_length", n_ff)
    w.add_kv(f"{arch}.context_length", 1048576)  # "RWKV isn't ctx limited"
    w.add_kv(f"{arch}.attention.layer_norm_epsilon",
             float(hf.get("layer_norm_epsilon", 1e-5)))
    w.add_kv(f"{arch}.rescale_every_n_layers", int(hf.get("rescale_every", 0)))
    w.add_kv(f"{arch}.wkv.head_size", int(hf["head_size"]))
    w.add_kv(f"{arch}.time_mix_extra_dim", 64 if n_embd == 4096 else 32)
    w.add_kv(f"{arch}.time_decay_extra_dim", 128 if n_embd == 4096 else 64)
    w.add_kv(f"{arch}.vocab_size", int(hf.get("vocab_size", 65536)))


def _rwkv6_vocab(w, src_dir: str, hf: dict) -> None:
    """RWKV world vocabulary from rwkv_vocab_v20230424.txt: line format
    `<id> <python-literal-token> <byte-len>`; GGUF stores the repr-escaped
    byte string (Rwkv6Model set_vocab; decoded back by rwkv_unescape)."""
    import ast

    path = os.path.join(src_dir, "rwkv_vocab_v20230424.txt")
    vocab_size = int(hf.get("vocab_size", 65536))
    tokens = ["<s>"]
    types = [3]  # CONTROL
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split(" ")
            tok = ast.literal_eval(" ".join(parts[1:-1]))
            b = tok.encode("utf-8") if isinstance(tok, str) else tok
            assert isinstance(b, bytes) and len(b) == int(parts[-1])
            tokens.append(repr(b)[2:-1])  # "b'\\xff'" -> "\\xff"
            types.append(1)  # NORMAL
    while len(tokens) < vocab_size:
        tokens.append(f"[PAD{len(tokens)}]")
        types.append(5)  # UNUSED
    w.add_kv("tokenizer.ggml.model", "rwkv")
    w.add_kv("tokenizer.ggml.tokens", tokens)
    w.add_kv("tokenizer.ggml.token_type", types)


_RWKV6_ATT = [
    ("time_maa_x", "time_mix_lerp_x"), ("time_maa_w", "time_mix_lerp_w"),
    ("time_maa_k", "time_mix_lerp_k"), ("time_maa_v", "time_mix_lerp_v"),
    ("time_maa_r", "time_mix_lerp_r"), ("time_maa_g", "time_mix_lerp_g"),
    ("time_maa_w1", "time_mix_w1"), ("time_maa_w2", "time_mix_w2"),
    ("time_faaaa", "time_mix_first"), ("time_decay", "time_mix_decay"),
    ("time_decay_w1", "time_mix_decay_w1"),
    ("time_decay_w2", "time_mix_decay_w2"),
    ("key.weight", "time_mix_key"), ("value.weight", "time_mix_value"),
    ("receptance.weight", "time_mix_receptance"),
    ("gate.weight", "time_mix_gate"), ("output.weight", "time_mix_output"),
    ("ln_x.weight", "time_mix_ln.weight"), ("ln_x.bias", "time_mix_ln.bias"),
]
_RWKV6_FFN = [
    ("time_maa_k", "channel_mix_lerp_k"), ("time_maa_r", "channel_mix_lerp_r"),
    ("key.weight", "channel_mix_key"), ("value.weight", "channel_mix_value"),
    ("receptance.weight", "channel_mix_receptance"),
]


def _rwkv6_transform(hf_name, data, hf, d, state):
    """HF `rwkv.blocks.*` names -> GGUF time/channel-mix tensors with the
    reference's transposes and the rescale_every division baked in
    (Rwkv6Model modify_tensors)."""
    top = {"rwkv.embeddings.weight": "token_embd.weight",
           "rwkv.blocks.0.pre_ln.weight": "token_embd_norm.weight",
           "rwkv.blocks.0.pre_ln.bias": "token_embd_norm.bias",
           "rwkv.ln_out.weight": "output_norm.weight",
           "rwkv.ln_out.bias": "output_norm.bias",
           "head.weight": "output.weight"}
    if hf_name in top:
        return [(top[hf_name], data)]
    if not hf_name.startswith("rwkv.blocks."):
        return []
    rest = hf_name[len("rwkv.blocks."):]
    idx, _, rest = rest.partition(".")
    bid = int(idx)
    if rest in ("ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias"):
        # ln2 (the channel-mix norm) is GGUF attn_norm_2 (tensor_mapping
        # ATTN_NORM_2), not ffn_norm
        kind = "attn_norm" if rest.startswith("ln1") else "attn_norm_2"
        return [(f"blk.{bid}.{kind}.{rest.split('.')[1]}", data)]
    table, part = (_RWKV6_ATT, rest[len("attention."):]) \
        if rest.startswith("attention.") \
        else (_RWKV6_FFN, rest[len("feed_forward."):]) \
        if rest.startswith("feed_forward.") else (None, None)
    if table is None:
        return []
    for src, dst in table:
        if part != src:
            continue
        name = f"blk.{bid}.{dst}"
        if not name.endswith((".weight", ".bias")):
            name += ".weight"
        if dst in ("time_mix_w1", "time_mix_decay_w1", "time_mix_decay_w2"):
            data = np.ascontiguousarray(data.T)
        elif dst == "time_mix_w2":
            data = np.ascontiguousarray(data.transpose(0, 2, 1))
        rescale = int(hf.get("rescale_every", 0) or 0)
        if rescale > 0 and dst in ("time_mix_output", "channel_mix_value"):
            data = data / (2 ** (bid // rescale))
        return [(name, data, tuple(reversed(data.shape)))]
    return []


_register("Rwkv6ForCausalLM", ArchSpec(
    arch="rwkv6",
    generic_kv=False,
    kv=_rwkv6_kv,
    vocab=_rwkv6_vocab,
    transform=_rwkv6_transform,
))
