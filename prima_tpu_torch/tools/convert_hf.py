"""prima-convert — HuggingFace -> GGUF converter (llama / qwen2 families).

The analogue of the reference's convert_hf_to_gguf.py (L6 tooling): reads a
HF checkpoint directory (safetensors or torch .bin), maps tensor names to
GGUF convention, writes metadata + tokenizer, quantizing weights to the
requested ftype with our own quantizer.

Supported architectures: LlamaForCausalLM, MistralForCausalLM,
Qwen2ForCausalLM (the distributed runtime's families, reference
src/llama.cpp:17003) plus GemmaForCausalLM, Gemma2ForCausalLM,
Phi3ForCausalLM and MixtralForCausalLM (single-node families).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.writer import GGUFWriter
from .quantize import FTYPES, _encode, _target_type_simple

# HF name -> GGUF name (llama/qwen2 share the mapping)
_MAP = [
    ("model.embed_tokens.weight", "token_embd.weight"),
    ("model.norm.weight", "output_norm.weight"),
    ("model.norm.bias", "output_norm.bias"),
    ("model.final_layernorm.weight", "output_norm.weight"),  # phi2
    ("model.final_layernorm.bias", "output_norm.bias"),
    ("lm_head.weight", "output.weight"),
    ("lm_head.bias", "output.bias"),
]
_LAYER_MAP = [
    ("input_layernorm.weight", "attn_norm.weight"),
    ("self_attn.q_proj.weight", "attn_q.weight"),
    ("self_attn.k_proj.weight", "attn_k.weight"),
    ("self_attn.v_proj.weight", "attn_v.weight"),
    ("self_attn.o_proj.weight", "attn_output.weight"),
    ("self_attn.q_proj.bias", "attn_q.bias"),
    ("self_attn.k_proj.bias", "attn_k.bias"),
    ("self_attn.v_proj.bias", "attn_v.bias"),
    ("self_attn.qkv_proj.weight", "attn_qkv.weight"),  # phi3 fused
    ("post_attention_layernorm.weight", "ffn_norm.weight"),
    ("mlp.gate_proj.weight", "ffn_gate.weight"),
    ("mlp.up_proj.weight", "ffn_up.weight"),
    ("mlp.down_proj.weight", "ffn_down.weight"),
    ("mlp.gate_up_proj.weight", "ffn_up.weight"),  # phi3 fused gate+up
    ("block_sparse_moe.gate.weight", "ffn_gate_inp.weight"),  # mixtral
    ("mlp.gate.weight", "ffn_gate_inp.weight"),  # qwen2moe/olmoe router
    ("self_attn.q_norm.weight", "attn_q_norm.weight"),  # olmoe
    ("self_attn.k_norm.weight", "attn_k_norm.weight"),
    ("mlp.shared_expert_gate.weight", "ffn_gate_inp_shexp.weight"),
    ("mlp.shared_expert.gate_proj.weight", "ffn_gate_shexp.weight"),
    ("mlp.shared_expert.up_proj.weight", "ffn_up_shexp.weight"),
    ("mlp.shared_expert.down_proj.weight", "ffn_down_shexp.weight"),
    # starcoder2: biased projections, LayerNorm biases, c_fc/c_proj MLP
    ("self_attn.o_proj.bias", "attn_output.bias"),
    ("input_layernorm.bias", "attn_norm.bias"),
    ("post_attention_layernorm.bias", "ffn_norm.bias"),
    ("mlp.c_fc.weight", "ffn_up.weight"),
    ("mlp.c_fc.bias", "ffn_up.bias"),
    ("mlp.c_proj.weight", "ffn_down.weight"),
    ("mlp.c_proj.bias", "ffn_down.bias"),
    # phi2: self_attn.dense output proj, fc1/fc2 MLP
    ("self_attn.dense.weight", "attn_output.weight"),
    ("self_attn.dense.bias", "attn_output.bias"),
    ("mlp.fc1.weight", "ffn_up.weight"),
    ("mlp.fc1.bias", "ffn_up.bias"),
    ("mlp.fc2.weight", "ffn_down.weight"),
    ("mlp.fc2.bias", "ffn_down.bias"),
]
# gemma2 has four norms per layer with different GGUF names
_GEMMA2_LAYER_MAP = [
    ("input_layernorm.weight", "attn_norm.weight"),
    ("post_attention_layernorm.weight", "post_attention_norm.weight"),
    ("pre_feedforward_layernorm.weight", "ffn_norm.weight"),
    ("post_feedforward_layernorm.weight", "post_ffw_norm.weight"),
]


def _iter_hf_tensors(path: str):
    """Yields (name, np.ndarray f32) from safetensors or torch bins."""
    st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if st_files:
        from safetensors import safe_open

        for f in st_files:
            with safe_open(os.path.join(path, f), framework="np") as s:
                for name in s.keys():
                    t = s.get_tensor(name)
                    if t.dtype != np.float32:
                        t = t.astype(np.float32)
                    yield name, t
        return
    import torch

    bins = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
    for f in bins:
        sd = torch.load(os.path.join(path, f), map_location="cpu", weights_only=True)
        for name, t in sd.items():
            yield name, t.float().numpy()


def _gguf_name(hf_name: str, arch: str = "llama") -> str | None:
    for src, dst in _MAP:
        if hf_name == src:
            return dst
    if hf_name.startswith("model.layers."):
        _, _, idx, rest = hf_name.split(".", 3)
        if arch == "gemma2":
            for src, dst in _GEMMA2_LAYER_MAP:
                if rest == src:
                    return f"blk.{idx}.{dst}"
        for src, dst in _LAYER_MAP:
            if rest == src:
                return f"blk.{idx}.{dst}"
    return None


def _permute_qk(w: np.ndarray, n_heads: int) -> np.ndarray:
    """HF stores q/k in interleaved rotary order; GGUF uses the 'norm'
    (adjacent-pair) order — the same permutation convert_hf_to_gguf applies
    for LlamaForCausalLM."""
    rows, k = w.shape
    hd = rows // n_heads
    return (w.reshape(n_heads, 2, hd // 2, k)
            .transpose(0, 2, 1, 3)
            .reshape(rows, k))


_BERT_MAP = [
    ("embeddings.word_embeddings.weight", "token_embd.weight"),
    ("embeddings.token_type_embeddings.weight", "token_types.weight"),
    ("embeddings.position_embeddings.weight", "position_embd.weight"),
    ("embeddings.LayerNorm.weight", "token_embd_norm.weight"),
    ("embeddings.LayerNorm.bias", "token_embd_norm.bias"),
    # reranker classification head (BertForSequenceClassification: the
    # pooler dense -> tanh -> classifier; GGUF LLM_TENSOR_CLS / CLS_OUT)
    ("pooler.dense.weight", "cls.weight"),
    ("pooler.dense.bias", "cls.bias"),
    ("classifier.weight", "cls.output.weight"),
    ("classifier.bias", "cls.output.bias"),
]
_BERT_LAYER_MAP = [
    ("attention.self.query.weight", "attn_q.weight"),
    ("attention.self.query.bias", "attn_q.bias"),
    ("attention.self.key.weight", "attn_k.weight"),
    ("attention.self.key.bias", "attn_k.bias"),
    ("attention.self.value.weight", "attn_v.weight"),
    ("attention.self.value.bias", "attn_v.bias"),
    ("attention.output.dense.weight", "attn_output.weight"),
    ("attention.output.dense.bias", "attn_output.bias"),
    ("attention.output.LayerNorm.weight", "attn_output_norm.weight"),
    ("attention.output.LayerNorm.bias", "attn_output_norm.bias"),
    ("intermediate.dense.weight", "ffn_up.weight"),
    ("intermediate.dense.bias", "ffn_up.bias"),
    ("output.dense.weight", "ffn_down.weight"),
    ("output.dense.bias", "ffn_down.bias"),
    ("output.LayerNorm.weight", "layer_output_norm.weight"),
    ("output.LayerNorm.bias", "layer_output_norm.bias"),
]


# jina-bert-v2 layer names (JinaBertV2Model; the gated_layers /
# up_gated_layer splits are handled in _convert_bert itself)
_JINA_LAYER_MAP = [
    ("mlp.wo.weight", "ffn_down.weight"),
    ("mlp.wo.bias", "ffn_down.bias"),
    ("mlp.down_layer.weight", "ffn_down.weight"),
    ("mlp.down_layer.bias", "ffn_down.bias"),
    ("mlp.layernorm.weight", "layer_output_norm.weight"),
    ("mlp.layernorm.bias", "layer_output_norm.bias"),
    ("layer_norm_2.weight", "layer_output_norm.weight"),   # jina-v2-code
    ("layer_norm_2.bias", "layer_output_norm.bias"),
    ("layer_norm_1.weight", "attn_norm_2.weight"),         # jina-v2-code
    ("layer_norm_1.bias", "attn_norm_2.bias"),
    ("attention.self.layer_norm_q.weight", "attn_q_norm.weight"),
    ("attention.self.layer_norm_q.bias", "attn_q_norm.bias"),
    ("attention.self.layer_norm_k.weight", "attn_k_norm.weight"),
    ("attention.self.layer_norm_k.bias", "attn_k_norm.bias"),
]


def _bert_gguf_name(hf_name: str) -> str | None:
    if hf_name.startswith("bert."):
        hf_name = hf_name[5:]
    for s, d in _BERT_MAP:
        if hf_name == s:
            return d
    if hf_name.startswith("encoder.layer."):
        _, _, idx, rest = hf_name.split(".", 3)
        for s, d in _BERT_LAYER_MAP + _JINA_LAYER_MAP:
            if rest == s:
                return f"blk.{idx}.{d}"
    return None


def _convert_bert(src_dir: str, dst_path: str, hf: dict, ftype: str,
                  logfile) -> int:
    """BertModel -> GGUF arch 'bert' (embedding models; build_bert path).
    JinaBert* checkpoints convert to arch 'jina-bert-v2' (JinaBertV2Model):
    the fused gated_layers/up_gated_layer FFN splits into ffn_gate/ffn_up
    and there are no position embeddings (bidirectional ALiBi)."""
    jina = any("JinaBert" in a for a in (hf.get("architectures") or []))
    arch = "jina-bert-v2" if jina else "bert"
    ff = int(hf["intermediate_size"])
    w = GGUFWriter(dst_path, arch=arch)
    w.add_kv("general.name", os.path.basename(os.path.normpath(src_dir)))
    w.add_kv(f"{arch}.block_count", hf["num_hidden_layers"])
    w.add_kv(f"{arch}.embedding_length", hf["hidden_size"])
    w.add_kv(f"{arch}.feed_forward_length", ff)
    w.add_kv(f"{arch}.attention.head_count", hf["num_attention_heads"])
    w.add_kv(f"{arch}.context_length", hf.get("max_position_embeddings", 512))
    w.add_kv(f"{arch}.attention.layer_norm_epsilon",
             float(hf.get("layer_norm_eps", 1e-12)))
    w.add_kv(f"{arch}.vocab_size", hf["vocab_size"])
    w.add_kv(f"{arch}.pooling_type", 1)  # mean

    _write_bert_tokenizer(w, src_dir, hf)

    def _jina_split(hf_name: str, data):
        """JinaBertV2Model.get_tensors: gated_layers rows are [w|v]
        (gate|up), up_gated_layer rows are [v|w]."""
        stripped = hf_name[5:] if hf_name.startswith("bert.") else hf_name
        if not stripped.startswith("encoder.layer."):
            return None
        _, _, idx, rest = stripped.split(".", 3)
        if rest == "mlp.gated_layers.weight":
            return [(f"blk.{idx}.ffn_gate.weight", data[:ff]),
                    (f"blk.{idx}.ffn_up.weight", data[ff:])]
        if rest == "mlp.up_gated_layer.weight":
            return [(f"blk.{idx}.ffn_up.weight", data[:ff]),
                    (f"blk.{idx}.ffn_gate.weight", data[ff:])]
        return None

    default_t, out_t = FTYPES[ftype.upper()]
    n = 0
    for hf_name, full_data in _iter_hf_tensors(src_dir):
        outs = _jina_split(hf_name, full_data) if jina else None
        if outs is None:
            name = _bert_gguf_name(hf_name)
            outs = [] if name is None else [(name, full_data)]
        for name, data in outs:
            n += _bert_emit(w, name, data, default_t, out_t, logfile, n)
    w.write()
    return n


def _bert_emit(w, name, data, default_t, out_t, logfile, n) -> int:
    """Encode + add one bert tensor; returns 1 (emitted)."""
    t = _target_type_simple(name, tuple(reversed(data.shape)), default_t, out_t)
    if name in ("token_types.weight", "position_embd.weight"):
        t = GGMLType.F32
    enc, t = _encode(data, t)
    if t in (GGMLType.F32, GGMLType.F16):
        w.add_tensor(name, enc)
    else:
        w.add_tensor(name, enc, ne=tuple(reversed(data.shape)), ggml_type=t)
    print(f"[{n + 1:4d}] {name} ({t.name})", file=logfile)
    return 1


def _write_bert_tokenizer(w: GGUFWriter, src_dir: str, hf: dict) -> None:
    """WordPiece vocabulary: '##piece' -> 'piece', word-initial -> '\u2581'+tok
    (the reference converter's BertModel mapping)."""
    tok_json = os.path.join(src_dir, "tokenizer.json")
    vocab: dict = {}
    if os.path.exists(tok_json):
        with open(tok_json, encoding="utf-8") as f:
            vocab = json.load(f).get("model", {}).get("vocab", {})
    else:
        vt = os.path.join(src_dir, "vocab.txt")
        if os.path.exists(vt):
            with open(vt, encoding="utf-8") as f:
                vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
    tokens = [""] * len(vocab)
    types = [1] * len(vocab)
    special = {"[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"}
    for text, idx in vocab.items():
        if text in special:
            tokens[idx] = text
            types[idx] = 3
        elif text.startswith("##"):
            tokens[idx] = text[2:]
        else:
            tokens[idx] = "\u2581" + text
    w.add_kv("tokenizer.ggml.model", "bert")
    w.add_kv("tokenizer.ggml.tokens", tokens)
    w.add_kv("tokenizer.ggml.token_type", types)
    ids = {t: i for i, t in enumerate(tokens)}
    w.add_kv("tokenizer.ggml.unknown_token_id", ids.get("[UNK]", 0))
    w.add_kv("tokenizer.ggml.cls_token_id", ids.get("[CLS]", -1))
    w.add_kv("tokenizer.ggml.seperator_token_id", ids.get("[SEP]", -1))
    w.add_kv("tokenizer.ggml.padding_token_id", ids.get("[PAD]", -1))


def _convert_llava(src_dir: str, dst_path: str, hf: dict, ftype: str,
                   logfile) -> int:
    """LlavaForConditionalGeneration -> language GGUF at dst_path PLUS
    mmproj-<dst_path> for the vision tower + projector (the combined role
    of convert_hf_to_gguf + llava-surgery + convert_image_encoder in the
    reference's llava conversion recipe)."""
    import shutil
    import tempfile

    lm, vis, proj = {}, {}, {}
    for name, t in _iter_hf_tensors(src_dir):
        if name.startswith("language_model."):
            lm[name[len("language_model."):]] = t
        elif name.startswith("vision_tower."):
            vis[name[len("vision_tower."):]] = t
        elif name.startswith("multi_modal_projector."):
            proj[name[len("multi_modal_projector."):]] = t

    # 1. language model: re-materialize as a plain HF checkpoint dir and
    # recurse through the ordinary converter
    text_cfg = dict(hf["text_config"])
    _ARCH_CLASS = {"llama": "LlamaForCausalLM",
                   "mistral": "MistralForCausalLM",
                   "qwen2": "Qwen2ForCausalLM",
                   "gemma": "GemmaForCausalLM"}
    mt = text_cfg.get("model_type", "llama")
    text_cfg.setdefault("architectures",
                        [_ARCH_CLASS.get(mt, "LlamaForCausalLM")])
    tmp = tempfile.mkdtemp(prefix="llava_lm_")
    try:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(text_cfg, f)
        for fn in os.listdir(src_dir):
            if fn.startswith("tokenizer") or fn == "special_tokens_map.json":
                shutil.copy(os.path.join(src_dir, fn), os.path.join(tmp, fn))
        from safetensors.numpy import save_file

        save_file(lm, os.path.join(tmp, "model.safetensors"))
        n = convert_hf_to_gguf(tmp, dst_path, ftype, logfile)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 2. vision tower + projector -> mmproj gguf next to dst_path
    import torch
    from transformers import CLIPVisionConfig, CLIPVisionModel

    from .convert_image_encoder import convert as convert_mmproj

    vcfg = CLIPVisionConfig(**{
        k: v for k, v in hf["vision_config"].items()
        if k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                 "num_attention_heads", "image_size", "patch_size",
                 "projection_dim", "layer_norm_eps", "hidden_act")})
    vm = CLIPVisionModel(vcfg)
    missing, unexpected = vm.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in vis.items()}, strict=False)
    if unexpected:
        print(f"llava: ignoring vision tensors {unexpected[:4]}...",
              file=logfile)
    real_missing = [k for k in missing if "position_ids" not in k]
    if real_missing:
        # a silent random-init vision tower would convert "successfully"
        raise ValueError(
            f"llava: {len(real_missing)} vision weights not found in the "
            f"checkpoint (e.g. {real_missing[:3]}) — unexpected vision "
            "tower prefix?")
    mm = {}
    for k, v in proj.items():
        mm[k.replace("linear_1", "mm.0").replace("linear_2", "mm.2")] = v
    d, base = os.path.split(dst_path)
    mmproj_path = os.path.join(d, f"mmproj-{base}")
    convert_mmproj(
        vm, mmproj_path, projector=mm,
        use_gelu=hf["vision_config"].get("hidden_act") == "gelu",
        image_grid_pinpoints=hf.get("image_grid_pinpoints"),
        mm_patch_merge_type=("spatial_unpad"
                             if hf.get("image_grid_pinpoints") else None))
    print(f"wrote vision tower + projector -> {mmproj_path}", file=logfile)
    return n


def convert_hf_to_gguf(src_dir: str, dst_path: str, ftype: str = "F16",
                       logfile=sys.stderr) -> int:
    with open(os.path.join(src_dir, "config.json")) as f:
        hf = json.load(f)
    archs = hf.get("architectures") or []
    if "LlavaForConditionalGeneration" in archs:
        return _convert_llava(src_dir, dst_path, hf, ftype, logfile)
    if any("Bert" in a for a in archs):
        return _convert_bert(src_dir, dst_path, hf, ftype, logfile)
    if "MambaForCausalLM" in archs:
        return _convert_mamba(src_dir, dst_path, hf, ftype, logfile)
    if any("T5" in a for a in archs):
        return _convert_t5(src_dir, dst_path, hf, ftype, logfile)
    if "DeepseekV2ForCausalLM" in archs:
        return _convert_deepseek2(src_dir, dst_path, hf, ftype, logfile)
    from .convert_extra import convert_extra
    n_extra = convert_extra(src_dir, dst_path, hf, ftype, logfile)
    if n_extra is not None:
        return n_extra
    if ("LlamaForCausalLM" in archs or "MistralForCausalLM" in archs
            or "MixtralForCausalLM" in archs):
        arch = "llama"  # Mixtral is llama with expert_count > 0
    elif "Qwen2ForCausalLM" in archs:
        arch = "qwen2"
    elif "Qwen2MoeForCausalLM" in archs:
        arch = "qwen2moe"
    elif "Starcoder2ForCausalLM" in archs:
        arch = "starcoder2"
    elif "OlmoForCausalLM" in archs:
        arch = "olmo"
    elif "CohereForCausalLM" in archs:
        arch = "command-r"
    elif "PhiForCausalLM" in archs:
        arch = "phi2"
    elif "StableLmForCausalLM" in archs:
        arch = "stablelm"
    elif "GPTNeoXForCausalLM" in archs:
        arch = "gptneox"
    elif "FalconForCausalLM" in archs:
        arch = "falcon"
    elif "GPT2LMHeadModel" in archs:
        arch = "gpt2"
    elif "GPTBigCodeForCausalLM" in archs:
        arch = "starcoder"
    elif "GraniteForCausalLM" in archs:
        arch = "granite"
    elif "GraniteMoeForCausalLM" in archs:
        arch = "granitemoe"
    elif "NemotronForCausalLM" in archs:
        arch = "nemotron"
    elif "OlmoeForCausalLM" in archs:
        arch = "olmoe"
    elif "BloomForCausalLM" in archs:
        arch = "bloom"
    elif "MptForCausalLM" in archs:
        arch = "mpt"
    elif "GPTJForCausalLM" in archs:
        arch = "gptj"
    elif "DbrxForCausalLM" in archs:
        arch = "dbrx"
    elif "GemmaForCausalLM" in archs:
        arch = "gemma"
    elif "Gemma2ForCausalLM" in archs:
        arch = "gemma2"
    elif "Phi3ForCausalLM" in archs:
        arch = "phi3"
    else:
        raise NotImplementedError(f"architectures {archs}")

    n_heads = (hf.get("num_attention_heads") or hf.get("n_head")
               or hf.get("n_heads"))  # mpt names it n_heads
    n_kv = (hf.get("num_key_value_heads") or hf.get("num_kv_heads")
            or n_heads)  # falcon names it num_kv_heads
    if archs and "GPTBigCodeForCausalLM" in archs and hf.get("multi_query", True):
        n_kv = 1
    if (archs and "FalconForCausalLM" in archs
            and not hf.get("new_decoder_architecture", False)
            and hf.get("multi_query", False)):
        n_kv = 1  # classic falcon-7b multi-query: HF config still reports
        #           num_kv_heads == num_attention_heads
    w = GGUFWriter(dst_path, arch=arch)
    w.add_kv("general.name", os.path.basename(os.path.normpath(src_dir)))
    w.add_kv(f"{arch}.block_count",
             int(hf.get("num_hidden_layers") or hf.get("n_layer")
                 or hf.get("n_layers")))
    w.add_kv(f"{arch}.embedding_length",
             int(hf.get("hidden_size") or hf.get("n_embd")
                 or hf.get("d_model")))
    n_embd_eff = int(hf.get("hidden_size") or hf.get("n_embd")
                     or hf.get("d_model"))
    w.add_kv(f"{arch}.feed_forward_length",
             int(hf.get("intermediate_size") or hf.get("n_inner")
                 or 4 * n_embd_eff))
    w.add_kv(f"{arch}.attention.head_count", n_heads)
    w.add_kv(f"{arch}.attention.head_count_kv", n_kv)
    w.add_kv(f"{arch}.context_length",
             int(hf.get("max_position_embeddings")
                 or hf.get("n_positions") or 4096))
    if hf.get("rms_norm_eps") is not None:
        w.add_kv(f"{arch}.attention.layer_norm_rms_epsilon",
                 float(hf["rms_norm_eps"]))
    w.add_kv(f"{arch}.rope.freq_base", float(hf.get("rope_theta", 10000.0)))
    head_dim_eff = int(hf.get("head_dim") or n_embd_eff // n_heads)
    rope_dim = head_dim_eff
    if hf.get("partial_rotary_factor"):  # phi2 / stablelm partial rope
        rope_dim = int(head_dim_eff * float(hf["partial_rotary_factor"]))
    elif hf.get("rotary_pct"):  # gptneox partial rope
        rope_dim = int(head_dim_eff * float(hf["rotary_pct"]))
    elif hf.get("rotary_dim"):  # gptj
        rope_dim = int(hf["rotary_dim"])
    w.add_kv(f"{arch}.rope.dimension_count", rope_dim)
    w.add_kv(f"{arch}.vocab_size", hf["vocab_size"])
    if hf.get("head_dim"):
        w.add_kv(f"{arch}.attention.key_length", hf["head_dim"])
        w.add_kv(f"{arch}.attention.value_length", hf["head_dim"])
    if arch == "gemma2":
        w.add_kv("gemma2.attn_logit_softcapping",
                 float(hf.get("attn_logit_softcapping", 50.0)))
        w.add_kv("gemma2.final_logit_softcapping",
                 float(hf.get("final_logit_softcapping", 30.0)))
        w.add_kv("gemma2.attention.sliding_window",
                 int(hf.get("sliding_window", 4096)))
    if hf.get("num_local_experts") and arch != "granitemoe":  # mixtral
        w.add_kv(f"{arch}.expert_count", int(hf["num_local_experts"]))
        w.add_kv(f"{arch}.expert_used_count",
                 int(hf.get("num_experts_per_tok", 2)))
    if arch == "starcoder2":
        w.add_kv(f"{arch}.attention.layer_norm_epsilon",
                 float(hf.get("norm_epsilon", 1e-5)))
    if arch == "olmo" and hf.get("clip_qkv"):
        w.add_kv(f"{arch}.attention.clamp_kqv", float(hf["clip_qkv"]))
    if arch == "command-r":
        w.add_kv(f"{arch}.attention.layer_norm_epsilon",
                 float(hf.get("layer_norm_eps", 1e-5)))
        w.add_kv(f"{arch}.logit_scale", float(hf.get("logit_scale", 1.0)))
    if arch in ("phi2", "stablelm"):
        w.add_kv(f"{arch}.attention.layer_norm_epsilon",
                 float(hf.get("layer_norm_eps",
                              hf.get("layer_norm_epsilon", 1e-5))))
    if arch == "gptneox":
        w.add_kv(f"{arch}.attention.layer_norm_epsilon",
                 float(hf.get("layer_norm_eps", 1e-5)))
        w.add_kv(f"{arch}.use_parallel_residual",
                 bool(hf.get("use_parallel_residual", True)))
    if arch == "falcon":
        w.add_kv(f"{arch}.attention.layer_norm_epsilon",
                 float(hf.get("layer_norm_epsilon", 1e-5)))
    if arch in ("gpt2", "starcoder"):
        w.add_kv(f"{arch}.attention.layer_norm_epsilon",
                 float(hf.get("layer_norm_epsilon", 1e-5)))
    if arch in ("granite", "granitemoe"):
        w.add_kv(f"{arch}.embedding_scale",
                 float(hf.get("embedding_multiplier", 1.0)))
        w.add_kv(f"{arch}.residual_scale",
                 float(hf.get("residual_multiplier", 1.0)))
        w.add_kv(f"{arch}.logit_scale", float(hf.get("logits_scaling", 1.0)))
        w.add_kv(f"{arch}.attention.scale",
                 float(hf.get("attention_multiplier", 0.0)))
    if arch == "nemotron":
        w.add_kv(f"{arch}.attention.layer_norm_epsilon",
                 float(hf.get("norm_eps", hf.get("layer_norm_eps", 1e-5))))
    if arch == "bloom":
        w.add_kv(f"{arch}.attention.layer_norm_epsilon",
                 float(hf.get("layer_norm_epsilon", 1e-5)))
    if arch == "gptj":
        w.add_kv(f"{arch}.attention.layer_norm_epsilon",
                 float(hf.get("layer_norm_epsilon", 1e-5)))
    if arch == "dbrx":
        ac = hf.get("attn_config") or {}
        fc = hf.get("ffn_config") or {}
        w.add_kv(f"{arch}.attention.layer_norm_epsilon", 1e-5)
        if ac.get("clip_qkv"):
            w.add_kv(f"{arch}.attention.clamp_kqv", float(ac["clip_qkv"]))
        w.add_kv(f"{arch}.expert_count", int(fc.get("moe_num_experts", 4)))
        w.add_kv(f"{arch}.expert_used_count", int(fc.get("moe_top_k", 1)))
    if arch == "mpt":
        ac = hf.get("attn_config") or {}
        w.add_kv(f"{arch}.attention.layer_norm_epsilon", 1e-5)
        w.add_kv(f"{arch}.attention.max_alibi_bias",
                 float(ac.get("alibi_bias_max", 8.0) if ac.get("alibi", True)
                       else 0.0))
        if ac.get("clip_qkv"):
            w.add_kv(f"{arch}.attention.clamp_kqv", float(ac["clip_qkv"]))
    if arch == "granitemoe":
        w.add_kv(f"{arch}.expert_count", int(hf["num_local_experts"]))
        w.add_kv(f"{arch}.expert_used_count",
                 int(hf.get("num_experts_per_tok", 2)))
    if arch == "olmoe":
        w.add_kv(f"{arch}.expert_count", int(hf["num_experts"]))
        w.add_kv(f"{arch}.expert_used_count",
                 int(hf.get("num_experts_per_tok", 8)))
    if arch == "qwen2moe":
        w.add_kv(f"{arch}.expert_count", int(hf["num_experts"]))
        w.add_kv(f"{arch}.expert_used_count",
                 int(hf.get("num_experts_per_tok", 4)))
        w.add_kv(f"{arch}.expert_feed_forward_length",
                 int(hf["moe_intermediate_size"]))
        w.add_kv(f"{arch}.expert_shared_feed_forward_length",
                 int(hf.get("shared_expert_intermediate_size", 0)))
    rs = hf.get("rope_scaling") or {}
    if rs.get("type") in ("linear", "yarn"):
        w.add_kv(f"{arch}.rope.scaling.type", rs["type"])
        w.add_kv(f"{arch}.rope.scaling.factor", float(rs.get("factor", 1.0)))
        if rs.get("original_max_position_embeddings"):
            w.add_kv(f"{arch}.rope.scaling.original_context_length",
                     rs["original_max_position_embeddings"])

    _write_tokenizer(w, src_dir, hf)

    default_t, out_t = FTYPES[ftype.upper()]
    n = 0
    # mixtral: buffer per-layer experts, emit stacked 3D tensors at the end
    experts: dict = {}

    def emit(name, data, ne=None):
        nonlocal n
        t = _target_type_simple(name, ne or tuple(reversed(data.shape)), default_t, out_t)
        flat = data.reshape(-1, data.shape[-1])
        enc, t = _encode(flat, t)
        if t in (GGMLType.F32, GGMLType.F16):
            enc = enc.reshape(data.shape) if ne is None else enc
            w.add_tensor(name, enc, ne=ne, ggml_type=t if ne else None)
        else:
            w.add_tensor(name, enc, ne=ne or tuple(reversed(data.shape)), ggml_type=t)
        n += 1
        print(f"[{n:4d}] {name} ({t.name})", file=logfile)

    for hf_name, data in _iter_hf_tensors(src_dir):
        if arch == "falcon":
            name = _falcon_name(hf_name)
            if name is None:
                continue
            if "attn_qkv" in name:
                # "jploski" reorder: per-kv-group [q...q, k, v] rows ->
                # contiguous [all q; all k; all v] (FalconModel converter)
                hd = hf["hidden_size"] // n_heads
                qkv = data.reshape(n_kv, n_heads // n_kv + 2, hd, -1)
                q = qkv[:, :-2].reshape(n_heads * hd, -1)
                kk = qkv[:, -2].reshape(n_kv * hd, -1)
                vv = qkv[:, -1].reshape(n_kv * hd, -1)
                data = np.concatenate([q, kk, vv], axis=0)
            emit(name, data)
            continue
        if arch in ("gpt2", "starcoder"):
            name = _gpt2_name(hf_name, arch)
            if name is None:
                continue
            if arch == "gpt2" and name.endswith(".weight") and (
                    "attn_qkv" in name or "attn_output" in name
                    or "ffn_up" in name or "ffn_down" in name):
                data = data.T  # HF gpt2 Conv1D stores (in, out)
            emit(name, np.ascontiguousarray(data))
            continue
        if arch == "bloom":
            name = _bloom_name(hf_name)
            if name is None:
                continue
            if "attn_qkv" in name:
                # per-head [q,k,v] -> contiguous [q;k;v] (BloomModel conv)
                hd = n_embd_eff // n_heads
                if name.endswith(".weight"):
                    qkv = data.reshape(n_heads, 3, hd, n_embd_eff)
                    data = np.concatenate(
                        [qkv[:, j].reshape(-1, n_embd_eff) for j in range(3)],
                        axis=0)
                else:
                    qkv = data.reshape(n_heads, 3, hd)
                    data = np.concatenate(
                        [qkv[:, j].reshape(-1) for j in range(3)], axis=0)
            emit(name, data)
            continue
        if arch == "mpt":
            name = _mpt_name(hf_name)
            if name is None:
                continue
            emit(name, data)
            continue
        if arch == "dbrx":
            fc = hf.get("ffn_config") or {}
            n_exp = int(fc.get("moe_num_experts", 4))
            ff = int(fc.get("ffn_hidden_size", 4 * n_embd_eff))
            name = _dbrx_name(hf_name)
            if name is None:
                continue
            if name.endswith(("ffn_gate_exps.weight", "ffn_up_exps.weight")):
                data = data.reshape(n_exp, ff, n_embd_eff)
                emit(name, data, ne=(n_embd_eff, ff, n_exp))
                continue
            if name.endswith("ffn_down_exps.weight"):
                # HF stores w2 as (n_exp*ff, e) used untransposed: per-expert
                # down weight = w2[e].T
                data = np.ascontiguousarray(
                    data.reshape(n_exp, ff, n_embd_eff).transpose(0, 2, 1))
                emit(name, data, ne=(ff, n_embd_eff, n_exp))
                continue
            emit(name, data)
            continue
        if arch == "gptj":
            name = _gptj_name(hf_name)
            if name is None:
                continue
            emit(name, data)
            continue
        if arch == "gptneox":
            name = _gptneox_name(hf_name)
            if name is None:
                continue
            if "attn_qkv" in name:
                # de-interleave HF's per-head [q;k;v] rows into contiguous
                # [q_all; k_all; v_all] (convert_hf_to_gguf.py GPTNeoXModel)
                hd = hf["hidden_size"] // n_heads
                if name.endswith(".weight"):
                    qkv = data.reshape(n_heads, 3, hd, hf["hidden_size"])
                    data = np.concatenate(
                        [qkv[:, j].reshape(-1, hf["hidden_size"])
                         for j in range(3)], axis=0)
                else:
                    qkv = data.reshape(n_heads, 3, hd)
                    data = np.concatenate(
                        [qkv[:, j].reshape(-1) for j in range(3)], axis=0)
            emit(name, data)
            continue
        if arch == "granitemoe" and ".block_sparse_moe." in hf_name:
            parts = hf_name.split(".")
            li = parts[2]
            ff = int(hf["intermediate_size"])
            if hf_name.endswith("block_sparse_moe.input_linear.weight"):
                gate = np.ascontiguousarray(data[:, :ff, :])
                up = np.ascontiguousarray(data[:, ff:, :])
                ne = (gate.shape[2], gate.shape[1], gate.shape[0])
                emit(f"blk.{li}.ffn_gate_exps.weight", gate, ne=ne)
                emit(f"blk.{li}.ffn_up_exps.weight", up, ne=ne)
            elif hf_name.endswith("block_sparse_moe.output_linear.weight"):
                ne = (data.shape[2], data.shape[1], data.shape[0])
                emit(f"blk.{li}.ffn_down_exps.weight", data, ne=ne)
            elif hf_name.endswith("block_sparse_moe.router.layer.weight"):
                emit(f"blk.{li}.ffn_gate_inp.weight", data)
            continue
        if ".block_sparse_moe.experts." in hf_name:  # mixtral expert weights
            parts = hf_name.split(".")
            li, ei, wname = int(parts[2]), int(parts[5]), parts[6]
            experts.setdefault(li, {}).setdefault(wname, {})[ei] = data
            continue
        if ".mlp.experts." in hf_name:  # qwen2moe expert weights
            parts = hf_name.split(".")
            li, ei, wname = int(parts[2]), int(parts[5]), parts[6]
            wname = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}[wname]
            experts.setdefault(li, {}).setdefault(wname, {})[ei] = data
            continue
        name = _gguf_name(hf_name, arch)
        if name is None:
            continue
        if arch in ("llama", "olmo", "granite", "granitemoe") \
                and name.endswith(("attn_q.weight",)):
            data = _permute_qk(data, n_heads)
        elif arch in ("llama", "olmo", "granite", "granitemoe") \
                and name.endswith(("attn_k.weight",)):
            data = _permute_qk(data, n_kv)
        elif arch == "nemotron" and name.endswith("norm.weight"):
            data = data + 1.0  # layernorm1p folded in (NemotronModel)
        elif arch in ("gemma", "gemma2") and ("norm" in name):
            data = data + 1.0  # HF gemma norms compute (1 + w) * x_hat
        emit(name, data)

    for li, ws in sorted(experts.items()):
        for wname, gguf in (("w1", "ffn_gate_exps"), ("w3", "ffn_up_exps"),
                            ("w2", "ffn_down_exps")):
            exp = ws[wname]
            stacked = np.stack([exp[e] for e in sorted(exp)])  # (E, rows, k)
            ne = (stacked.shape[2], stacked.shape[1], stacked.shape[0])
            emit(f"blk.{li}.{gguf}.weight", stacked, ne=ne)
    w.write()
    return n


_GPTNEOX_MAP = [
    ("gpt_neox.embed_in.weight", "token_embd.weight"),
    ("gpt_neox.final_layer_norm.weight", "output_norm.weight"),
    ("gpt_neox.final_layer_norm.bias", "output_norm.bias"),
    ("embed_out.weight", "output.weight"),
]
_GPTNEOX_LAYER_MAP = [
    ("input_layernorm.weight", "attn_norm.weight"),
    ("input_layernorm.bias", "attn_norm.bias"),
    ("attention.query_key_value.weight", "attn_qkv.weight"),
    ("attention.query_key_value.bias", "attn_qkv.bias"),
    ("attention.dense.weight", "attn_output.weight"),
    ("attention.dense.bias", "attn_output.bias"),
    ("post_attention_layernorm.weight", "ffn_norm.weight"),
    ("post_attention_layernorm.bias", "ffn_norm.bias"),
    ("mlp.dense_h_to_4h.weight", "ffn_up.weight"),
    ("mlp.dense_h_to_4h.bias", "ffn_up.bias"),
    ("mlp.dense_4h_to_h.weight", "ffn_down.weight"),
    ("mlp.dense_4h_to_h.bias", "ffn_down.bias"),
]


_FALCON_MAP = [
    ("transformer.word_embeddings.weight", "token_embd.weight"),
    ("transformer.ln_f.weight", "output_norm.weight"),
    ("transformer.ln_f.bias", "output_norm.bias"),
    ("lm_head.weight", "output.weight"),
]
_FALCON_LAYER_MAP = [
    ("input_layernorm.weight", "attn_norm.weight"),
    ("input_layernorm.bias", "attn_norm.bias"),
    ("ln_attn.weight", "attn_norm.weight"),  # falcon-40b two-norm form
    ("ln_attn.bias", "attn_norm.bias"),
    ("ln_mlp.weight", "attn_norm_2.weight"),
    ("ln_mlp.bias", "attn_norm_2.bias"),
    ("self_attention.query_key_value.weight", "attn_qkv.weight"),
    ("self_attention.dense.weight", "attn_output.weight"),
    ("mlp.dense_h_to_4h.weight", "ffn_up.weight"),
    ("mlp.dense_4h_to_h.weight", "ffn_down.weight"),
]


_DBRX_MAP = [
    ("transformer.wte.weight", "token_embd.weight"),
    ("transformer.norm_f.weight", "output_norm.weight"),
    ("lm_head.weight", "output.weight"),
]
_DBRX_LAYER_MAP = [
    ("norm_attn_norm.norm_1.weight", "attn_norm.weight"),
    ("norm_attn_norm.attn.Wqkv.weight", "attn_qkv.weight"),
    ("norm_attn_norm.attn.out_proj.weight", "attn_output.weight"),
    ("norm_attn_norm.norm_2.weight", "attn_out_norm.weight"),
    ("ffn.router.layer.weight", "ffn_gate_inp.weight"),
    ("ffn.experts.mlp.w1", "ffn_gate_exps.weight"),
    ("ffn.experts.mlp.v1", "ffn_up_exps.weight"),
    ("ffn.experts.mlp.w2", "ffn_down_exps.weight"),
]


def _dbrx_name(hf_name: str) -> str | None:
    for src, dst in _DBRX_MAP:
        if hf_name == src:
            return dst
    if hf_name.startswith("transformer.blocks."):
        _, _, idx, rest = hf_name.split(".", 3)
        for src, dst in _DBRX_LAYER_MAP:
            if rest == src:
                return f"blk.{idx}.{dst}"
    return None


_GPTJ_MAP = [
    ("wte.weight", "token_embd.weight"),
    ("ln_f.weight", "output_norm.weight"),
    ("ln_f.bias", "output_norm.bias"),
    ("lm_head.weight", "output.weight"),
    ("lm_head.bias", "output.bias"),
]
_GPTJ_LAYER_MAP = [
    ("ln_1.weight", "attn_norm.weight"),
    ("ln_1.bias", "attn_norm.bias"),
    ("attn.q_proj.weight", "attn_q.weight"),
    ("attn.k_proj.weight", "attn_k.weight"),
    ("attn.v_proj.weight", "attn_v.weight"),
    ("attn.out_proj.weight", "attn_output.weight"),
    ("mlp.fc_in.weight", "ffn_up.weight"),
    ("mlp.fc_in.bias", "ffn_up.bias"),
    ("mlp.fc_out.weight", "ffn_down.weight"),
    ("mlp.fc_out.bias", "ffn_down.bias"),
]


def _gptj_name(hf_name: str) -> str | None:
    if hf_name.startswith("transformer."):
        hf_name = hf_name[len("transformer."):]
    for src, dst in _GPTJ_MAP:
        if hf_name == src:
            return dst
    if hf_name.startswith("h."):
        _, idx, rest = hf_name.split(".", 2)
        for src, dst in _GPTJ_LAYER_MAP:
            if rest == src:
                return f"blk.{idx}.{dst}"
    return None


_GPT2_MAP = [
    ("wte.weight", "token_embd.weight"),
    ("wpe.weight", "position_embd.weight"),
    ("ln_f.weight", "output_norm.weight"),
    ("ln_f.bias", "output_norm.bias"),
    ("lm_head.weight", "output.weight"),
]
_GPT2_LAYER_MAP = [
    ("ln_1.weight", "attn_norm.weight"),
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
    ("mlp.c_proj.bias", "ffn_down.bias"),
]


def _gpt2_name(hf_name: str, arch: str) -> str | None:
    if hf_name.startswith("transformer."):
        hf_name = hf_name[len("transformer."):]
    for src, dst in _GPT2_MAP:
        if hf_name == src:
            return dst
    if hf_name.startswith("h."):
        _, idx, rest = hf_name.split(".", 2)
        for src, dst in _GPT2_LAYER_MAP:
            if rest == src:
                return f"blk.{idx}.{dst}"
    return None


def _falcon_name(hf_name: str) -> str | None:
    for src, dst in _FALCON_MAP:
        if hf_name == src:
            return dst
    if hf_name.startswith("transformer.h."):
        _, _, idx, rest = hf_name.split(".", 3)
        for src, dst in _FALCON_LAYER_MAP:
            if rest == src:
                return f"blk.{idx}.{dst}"
    return None


_BLOOM_MAP = [
    ("word_embeddings.weight", "token_embd.weight"),
    ("word_embeddings_layernorm.weight", "token_embd_norm.weight"),
    ("word_embeddings_layernorm.bias", "token_embd_norm.bias"),
    ("ln_f.weight", "output_norm.weight"),
    ("ln_f.bias", "output_norm.bias"),
    ("lm_head.weight", "output.weight"),
]
_BLOOM_LAYER_MAP = [
    ("input_layernorm.weight", "attn_norm.weight"),
    ("input_layernorm.bias", "attn_norm.bias"),
    ("self_attention.query_key_value.weight", "attn_qkv.weight"),
    ("self_attention.query_key_value.bias", "attn_qkv.bias"),
    ("self_attention.dense.weight", "attn_output.weight"),
    ("self_attention.dense.bias", "attn_output.bias"),
    ("post_attention_layernorm.weight", "ffn_norm.weight"),
    ("post_attention_layernorm.bias", "ffn_norm.bias"),
    ("mlp.dense_h_to_4h.weight", "ffn_up.weight"),
    ("mlp.dense_h_to_4h.bias", "ffn_up.bias"),
    ("mlp.dense_4h_to_h.weight", "ffn_down.weight"),
    ("mlp.dense_4h_to_h.bias", "ffn_down.bias"),
]


def _bloom_name(hf_name: str) -> str | None:
    if hf_name.startswith("transformer."):
        hf_name = hf_name[len("transformer."):]
    for src, dst in _BLOOM_MAP:
        if hf_name == src:
            return dst
    if hf_name.startswith("h."):
        _, idx, rest = hf_name.split(".", 2)
        for src, dst in _BLOOM_LAYER_MAP:
            if rest == src:
                return f"blk.{idx}.{dst}"
    return None


_MPT_MAP = [
    ("wte.weight", "token_embd.weight"),
    ("norm_f.weight", "output_norm.weight"),
    ("norm_f.bias", "output_norm.bias"),
]
_MPT_LAYER_MAP = [
    ("norm_1.weight", "attn_norm.weight"),
    ("norm_1.bias", "attn_norm.bias"),
    ("attn.Wqkv.weight", "attn_qkv.weight"),
    ("attn.Wqkv.bias", "attn_qkv.bias"),
    ("attn.out_proj.weight", "attn_output.weight"),
    ("attn.out_proj.bias", "attn_output.bias"),
    ("norm_2.weight", "ffn_norm.weight"),
    ("norm_2.bias", "ffn_norm.bias"),
    ("ffn.up_proj.weight", "ffn_up.weight"),
    ("ffn.up_proj.bias", "ffn_up.bias"),
    ("ffn.down_proj.weight", "ffn_down.weight"),
    ("ffn.down_proj.bias", "ffn_down.bias"),
]


def _mpt_name(hf_name: str) -> str | None:
    if hf_name.startswith("transformer."):
        hf_name = hf_name[len("transformer."):]
    for src, dst in _MPT_MAP:
        if hf_name == src:
            return dst
    if hf_name.startswith("blocks."):
        _, idx, rest = hf_name.split(".", 2)
        for src, dst in _MPT_LAYER_MAP:
            if rest == src:
                return f"blk.{idx}.{dst}"
    return None


def _gptneox_name(hf_name: str) -> str | None:
    for src, dst in _GPTNEOX_MAP:
        if hf_name == src:
            return dst
    if hf_name.startswith("gpt_neox.layers."):
        _, _, idx, rest = hf_name.split(".", 3)
        for src, dst in _GPTNEOX_LAYER_MAP:
            if rest == src:
                return f"blk.{idx}.{dst}"
    return None


_MAMBA_MAP = [
    ("backbone.embeddings.weight", "token_embd.weight"),
    ("backbone.norm_f.weight", "output_norm.weight"),
    ("lm_head.weight", "output.weight"),
]
_MAMBA_LAYER_MAP = [
    ("norm.weight", "attn_norm.weight"),
    ("mixer.in_proj.weight", "ssm_in.weight"),
    ("mixer.conv1d.weight", "ssm_conv1d.weight"),
    ("mixer.conv1d.bias", "ssm_conv1d.bias"),
    ("mixer.x_proj.weight", "ssm_x.weight"),
    ("mixer.dt_proj.weight", "ssm_dt.weight"),
    ("mixer.dt_proj.bias", "ssm_dt.bias"),
    ("mixer.A_log", "ssm_a"),
    ("mixer.D", "ssm_d"),
    ("mixer.out_proj.weight", "ssm_out.weight"),
]


def _convert_mamba(src_dir: str, dst_path: str, hf: dict, ftype: str,
                   logfile) -> int:
    """MambaForCausalLM -> GGUF arch "mamba" (convert_hf_to_gguf.py
    MambaModel semantics: ssm_a = -exp(A_log), conv weight squeezed)."""
    arch = "mamba"
    d_model = int(hf["hidden_size"])
    dt_rank = hf.get("time_step_rank", "auto")
    if dt_rank == "auto" or dt_rank is None:
        dt_rank = -(-d_model // 16)  # ceil(d_model / 16)
    w = GGUFWriter(dst_path, arch=arch)
    w.add_kv("general.name", os.path.basename(os.path.normpath(src_dir)))
    w.add_kv(f"{arch}.block_count", int(hf["num_hidden_layers"]))
    w.add_kv(f"{arch}.embedding_length", d_model)
    w.add_kv(f"{arch}.context_length", int(hf.get("max_position_embeddings",
                                                  2 ** 20)))
    # unused by the arch but expected by generic tooling
    w.add_kv(f"{arch}.feed_forward_length", 0)
    w.add_kv(f"{arch}.attention.head_count", 0)
    w.add_kv(f"{arch}.ssm.conv_kernel", int(hf.get("conv_kernel", 4)))
    w.add_kv(f"{arch}.ssm.inner_size", int(hf.get("intermediate_size",
                                                  2 * d_model)))
    w.add_kv(f"{arch}.ssm.state_size", int(hf.get("state_size", 16)))
    w.add_kv(f"{arch}.ssm.time_step_rank", int(dt_rank))
    w.add_kv(f"{arch}.attention.layer_norm_rms_epsilon",
             float(hf.get("layer_norm_epsilon", 1e-5)))
    w.add_kv(f"{arch}.vocab_size", int(hf["vocab_size"]))
    _write_tokenizer(w, src_dir, hf)

    n = 0
    seen_lm_head = False
    for hf_name, data in _iter_hf_tensors(src_dir):
        name = None
        for src, dst in _MAMBA_MAP:
            if hf_name == src:
                name = dst
        if hf_name.startswith("backbone.layers."):
            _, _, idx, rest = hf_name.split(".", 3)
            for src, dst in _MAMBA_LAYER_MAP:
                if rest == src:
                    name = f"blk.{idx}.{dst}"
        if name is None:
            continue
        if name == "output.weight":
            seen_lm_head = True
        if name.endswith("ssm_a"):
            data = -np.exp(data)
        if name.endswith("ssm_conv1d.weight"):
            data = data.reshape(data.shape[0], -1)  # (d_inner, 1, k) -> 2D
        w.add_tensor(name, np.ascontiguousarray(data, dtype=np.float32))
        n += 1
        print(f"[{n:4d}] {name} (F32)", file=logfile)
    del seen_lm_head  # tied embeddings are the norm; loader falls back
    w.write()
    return n


def _t5_name(hf_name: str) -> str | None:
    top = {"shared.weight": "token_embd.weight",
           "encoder.final_layer_norm.weight": "enc.output_norm.weight",
           "decoder.final_layer_norm.weight": "dec.output_norm.weight",
           "lm_head.weight": "output.weight"}
    if hf_name in top:
        return top[hf_name]
    parts = hf_name.split(".")
    # encoder.block.N.layer.L.<Module>.<rest>
    if len(parts) < 7 or parts[1] != "block" or parts[3] != "layer":
        return None
    side = {"encoder": "enc", "decoder": "dec"}.get(parts[0])
    if side is None:
        return None
    blk, li, mod = parts[2], parts[4], parts[5]
    rest = ".".join(parts[6:])
    attn = {"q.weight": "q", "k.weight": "k", "v.weight": "v", "o.weight": "o"}
    if mod == "SelfAttention":
        if rest in attn:
            return f"{side}.blk.{blk}.attn_{attn[rest]}.weight"
        if rest == "relative_attention_bias.weight":
            return f"{side}.blk.{blk}.attn_rel_b.weight"
    if mod == "EncDecAttention" and rest in attn:
        return f"{side}.blk.{blk}.cross_attn_{attn[rest]}.weight"
    if mod == "DenseReluDense":
        ffn = {"wi.weight": "ffn_up", "wi_0.weight": "ffn_gate",
               "wi_1.weight": "ffn_up", "wo.weight": "ffn_down"}
        if rest in ffn:
            return f"{side}.blk.{blk}.{ffn[rest]}.weight"
    if mod == "layer_norm" and rest == "weight":
        if side == "enc":
            return f"enc.blk.{blk}." + ("attn_norm" if li == "0"
                                        else "ffn_norm") + ".weight"
        return f"dec.blk.{blk}." + {"0": "attn_norm", "1": "cross_attn_norm",
                                    "2": "ffn_norm"}[li] + ".weight"
    return None


def _convert_t5(src_dir: str, dst_path: str, hf: dict, ftype: str,
                logfile) -> int:
    """T5ForConditionalGeneration -> GGUF arch "t5"."""
    arch = "t5"
    w = GGUFWriter(dst_path, arch=arch)
    w.add_kv("general.name", os.path.basename(os.path.normpath(src_dir)))
    w.add_kv(f"{arch}.block_count",
             int(hf.get("num_decoder_layers") or hf["num_layers"]))
    w.add_kv(f"{arch}.encoder_block_count", int(hf["num_layers"]))
    w.add_kv(f"{arch}.embedding_length", int(hf["d_model"]))
    w.add_kv(f"{arch}.feed_forward_length", int(hf["d_ff"]))
    w.add_kv(f"{arch}.attention.head_count", int(hf["num_heads"]))
    w.add_kv(f"{arch}.attention.key_length", int(hf["d_kv"]))
    w.add_kv(f"{arch}.context_length", 512)
    w.add_kv(f"{arch}.attention.layer_norm_rms_epsilon",
             float(hf.get("layer_norm_epsilon", 1e-6)))
    w.add_kv(f"{arch}.attention.relative_buckets_count",
             int(hf.get("relative_attention_num_buckets", 32)))
    w.add_kv(f"{arch}.decoder_start_token_id",
             int(hf.get("decoder_start_token_id", 0)))
    w.add_kv(f"{arch}.vocab_size", int(hf["vocab_size"]))
    _write_tokenizer(w, src_dir, hf)

    n = 0
    for hf_name, data in _iter_hf_tensors(src_dir):
        name = _t5_name(hf_name)
        if name is None:
            continue
        w.add_tensor(name, np.ascontiguousarray(data, dtype=np.float32))
        n += 1
        print(f"[{n:4d}] {name} (F32)", file=logfile)
    w.write()
    return n


_DS2_ATTN_MAP = [
    ("self_attn.q_proj.weight", "attn_q.weight"),
    ("self_attn.q_a_proj.weight", "attn_q_a.weight"),
    ("self_attn.q_a_layernorm.weight", "attn_q_a_norm.weight"),
    ("self_attn.q_b_proj.weight", "attn_q_b.weight"),
    ("self_attn.kv_a_proj_with_mqa.weight", "attn_kv_a_mqa.weight"),
    ("self_attn.kv_a_layernorm.weight", "attn_kv_a_norm.weight"),
    ("self_attn.kv_b_proj.weight", "attn_kv_b.weight"),
    ("self_attn.o_proj.weight", "attn_output.weight"),
    ("input_layernorm.weight", "attn_norm.weight"),
    ("post_attention_layernorm.weight", "ffn_norm.weight"),
    ("mlp.gate_proj.weight", "ffn_gate.weight"),
    ("mlp.up_proj.weight", "ffn_up.weight"),
    ("mlp.down_proj.weight", "ffn_down.weight"),
    ("mlp.gate.weight", "ffn_gate_inp.weight"),
    ("mlp.shared_experts.gate_proj.weight", "ffn_gate_shexp.weight"),
    ("mlp.shared_experts.up_proj.weight", "ffn_up_shexp.weight"),
    ("mlp.shared_experts.down_proj.weight", "ffn_down_shexp.weight"),
]


def _convert_deepseek2(src_dir: str, dst_path: str, hf: dict, ftype: str,
                       logfile) -> int:
    """DeepseekV2ForCausalLM -> GGUF arch "deepseek2" (MLA + MoE)."""
    arch = "deepseek2"
    w = GGUFWriter(dst_path, arch=arch)
    w.add_kv("general.name", os.path.basename(os.path.normpath(src_dir)))
    w.add_kv(f"{arch}.block_count", int(hf["num_hidden_layers"]))
    w.add_kv(f"{arch}.embedding_length", int(hf["hidden_size"]))
    w.add_kv(f"{arch}.feed_forward_length", int(hf["intermediate_size"]))
    w.add_kv(f"{arch}.attention.head_count", int(hf["num_attention_heads"]))
    w.add_kv(f"{arch}.attention.head_count_kv",
             int(hf.get("num_key_value_heads", hf["num_attention_heads"])))
    w.add_kv(f"{arch}.attention.key_length",
             int(hf["qk_nope_head_dim"]) + int(hf["qk_rope_head_dim"]))
    w.add_kv(f"{arch}.attention.value_length", int(hf["v_head_dim"]))
    w.add_kv(f"{arch}.rope.dimension_count", int(hf["qk_rope_head_dim"]))
    w.add_kv(f"{arch}.rope.freq_base", float(hf.get("rope_theta", 10000.0)))
    w.add_kv(f"{arch}.context_length",
             int(hf.get("max_position_embeddings", 4096)))
    w.add_kv(f"{arch}.attention.layer_norm_rms_epsilon",
             float(hf.get("rms_norm_eps", 1e-6)))
    if hf.get("q_lora_rank"):
        w.add_kv(f"{arch}.attention.q_lora_rank", int(hf["q_lora_rank"]))
    w.add_kv(f"{arch}.attention.kv_lora_rank", int(hf["kv_lora_rank"]))
    w.add_kv(f"{arch}.leading_dense_block_count",
             int(hf.get("first_k_dense_replace", 0)))
    w.add_kv(f"{arch}.expert_count", int(hf.get("n_routed_experts", 0) or 0))
    w.add_kv(f"{arch}.expert_used_count",
             int(hf.get("num_experts_per_tok", 0) or 0))
    w.add_kv(f"{arch}.expert_shared_count",
             int(hf.get("n_shared_experts", 0) or 0))
    w.add_kv(f"{arch}.expert_feed_forward_length",
             int(hf.get("moe_intermediate_size", 0) or 0))
    w.add_kv(f"{arch}.expert_weights_scale",
             float(hf.get("routed_scaling_factor", 1.0)))
    w.add_kv(f"{arch}.vocab_size", int(hf["vocab_size"]))
    _write_tokenizer(w, src_dir, hf)

    n = 0
    experts: dict = {}

    def emit(name, data):
        nonlocal n
        w.add_tensor(name, np.ascontiguousarray(data, dtype=np.float32))
        n += 1
        print(f"[{n:4d}] {name} (F32)", file=logfile)

    for hf_name, data in _iter_hf_tensors(src_dir):
        if hf_name == "model.embed_tokens.weight":
            emit("token_embd.weight", data)
            continue
        if hf_name == "model.norm.weight":
            emit("output_norm.weight", data)
            continue
        if hf_name == "lm_head.weight":
            emit("output.weight", data)
            continue
        if ".mlp.experts." in hf_name:
            parts = hf_name.split(".")
            li, ei, wname = int(parts[2]), int(parts[5]), parts[6]
            wname = {"gate_proj": "ffn_gate_exps", "up_proj": "ffn_up_exps",
                     "down_proj": "ffn_down_exps"}[wname]
            experts.setdefault(li, {}).setdefault(wname, {})[ei] = data
            continue
        if hf_name.startswith("model.layers."):
            _, _, idx, rest = hf_name.split(".", 3)
            for src, dst in _DS2_ATTN_MAP:
                if rest == src:
                    emit(f"blk.{idx}.{dst}", data)
                    break
            continue
    for li, ws in sorted(experts.items()):
        for wname, exp in ws.items():
            stacked = np.stack([exp[e] for e in sorted(exp)])
            w.add_tensor(f"blk.{li}.{wname}.weight",
                         np.ascontiguousarray(stacked, dtype=np.float32),
                         ne=(stacked.shape[2], stacked.shape[1],
                             stacked.shape[0]),
                         ggml_type=GGMLType.F32)
            n += 1
    w.write()
    return n


def _write_tokenizer(w: GGUFWriter, src_dir: str, hf: dict) -> None:
    """Tokenizer metadata from tokenizer.json (BPE) or tokenizer.model (SPM)."""
    tok_json = os.path.join(src_dir, "tokenizer.json")
    if os.path.exists(tok_json):
        with open(tok_json, encoding="utf-8") as f:
            tj = json.load(f)
        model = tj.get("model", {})
        vocab = model.get("vocab", {})
        merges = model.get("merges", [])
        tokens = [""] * len(vocab)
        for text, idx in vocab.items():
            tokens[idx] = text
        types = [1] * len(tokens)
        for added in tj.get("added_tokens", []):
            i = added["id"]
            if i >= len(tokens):
                tokens.extend([""] * (i + 1 - len(tokens)))
                types.extend([1] * (i + 1 - len(types)))
            tokens[i] = added["content"]
            types[i] = 3 if added.get("special") else 4
        w.add_kv("tokenizer.ggml.model", "gpt2")
        w.add_kv("tokenizer.ggml.pre", _detect_pre(hf))
        w.add_kv("tokenizer.ggml.tokens", tokens)
        w.add_kv("tokenizer.ggml.token_type", types)
        w.add_kv("tokenizer.ggml.merges",
                 [m if isinstance(m, str) else " ".join(m) for m in merges])
        w.add_kv("tokenizer.ggml.bos_token_id", hf.get("bos_token_id", 1) or 0)
        w.add_kv("tokenizer.ggml.eos_token_id", hf.get("eos_token_id", 2) or 0)
        w.add_kv("tokenizer.ggml.add_bos_token", "llama" in str(hf.get("architectures")).lower())
        cfg_tmpl = os.path.join(src_dir, "tokenizer_config.json")
        if os.path.exists(cfg_tmpl):
            with open(cfg_tmpl, encoding="utf-8") as f:
                tc = json.load(f)
            if tc.get("chat_template"):
                w.add_kv("tokenizer.chat_template", tc["chat_template"])
        return
    raise NotImplementedError("no tokenizer.json found (SPM .model conversion "
                              "requires sentencepiece, not available)")


# Per-source-architecture BPE pre-tokenizer type, mirroring the reference's
# convert_hf_to_gguf.py get_vocab_base_pre() assignments (which key the
# pre-type off the *tokenizer*, per model family). Keys are lowercased HF
# `architectures` substrings; order matters (first match wins).
_PRE_BY_ARCH = (
    ("qwen2", "qwen2"),
    ("qwen", "qwen2"),
    ("starcoder2", "starcoder"),
    ("starcoder", "starcoder"),
    ("gptbigcode", "starcoder"),
    ("falcon", "falcon"),
    ("mpt", "mpt"),
    ("gptneox", "gpt-neox"),
    ("olmoe", "olmo"),
    ("olmo", "olmo"),
    ("dbrx", "dbrx"),
    ("bloom", "bloom"),
    ("gptj", "gpt-2"),
    ("gpt2", "gpt-2"),
    ("stablelm", "stablelm2"),
    ("phi3", "phi-3"),  # actually SPM in most phi-3 ships; BPE variants use this
    ("phi", "phi-2"),
    ("cohere", "command-r"),
    ("deepseekv2", "deepseek-llm"),
    ("deepseekv3", "deepseek-v3"),
    ("deepseek", "deepseek-llm"),
    ("nemotron", "nemotron"),
    ("granite", "llama-bpe"),
    ("smaug", "smaug-bpe"),
    ("mixtral", "llama-bpe"),
    ("exaone", "exaone"),
    ("chatglm", "chatglm-bpe"),
    ("jais", "jais"),
    ("codeshell", "codeshell"),
    ("refact", "refact"),
    ("chameleon", "chameleon"),
)


def _detect_pre(hf: dict) -> str:
    archs = str(hf.get("architectures", "")).lower()
    for key, pre in _PRE_BY_ARCH:
        if key in archs:
            return pre
    # Llama family: Llama-3+ tokenizers are BPE with >=100k vocab; earlier
    # llamas are SPM (this path is only reached for BPE tokenizer.json).
    if "llama" in archs or "mistral" in archs:
        if hf.get("vocab_size", 0) >= 100000:
            return "llama-bpe"
        return "default"
    import warnings
    warnings.warn(
        f"unknown pre-tokenizer for architectures={hf.get('architectures')}; "
        "falling back to 'gpt-2' regex — tokenization may differ from "
        "reference-converted GGUFs", stacklevel=2)
    return "gpt-2"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-convert", description=__doc__)
    ap.add_argument("src", help="HF checkpoint directory")
    ap.add_argument("dst", help="output .gguf")
    ap.add_argument("--outtype", default="F16", choices=sorted(FTYPES))
    args = ap.parse_args(argv)
    n = convert_hf_to_gguf(args.src, args.dst, args.outtype)
    print(f"wrote {n} tensors -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
