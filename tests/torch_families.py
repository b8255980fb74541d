"""Tiny models of the dense families (deepseek2, minicpm3, mamba, rwkv6, t5)
and a llama for the port's tests: Hugging Face checkpoint directories
written from a seed (through transformers where it has the class, else as
safetensors, as tests/test_convert_extra.py writes them), which either
package's converter turns into GGUFs, and `rewrite_gguf` to add metadata
keys the converters do not write (YaRN, rope_orig_ctx, falcon-mamba's
dt_b_c_rms).

Imported by tests/test_torch_{deepseek2,mamba,rwkv6,t5,convert,cli}.py."""

import json
import os

import numpy as np
import torch
import transformers

from test_convert_hf import _write_tokenizer_json


def _widen(model, std: float, names: tuple) -> None:
    """Redraw the weights whose names end with one of `names` at `std`:
    transformers' initializers make tiny models repeat one token."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(names):
                p.normal_(0.0, std)


def _save(model, d: str, vocab: int) -> str:
    model.save_pretrained(d, safe_serialization=True)
    _write_tokenizer_json(d, vocab)
    return d


def hf_llama(d: str) -> str:
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    return _save(transformers.LlamaForCausalLM(cfg).eval(), d, cfg.vocab_size)


def hf_deepseek2(d: str, q_lora_rank: int | None = 32) -> str:
    """DeepSeek-V2 with 2 layers (1 dense, 1 MoE of 4 experts, top-2, one
    shared); q_lora_rank None is the Lite layout (a direct wq)."""
    cfg = transformers.DeepseekV2Config(
        vocab_size=128, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        q_lora_rank=q_lora_rank, kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16,
        v_head_dim=16, n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
        first_k_dense_replace=1, routed_scaling_factor=1.0, norm_topk_prob=False,
        scoring_func="softmax", topk_method="greedy", n_group=1, topk_group=1,
        rope_theta=10000.0, max_position_embeddings=64, tie_word_embeddings=False,
        attention_bias=False, rms_norm_eps=1e-6, aux_loss_alpha=0.0)
    torch.manual_seed(0)
    return _save(transformers.DeepseekV2ForCausalLM(cfg).eval(), d, cfg.vocab_size)


def hf_mamba(d: str) -> str:
    cfg = transformers.MambaConfig(vocab_size=128, hidden_size=32, state_size=8,
                                   num_hidden_layers=2, conv_kernel=4, expand=2,
                                   time_step_rank=4, use_cache=False)
    torch.manual_seed(0)
    model = transformers.MambaForCausalLM(cfg).eval()
    _widen(model, 0.3, ("embeddings.weight", "in_proj.weight", "x_proj.weight",
                        "out_proj.weight"))
    return _save(model, d, cfg.vocab_size)


def hf_t5(d: str, gated: bool, tied: bool) -> str:
    cfg = transformers.T5Config(
        vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=128,
        dropout_rate=0.0, feed_forward_proj="gated-gelu" if gated else "relu",
        decoder_start_token_id=0, eos_token_id=1, pad_token_id=0, tie_word_embeddings=tied)
    torch.manual_seed(0)
    model = transformers.T5ForConditionalGeneration(cfg).eval()
    _widen(model, 1.0, ("shared.weight", "lm_head.weight"))
    _widen(model, 0.2, (".q.weight", ".k.weight", ".v.weight", ".o.weight", ".wi.weight",
                        ".wi_0.weight", ".wi_1.weight", ".wo.weight"))
    return _save(model, d, cfg.vocab_size)


def _rand(rng, *shape, scale=0.05):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _save_tensors(d: str, cfg: dict, tensors: dict) -> str:
    from safetensors.numpy import save_file

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    save_file({k: np.asarray(v, np.float32) for k, v in tensors.items()},
              os.path.join(d, "model.safetensors"))
    return d


def hf_minicpm3(d: str) -> str:
    """MiniCPM3 (MLA with a q LoRA, LongRoPE factors), 2 layers."""
    rng = np.random.default_rng(12)
    nv, ne, nh, nl, nff = 128, 64, 4, 2, 96
    qlora, kvlora, qk_nope, qk_rope, vdim = 32, 16, 8, 8, 8
    cfg = {"architectures": ["MiniCPM3ForCausalLM"], "vocab_size": nv, "hidden_size": ne,
           "num_attention_heads": nh, "num_key_value_heads": nh, "intermediate_size": nff,
           "num_hidden_layers": nl, "max_position_embeddings": 512, "rms_norm_eps": 1e-6,
           "q_lora_rank": qlora, "kv_lora_rank": kvlora, "qk_nope_head_dim": qk_nope,
           "qk_rope_head_dim": qk_rope, "v_head_dim": vdim, "scale_emb": 12.0,
           "scale_depth": 1.4, "dim_model_base": 256,
           "rope_scaling": {"type": "longrope", "long_factor": [1.0, 1.5, 2.0, 4.0],
                            "short_factor": [1.0, 1.1, 0.9, 1.2]}}
    t = {"model.embed_tokens.weight": _rand(rng, nv, ne, scale=0.3),
         "model.norm.weight": 1.0 + _rand(rng, ne), "lm_head.weight": _rand(rng, nv, ne)}
    for i in range(nl):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1.0 + _rand(rng, ne)
        t[p + "post_attention_layernorm.weight"] = 1.0 + _rand(rng, ne)
        t[p + "self_attn.q_a_proj.weight"] = _rand(rng, qlora, ne, scale=0.2)
        t[p + "self_attn.q_a_layernorm.weight"] = 1.0 + _rand(rng, qlora)
        t[p + "self_attn.q_b_proj.weight"] = _rand(rng, nh * (qk_nope + qk_rope), qlora,
                                                   scale=0.3)
        t[p + "self_attn.kv_a_proj_with_mqa.weight"] = _rand(rng, kvlora + qk_rope, ne,
                                                             scale=0.2)
        t[p + "self_attn.kv_a_layernorm.weight"] = 1.0 + _rand(rng, kvlora)
        t[p + "self_attn.kv_b_proj.weight"] = _rand(rng, nh * (qk_nope + vdim), kvlora,
                                                    scale=0.3)
        t[p + "self_attn.o_proj.weight"] = _rand(rng, ne, nh * vdim, scale=0.2)
        t[p + "mlp.gate_proj.weight"] = _rand(rng, nff, ne, scale=0.2)
        t[p + "mlp.up_proj.weight"] = _rand(rng, nff, ne, scale=0.2)
        t[p + "mlp.down_proj.weight"] = _rand(rng, ne, nff, scale=0.2)
    _save_tensors(d, cfg, t)
    _write_tokenizer_json(d, nv)
    return d


def hf_rwkv6(d: str, rescale_every: int = 2, n_layers: int = 2) -> str:
    """RWKV-6 with 4 heads of 8, decay and first at the scale of
    tests/test_rwkv6.py's fixture, and an RWKV world vocabulary file."""
    rng = np.random.default_rng(17)
    nv, ne, hs, nff = 68, 32, 8, 64
    H = ne // hs
    tmx, tdx = 32, 64
    cfg = {"architectures": ["Rwkv6ForCausalLM"], "vocab_size": nv, "hidden_size": ne,
           "num_hidden_layers": n_layers, "head_size": hs, "intermediate_size": nff,
           "layer_norm_epsilon": 1e-5, "rescale_every": rescale_every}
    t = {"rwkv.embeddings.weight": _rand(rng, nv, ne, scale=0.5),
         "rwkv.blocks.0.pre_ln.weight": 1.0 + _rand(rng, ne),
         "rwkv.blocks.0.pre_ln.bias": _rand(rng, ne),
         "rwkv.ln_out.weight": 1.0 + _rand(rng, ne), "rwkv.ln_out.bias": _rand(rng, ne),
         "head.weight": _rand(rng, nv, ne, scale=0.3)}
    for i in range(n_layers):
        p = f"rwkv.blocks.{i}."
        for ln in ("ln1", "ln2"):
            t[p + ln + ".weight"] = 1.0 + _rand(rng, ne)
            t[p + ln + ".bias"] = _rand(rng, ne)
        a = p + "attention."
        for nm in ("time_maa_x", "time_maa_w", "time_maa_k", "time_maa_v", "time_maa_r",
                   "time_maa_g"):
            t[a + nm] = 0.5 + _rand(rng, 1, 1, ne)
        t[a + "time_maa_w1"] = _rand(rng, ne, 5 * tmx, scale=0.2)
        t[a + "time_maa_w2"] = _rand(rng, 5, tmx, ne, scale=0.2)
        t[a + "time_faaaa"] = _rand(rng, H, hs, scale=0.2)
        t[a + "time_decay"] = 0.5 + _rand(rng, 1, 1, ne)
        t[a + "time_decay_w1"] = _rand(rng, ne, tdx, scale=0.2)
        t[a + "time_decay_w2"] = _rand(rng, tdx, ne, scale=0.2)
        for nm in ("key", "value", "receptance", "gate"):
            t[a + nm + ".weight"] = _rand(rng, ne, ne, scale=0.2)
        t[a + "output.weight"] = _rand(rng, ne, ne, scale=0.2)
        t[a + "ln_x.weight"] = 1.0 + _rand(rng, ne)
        t[a + "ln_x.bias"] = _rand(rng, ne)
        f = p + "feed_forward."
        t[f + "time_maa_k"] = 0.5 + _rand(rng, 1, 1, ne)
        t[f + "time_maa_r"] = 0.5 + _rand(rng, 1, 1, ne)
        t[f + "key.weight"] = _rand(rng, nff, ne, scale=0.2)
        t[f + "receptance.weight"] = _rand(rng, ne, ne, scale=0.2)
        t[f + "value.weight"] = _rand(rng, ne, nff, scale=0.2)
    _save_tensors(d, cfg, t)
    # an RWKV world vocabulary file: "<id> <repr> <len>" lines
    with open(os.path.join(d, "rwkv_vocab_v20230424.txt"), "w") as f:
        for i in range(nv - 4):
            tok = bytes([97 + i]) if i < 26 else bytes([32 + i - 26]) if i < 42 else f"w{i}"
            blen = len(tok) if isinstance(tok, bytes) else len(tok.encode("utf-8"))
            f.write(f"{i + 1} {tok!r} {blen}\n")
    return d


def rewrite_gguf(src: str, dst: str, extra_kvs: dict) -> str:
    """`src` with `extra_kvs` added to its metadata, tensors copied as they
    are stored."""
    from prima_tpu.gguf.reader import GGUFModel
    from prima_tpu.gguf.writer import GGUFWriter

    m = GGUFModel.open(src)
    w = GGUFWriter(dst)
    for k, v in m.metadata.items():
        if not k.startswith("general.alignment"):
            w.add_kv(k, v)
    for k, v in extra_kvs.items():
        w.add_kv(k, v)
    for ti in m.tensors.values():
        w.add_tensor(ti.name, np.asarray(ti.data), ne=ti.ne, ggml_type=ti.ggml_type)
    w.write()
    m.close()
    return dst


def convert(converter, src: str, dst: str, ftype: str = "F32") -> str:
    """`converter` (either package's convert_hf_to_gguf) of src into dst."""
    with open(os.devnull, "w") as log:
        assert converter(src, dst, ftype, logfile=log) > 0
    return dst


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, both as f32 numpy arrays."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())
