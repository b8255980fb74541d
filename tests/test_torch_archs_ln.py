"""The port's decoder against the JAX package's on the LayerNorm arch
families (parallel blocks, biases, fused qkv, ALiBi, learned positions,
q/k/v clamping, embedding norm, scaled and biased logits, falcon-40b's
second attention norm, olmo's norms without weights, jais's biased gate,
starcoder, orion, codeshell):
the tiny GGUFs and the comparison of test_torch_archs.py."""

import pytest

from test_torch_archs import F32, Q8_0, TOL, check_logits, run_both, write_model

CASES = [("phi2", F32), ("command-r", F32), ("starcoder2", F32), ("bloom", F32),
         ("mpt", Q8_0), ("gpt2", F32), ("gpt2", Q8_0), ("falcon", F32), ("falcon", Q8_0),
         ("olmo", F32), ("jais", F32), ("starcoder", F32), ("starcoder", Q8_0), ("orion", F32),
         ("orion", Q8_0), ("codeshell", F32), ("codeshell", Q8_0)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1].name}")
def run(request, tmp_path_factory):
    name, ftype = request.param
    return run_both(write_model(tmp_path_factory.mktemp(name) / f"{name}.gguf", name, ftype))


def test_logits_match_jax(run):
    check_logits(run, TOL)


def test_greedy_tokens_match_jax(run):
    assert run["port"] == run["jax"]


def test_ln_flags_are_set(run):
    cfg, layer = run["cfg"], run["params"]["layers"][0]
    assert cfg.norm_type == "ln"
    assert {"phi2": cfg.parallel_block, "command-r": cfg.parallel_block and cfg.logit_scale == 0.5,
            "starcoder2": not cfg.ffn_gated, "bloom": cfg.alibi_max_bias == 8.0 and cfg.tok_embd_norm,
            "mpt": cfg.alibi_max_bias == 8.0 and cfg.clamp_kqv == pytest.approx(0.3),
            "gpt2": cfg.pos_embd and cfg.rope_dim == 0,
            # attn_norm_2 becomes the parallel MLP's own norm
            "falcon": cfg.parallel_block and layer.get("ffn_norm_b") is not None,
            "olmo": all(layer.get(k) is None for k in ("attn_norm", "ffn_norm"))
            and run["params"].get("output_norm") is None,
            "jais": cfg.alibi_max_bias == 8.0 and layer.get("b_gate") is not None,
            "starcoder": cfg.pos_embd and cfg.rope_dim == 0,
            "orion": layer.get("attn_norm_b") is not None,
            "codeshell": not cfg.ffn_gated and cfg.act == "gelu",
            }[cfg.arch]
