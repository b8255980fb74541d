"""The port's decoder against the JAX package's on the LayerNorm arch
families (parallel blocks, biases, fused qkv, ALiBi, learned positions,
q/k/v clamping, embedding norm, scaled and biased logits): the tiny GGUFs
and the comparison of test_torch_archs.py."""

import pytest

from test_torch_archs import F32, Q8_0, TOL, check_logits, run_both, write_model

CASES = [("phi2", F32), ("command-r", F32), ("starcoder2", F32), ("bloom", F32),
         ("mpt", Q8_0), ("gpt2", F32), ("gpt2", Q8_0)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1].name}")
def run(request, tmp_path_factory):
    name, ftype = request.param
    return run_both(write_model(tmp_path_factory.mktemp(name) / f"{name}.gguf", name, ftype))


def test_logits_match_jax(run):
    check_logits(run, TOL)


def test_greedy_tokens_match_jax(run):
    assert run["port"] == run["jax"]


def test_ln_flags_are_set(run):
    cfg = run["cfg"]
    assert cfg.norm_type == "ln"
    assert {"phi2": cfg.parallel_block, "command-r": cfg.parallel_block and cfg.logit_scale == 0.5,
            "starcoder2": not cfg.ffn_gated, "bloom": cfg.alibi_max_bias == 8.0 and cfg.tok_embd_norm,
            "mpt": cfg.alibi_max_bias == 8.0 and cfg.clamp_kqv == pytest.approx(0.3),
            "gpt2": cfg.pos_embd and cfg.rope_dim == 0}[cfg.arch]
