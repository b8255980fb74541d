"""Mixture-of-experts in the port against the JAX package: Mixtral (llama
with experts, normalized top-k weights), qwen2moe (raw top-k weights and a
shared expert), grok (GELU experts, softcap, post norms), arctic (a
dense FFN beside the experts) and granitemoe (four scale knobs), as tiny GGUFs in f32, Q8_0 and Q4_K through
both packages' load_params and forward: logits within 2e-4 * max |logit|,
16 greedy steps identical. The expert-indexed GEMV and the MoE paths
around it are in test_torch_moe_paths.py."""

import numpy as np
import pytest

from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.models.config import ModelConfig
from test_torch_archs import F32, MOE_TOL, Q4_K, Q8_0, check_logits, run_both, write_model

CASES = [("mixtral", F32), ("mixtral", Q8_0), ("mixtral", Q4_K), ("qwen2moe", F32),
         ("qwen2moe", Q8_0), ("grok", F32), ("arctic", F32), ("granitemoe", F32),
         ("granitemoe", Q8_0)]


def _write(tmp_path_factory, name, ftype):
    wide = ftype == Q4_K  # Q4_K rows are whole blocks of 256
    return write_model(tmp_path_factory.mktemp(name) / f"{name}.gguf", name, ftype,
                       n_embd=256 if wide else 64, n_ff=256 if wide else 96)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1].name}")
def run(request, tmp_path_factory):
    return run_both(_write(tmp_path_factory, *request.param))


def test_logits_match_jax(run):
    check_logits(run, MOE_TOL)


def test_greedy_tokens_match_jax(run):
    assert run["port"] == run["jax"]


@pytest.mark.parametrize("name", ["mixtral", "qwen2moe"])
def test_one_row_decode_matches_jax(tmp_path_factory, name):
    """One row: the JAX package takes its dynamic-slice path (b * s == 1)."""
    r = run_both(_write(tmp_path_factory, name, Q8_0), b=1, s=6, steps=8)
    for got, want in zip(r["port_logits"], r["jax_logits"]):
        assert np.abs(got - want).max() <= MOE_TOL * np.abs(want).max()
    assert r["port"] == r["jax"]


def test_moe_flags_are_set(tmp_path):
    cfgs = {n: ModelConfig.from_gguf(GGUFModel.open(write_model(tmp_path / f"{n}.gguf", n)))
            for n in ("mixtral", "qwen2moe", "grok", "arctic")}
    assert all((c.n_expert, c.n_expert_used) == (4, 2) for c in cfgs.values())
    assert cfgs["mixtral"].arch == "llama" and cfgs["mixtral"].moe_norm_w
    assert not cfgs["qwen2moe"].moe_norm_w
    assert cfgs["grok"].post_norms and cfgs["grok"].attn_logit_softcap == 30.0
    assert cfgs["arctic"].moe_parallel_dense
