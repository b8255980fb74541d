"""The port's decoder against the JAX package's on Baichuan-13B's branch
(40 layers take ALiBi in place of RoPE; 8 decode steps), plamo's parallel
block, internlm2, and llama's YaRN and linear RoPE scaling: the tiny GGUFs
and the comparison of test_torch_archs.py, in f32 and Q8_0. The other
llama-like families are in test_torch_archs_more.py."""

import pytest

from test_torch_archs import F32, Q8_0, TOL, check_logits, run_both, write_model

NAMES = ["baichuan-40l", "plamo", "internlm2", "llama-yarn", "llama-linear"]
CASES = [(n, ft) for n in NAMES for ft in (F32, Q8_0)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1].name}")
def run(request, tmp_path_factory):
    name, ftype = request.param
    path = write_model(tmp_path_factory.mktemp(name) / f"{name}.gguf", name, ftype)
    return run_both(path, steps=8 if name == "baichuan-40l" else 16)


def test_logits_match_jax(run):
    check_logits(run, TOL)


def test_greedy_tokens_match_jax(run):
    assert run["port"] == run["jax"]


def test_flags_are_set(run):
    cfg = run["cfg"]
    name = "llama-" + cfg.rope_scaling.kind if cfg.arch == "llama" else cfg.arch
    assert {"baichuan": cfg.alibi_max_bias == 8.0 and cfg.n_layers == 40,
            "plamo": cfg.parallel_block,
            "llama-yarn": cfg.rope_scaling.factor == 4.0 and cfg.rope_scaling.orig_ctx == 128,
            "llama-linear": cfg.rope_scaling.factor == 2.0,
            }.get(name, cfg.norm_type == "rms")
