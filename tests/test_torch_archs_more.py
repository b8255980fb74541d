"""The port's decoder against the JAX package's on the RMSNorm families
that share llama's layer under their own arch name (qwen2's qkv biases,
gemma's scaled embeddings and GELU, xverse, baichuan, refact's ALiBi): the
tiny GGUFs and the comparison of test_torch_archs.py, in f32 and Q8_0.
Baichuan's 40-layer ALiBi branch, plamo, internlm2 and llama's RoPE
scalings are in test_torch_archs_rope.py."""

import pytest

from test_torch_archs import F32, Q8_0, TOL, check_logits, run_both, write_model

NAMES = ["qwen2", "gemma", "xverse", "baichuan", "refact"]
CASES = [(n, ft) for n in NAMES for ft in (F32, Q8_0)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1].name}")
def run(request, tmp_path_factory):
    name, ftype = request.param
    path = write_model(tmp_path_factory.mktemp(name) / f"{name}.gguf", name, ftype)
    return run_both(path)


def test_logits_match_jax(run):
    check_logits(run, TOL)


def test_greedy_tokens_match_jax(run):
    assert run["port"] == run["jax"]


def test_flags_are_set(run):
    cfg = run["cfg"]
    assert {"qwen2": "bq" in run["params"]["layers"][0],
            "gemma": cfg.act == "gelu" and cfg.embd_scale == 8.0 and cfg.tie_embeddings,
            "baichuan": not cfg.alibi_max_bias and cfg.n_layers == 2,
            "refact": cfg.alibi_max_bias == 8.0,
            }.get(cfg.arch, cfg.norm_type == "rms")
