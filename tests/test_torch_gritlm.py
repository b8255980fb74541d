"""The port's gritlm tool against the JAX package's on the trained tiny
target, f32 activations on both sides: the bidirectional, instruction-
masked embeddings within 1e-5, the embed mode's printed rows within 1e-5
and its cosine lines equal, and the generate mode's text equal."""

import os

import numpy as np

from prima_tpu.tools import gritlm as jgritlm
from prima_tpu_torch.tools import gritlm
from test_torch_cli import f32  # noqa: F401
from test_torch_speculative import torch_one_thread  # noqa: F401
from test_torch_tools import both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")


def _embedding_rows(out: str) -> np.ndarray:
    return np.asarray([[float(x) for x in ln.split(":", 1)[1].split()[:8]]
                       for ln in out.splitlines() if ln.startswith("embedding ")])


def test_gritlm_embeddings_match_jax(f32):
    from prima_tpu.models.loader import load_model as jload_model
    from prima_tpu_torch.models.loader import load_model

    m, jm = load_model(TARGET, device="cpu"), jload_model(TARGET)
    sentences = ["hello world", "goodbye moon"]
    inst = gritlm.gritlm_instruction("retrieve stuff")
    got = gritlm.encode(m, sentences, inst, "kernel", "cpu")
    want = jgritlm.encode(jm, sentences, jgritlm.gritlm_instruction("retrieve stuff"), "xla")
    assert got.shape == want.shape == (2, m.cfg.n_embd)
    assert np.abs(got - want).max() <= 1e-5
    assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-4)


def test_gritlm_tool_matches_jax(f32, capsys):
    """The embed mode's printed rows (6 decimals) within 1e-5 and the same
    cosine line; the generate mode's text equal."""
    want, got = both(jgritlm.main, gritlm.main,
                     ["-m", TARGET, "--mode", "embed", "-p", "a b\\nc d"], capsys)
    assert np.abs(_embedding_rows(got) - _embedding_rows(want)).max() <= 1e-5
    assert _embedding_rows(got).shape == (2, 8)
    assert [ln for ln in got.splitlines() if ln.startswith("cosine")] == \
        [ln for ln in want.splitlines() if ln.startswith("cosine")] != []
    want, got = both(jgritlm.main, gritlm.main,
                     ["-m", TARGET, "--mode", "generate", "-p", "Once upon", "-n", "12"],
                     capsys)
    assert got == want and len(got.strip()) > 4


