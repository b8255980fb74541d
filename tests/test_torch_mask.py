"""The port's forward(attn_mask=) against the JAX package's, in f32: the
lookahead decoder's token-tree mask over a cached prefix and a
bidirectional zero mask, on the trained tiny llama and on a tiny bloom
(ALiBi, where the slopes scale the caller's mask). With attn_impl="kernel"
a mask takes the plain masked attention, so the logits equal those of
attn_impl="plain" bit for bit."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.gguf.reader import GGUFModel as JGGUFModel
from prima_tpu.models.config import ModelConfig as JModelConfig
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import forward as jforward
from prima_tpu.models.llama import init_kv_caches as jinit_kv
from prima_tpu.models.llama import load_params as jload_params
from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.models.config import ModelConfig
from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches, load_params
from prima_tpu_torch.runtime.lookahead import tree_layout
from test_torch_archs import F32, write_model
from test_torch_speculative import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
JOPTS = JOpts(matmul_impl="xla", dtype=jnp.float32)
OPTS = ForwardOptions(dtype=torch.float32)
TOL = 1e-5  # of max |logit|
T = 48  # cache cells
PREFIX = 9  # cached tokens before the tree
W, N, G = 4, 3, 2  # S = 1 + 4 + 3 + 4 = 12 tree rows


@pytest.fixture(scope="module", params=["llama", "bloom"])
def models(request, tmp_path_factory):
    path = (TARGET if request.param == "llama"
            else write_model(tmp_path_factory.mktemp("bloom") / "bloom.gguf", "bloom", F32))
    jm = JGGUFModel.open(path)
    jcfg = JModelConfig.from_gguf(jm)
    pm = GGUFModel.open(path)
    cfg = ModelConfig.from_gguf(pm)
    assert bool(cfg.alibi_max_bias) == (request.param == "bloom")
    return {"jcfg": jcfg, "jparams": jload_params(jm, jcfg, dtype=jnp.float32),
            "cfg": cfg, "params": load_params(pm, cfg, "cpu", dtype=torch.float32)}


def _tree_mask(pos0: int) -> tuple[np.ndarray, np.ndarray]:
    """(positions (1, S), additive mask (1, 1, S, T)) of one lookahead step
    at pos0: the cached prefix plus the tree among the step's rows."""
    offs, vis = tree_layout(W, N, G)
    s = len(offs)
    cols = np.arange(T)
    rel = cols - pos0
    in_scratch = (rel >= 0) & (rel < s)
    visible = (cols < pos0)[None] | (in_scratch[None] & vis[:, np.clip(rel, 0, s - 1)])
    mask = np.where(visible, 0.0, -np.inf).astype(np.float32)[None, None]
    return (pos0 + offs)[None].astype(np.int32), mask


def _run(m, toks, pos, mask, t, prefix=None, opts=OPTS, jax_side=True):
    """JAX (None unless jax_side) and port logits of one masked forward over
    a fresh f32 cache of t cells, after a causal prefill of `prefix` where
    given."""
    jkv = jinit_kv(m["jcfg"], 1, t, jnp.float32)
    pkv = init_kv_caches(m["cfg"], 1, t, torch.float32, "cpu")
    pos0 = 0
    if prefix is not None:
        ppos = np.arange(len(prefix), dtype=np.int32)[None]
        if jax_side:
            _, jkv = jforward(m["jparams"], m["jcfg"], prefix[None], ppos, jkv,
                              np.zeros(1, np.int32), JOPTS)
        with torch.no_grad():
            forward(m["params"], m["cfg"], torch.from_numpy(prefix[None]).long(),
                    torch.from_numpy(ppos), pkv, torch.zeros(1, dtype=torch.int32), opts)
        pos0 = len(prefix)
    jl = None
    if jax_side:
        jl, _ = jax.jit(lambda p, kv: jforward(p, m["jcfg"], toks[None], pos, kv,
                                               np.full(1, pos0, np.int32), JOPTS,
                                               attn_mask=mask))(m["jparams"], jkv)
        jl = np.asarray(jl)
    with torch.no_grad():
        pl, _ = forward(m["params"], m["cfg"], torch.from_numpy(toks[None]).long(),
                        torch.from_numpy(pos), pkv, torch.full((1,), pos0, dtype=torch.int32),
                        opts, attn_mask=torch.from_numpy(mask))
    return jl, pl.numpy()


def _inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    s = len(tree_layout(W, N, G)[0])
    prefix = rng.integers(0, cfg.n_vocab, PREFIX).astype(np.int32)
    toks = rng.integers(0, cfg.n_vocab, s).astype(np.int32)
    return prefix, toks


def test_tree_mask_matches_jax(models):
    prefix, toks = _inputs(models["cfg"])
    pos, mask = _tree_mask(PREFIX)
    want, got = _run(models, toks, pos, mask, T, prefix)
    assert got.shape == want.shape == (1, len(toks), models["cfg"].n_vocab)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_bidirectional_mask_matches_jax(models):
    _, toks = _inputs(models["cfg"], seed=4)
    n = len(toks)
    pos = np.arange(n, dtype=np.int32)[None]
    mask = np.zeros((1, 1, n, n), np.float32)
    want, got = _run(models, toks, pos, mask, n)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    # the zero mask is not the causal one: the first row sees later tokens
    causal = np.where(np.tril(np.ones((n, n), bool)), 0.0, -np.inf).astype(np.float32)
    _, got_causal = _run(models, toks, pos, causal[None, None], n, jax_side=False)
    assert np.abs(got[0, 0] - got_causal[0, 0]).max() > 1e-3


@pytest.mark.parametrize("kind", ["tree", "bidirectional"])
def test_kernel_route_takes_the_masked_path(models, kind):
    prefix, toks = _inputs(models["cfg"], seed=5)
    if kind == "tree":
        pos, mask = _tree_mask(PREFIX)
        t = T
    else:
        prefix, t = None, len(toks)
        pos = np.arange(t, dtype=np.int32)[None]
        mask = np.zeros((1, 1, t, t), np.float32)
    _, plain = _run(models, toks, pos, mask, t, prefix, jax_side=False)
    _, kernel = _run(models, toks, pos, mask, t, prefix, jax_side=False,
                     opts=dataclasses.replace(OPTS, attn_impl="kernel"))
    np.testing.assert_array_equal(kernel, plain)
