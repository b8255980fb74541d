"""The port's forward against the JAX package's, in f32, on the trained tiny
model (models_tiny_pair/target.gguf, Q8_0) and on a Q4_K make_tiny_gguf
model of width 512: logits within 1e-4 * max |logit|, and identical greedy
tokens over a prefill plus 16 decode steps."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.gguf.constants import GGMLType
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import forward as jforward
from prima_tpu.models.llama import init_kv_caches as jinit_kv
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.tools.make_tiny_gguf import make_tiny_gguf
from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
from prima_tpu_torch.models.llama import params_from_numpy
from prima_tpu_torch.models.loader import load_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
JOPTS = JOpts(matmul_impl="xla", dtype=jnp.float32)
OPTS = ForwardOptions(dtype=torch.float32)
T = 64
TOL = 1e-4


@pytest.fixture(scope="module", params=["pair-q8_0", "tiny512-q4_k"])
def models(request, tmp_path_factory):
    if request.param == "pair-q8_0":
        path = PAIR
    else:
        path = str(tmp_path_factory.mktemp("m") / "tiny512.gguf")
        make_tiny_gguf(path, vocab_from=None, n_layers=2, n_embd=512, n_heads=8,
                       n_kv_heads=4, n_ff=1024, ftype=GGMLType.Q4_K, seed=3)
    jm = jload_model(path)
    cfg = jm.cfg
    jfwd = jax.jit(lambda p, t, pos, kv, cp: jforward(p, cfg, t, pos, kv, cp, JOPTS))
    return path, jm, jfwd, load_model(path, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.n_vocab, (b, s)).astype(np.int32)


def _port_logits(params, cfg, toks, opts=OPTS):
    b, s = toks.shape
    kv = init_kv_caches(cfg, b, T, torch.float32, "cpu")
    pos = torch.from_numpy(np.tile(np.arange(s, dtype=np.int32), (b, 1)))
    with torch.no_grad():
        logits, _ = forward(params, cfg, torch.from_numpy(toks).long(), pos, kv,
                            torch.zeros(b, dtype=torch.int32), opts)
    return logits.numpy()


def _jax_logits(jm, jfwd, toks):
    b, s = toks.shape
    kv = jinit_kv(jm.cfg, b, T, jnp.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    logits, _ = jfwd(jm.params, toks, pos, kv, np.zeros(b, np.int32))
    return np.asarray(logits)


def test_logits_match_jax(models):
    _, jm, jfwd, m = models
    toks = _tokens(m.cfg, 2, 12, seed=1)
    want = _jax_logits(jm, jfwd, toks)
    got = _port_logits(m.params, m.cfg, toks)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_greedy_tokens_match_jax(models):
    """Prefill 10 tokens on 2 rows, then 16 greedy decode steps."""
    _, jm, jfwd, m = models
    cfg = m.cfg
    toks = _tokens(cfg, 2, 10, seed=2)
    b, s = toks.shape
    jkv = jinit_kv(cfg, b, T, jnp.float32)
    pkv = init_kv_caches(cfg, b, T, torch.float32, "cpu")
    jcur, pcur = toks, toks
    jstream, pstream = [], []
    pos0 = 0
    for _ in range(17):
        n = jcur.shape[1]
        pos = np.tile(np.arange(pos0, pos0 + n, dtype=np.int32), (b, 1))
        jl, jkv = jfwd(jm.params, jcur, pos, jkv, np.full(b, pos0, np.int32))
        with torch.no_grad():
            pl, _ = forward(m.params, cfg, torch.from_numpy(pcur).long(),
                            torch.from_numpy(pos), pkv,
                            torch.full((b,), pos0, dtype=torch.int32), OPTS)
        jnext = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        pnext = pl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        jstream.append(jnext[:, 0].tolist())
        pstream.append(pnext[:, 0].tolist())
        pos0 += n
        jcur, pcur = jnext, pnext
    assert pstream == jstream


def _flatten_jax(tree):
    """JAX params -> numpy leaves, QTensors as dicts of their fields."""
    from prima_tpu.quant.dequant_jax import QTensor as JQTensor

    if isinstance(tree, JQTensor):
        arr = lambda a: None if a is None else np.asarray(a)
        return {"qs": arr(tree.qs), "scales": arr(tree.scales), "mins": arr(tree.mins),
                "d": arr(tree.d), "dmin": arr(tree.dmin), "sub": tree.sub,
                "layout": tree.layout, "q_offset": tree.q_offset, "shape": tree.shape,
                "kperm": tree.kperm, "gsub": tree.gsub, "packed": tree.packed}
    if isinstance(tree, dict):
        return {k: _flatten_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_flatten_jax(v) for v in tree]
    if tree is None:
        return None
    return np.asarray(jax.device_get(tree)).astype(np.float32)


def test_params_from_numpy_match_jax(models):
    """The JAX package's own device params (sigma-permuted, packed) carried
    across give the JAX logits."""
    _, jm, jfwd, m = models
    params = params_from_numpy(_flatten_jax(jm.params), "cpu")
    toks = _tokens(m.cfg, 1, 7, seed=3)
    want = _jax_logits(jm, jfwd, toks)
    got = _port_logits(params, m.cfg, toks)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_fused_weights_same_logits(models):
    path, _, _, m = models
    fused = load_model(path, device="cpu", fuse=True)
    assert "wqkv" in fused.params["layers"][0] and "w_gateup" in fused.params["layers"][0]
    toks = _tokens(m.cfg, 1, 5, seed=4)
    np.testing.assert_allclose(_port_logits(fused.params, m.cfg, toks),
                               _port_logits(m.params, m.cfg, toks), rtol=0, atol=1e-5)


@pytest.mark.parametrize("extra", ["cvec", "lora"])
def test_adapter_layers_raise(models, extra):
    """A layer's control vector or LoRA adapter is no longer refused: it
    moves the port's logits as it moves the JAX forward's (the GGUF-level
    checks are in test_torch_adapters.py)."""
    _, jm, jfwd, m = models
    cfg = m.cfg
    rng = np.random.default_rng(6)
    if extra == "cvec":
        vec = (rng.standard_normal(cfg.n_embd) * 0.5).astype(np.float32)
        add, jadd = {"cvec": torch.from_numpy(vec)}, {"cvec": jnp.asarray(vec)}
    else:
        a = (rng.standard_normal((4, cfg.n_ff)) * 0.3).astype(np.float32)
        b = (rng.standard_normal((cfg.n_embd, 4)) * 0.3).astype(np.float32)
        add = {"w_down_lora": [(torch.from_numpy(a), torch.from_numpy(b), 2.0)]}
        jadd = {"w_down_lora": [(jnp.asarray(a), jnp.asarray(b), 2.0)]}
    layers = [dict(layer) for layer in m.params["layers"]]
    layers[-1].update(add)
    jlayers = [dict(layer) for layer in jm.params["layers"]]
    jlayers[-1].update(jadd)
    toks = _tokens(cfg, 1, 3, seed=5)
    got = _port_logits(dict(m.params, layers=layers), cfg, toks)
    kv = jinit_kv(cfg, 1, T, jnp.float32)
    pos = np.arange(toks.shape[1], dtype=np.int32)[None]
    want = np.asarray(jfwd(dict(jm.params, layers=jlayers), toks, pos, kv,
                           np.zeros(1, np.int32))[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    assert np.abs(got - _port_logits(m.params, cfg, toks)).max() > 10 * TOL * np.abs(want).max()


def test_default_device_is_cuda():
    from prima_tpu_torch import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_model(PAIR)
