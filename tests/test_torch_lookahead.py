"""The port's lookahead decoder against the JAX package's, on a 2-layer
tiny model with seeded Q4_K weights, f32 activations and KV: the cases of
tests/test_lookahead.py (lossless against plain greedy at the test's
window, at the reference defaults W = 15, N = 5, G = 15 and at a larger
window; a seeded pool that accepts and saves steps; pool dedup and ring;
the guards; a long run with pool churn; seeded sampling), each also
giving the JAX LookaheadDecoder's tokens and LookaheadStats. Over a q8_0
cache the tokens equal the JAX decoder's and the cache codes are within
one code of its own; a commit copies codes and scales."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.gguf.constants import GGMLType
from prima_tpu.models.config import tiny_config as jtiny_config
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import synth_params
from prima_tpu.runtime.engine import Engine as JEngine
from prima_tpu.runtime.lookahead import LookaheadDecoder as JLookahead
from prima_tpu.sampling import Sampler as JSampler
from prima_tpu.sampling import SamplerParams as JSamplerParams
from prima_tpu_torch.models.config import tiny_config
from prima_tpu_torch.models.llama import ForwardOptions, params_from_numpy
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.runtime.lookahead import LookaheadDecoder, _NgramPool
from prima_tpu_torch.sampling import Sampler, SamplerParams
from test_torch_model import _flatten_jax
from test_torch_speculative import torch_one_thread  # noqa: F401

MAX_SEQ = 256


@pytest.fixture(scope="module")
def model():
    jparams = synth_params(jtiny_config(n_layers=2), GGMLType.Q4_K, seed=5)
    return {"jcfg": jtiny_config(n_layers=2), "jparams": jparams,
            "cfg": tiny_config(n_layers=2),
            "params": params_from_numpy(_flatten_jax(jparams), "cpu")}


def _engine(m, kv_dtype=torch.float32):
    return Engine(m["cfg"], m["params"], n_slots=1, max_seq=MAX_SEQ, n_batch=32,
                  opts=ForwardOptions(dtype=torch.float32), kv_dtype=kv_dtype, device="cpu")


def _jengine(m, kv_dtype=jnp.float32):
    return JEngine(m["jcfg"], m["jparams"], n_slots=1, max_seq=MAX_SEQ, n_batch=32,
                   opts=JOpts(matmul_impl="xla", dtype=jnp.float32), kv_dtype=kv_dtype,
                   scan=False)


def _greedy(jax_side: bool = False):
    return (JSampler(JSamplerParams(temp=0.0)) if jax_side
            else Sampler(SamplerParams(temp=0.0)))


def _both(m, prompt, n, W, N, G, pool=None, sampler=None, jsampler=None,
          kv=(torch.float32, jnp.float32)):
    """The port's and the JAX decoder's (tokens, stats) for one request,
    each pool seeded with `pool` ((first, body) pairs) where given."""
    out = {}
    for side, dec in (("port", LookaheadDecoder(_engine(m, kv[0]), W=W, N=N, G=G)),
                      ("jax", JLookahead(_jengine(m, kv[1]), W=W, N=N, G=G))):
        for first, body in pool or ():
            dec.pool.add(first, body)
        s = (jsampler() if side == "jax" else sampler()) if sampler else _greedy(side == "jax")
        toks, stats = dec.generate(prompt, s, n_predict=n)
        out[side] = (toks, dataclasses.astuple(stats), dec)
    assert out["port"][:2] == out["jax"][:2]
    return out


@pytest.fixture(scope="module")
def plain(model):
    """Plain greedy streams of the port's engine, cached by (prompt, n)."""
    cache = {}

    def get(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            cache[key] = _engine(model).run_to_completion(list(prompt), n_predict=n)
        return cache[key]
    return get


@pytest.mark.parametrize("W,N,G", [(4, 3, 3), (15, 5, 15)], ids=["test-window", "defaults"])
def test_lossless_vs_plain_greedy(model, plain, W, N, G):
    prompt = [3, 17, 42, 7, 99, 5]
    out = _both(model, prompt, 24, W, N, G)
    toks, stats, dec = out["port"]
    assert toks == plain(prompt, 24)
    assert stats[0] >= 24
    if (W, N, G) == (15, 5, 15):
        assert dec.S == 120


def test_lossless_larger_window(model, plain):
    prompt = [11, 2, 63]
    out = _both(model, prompt, 16, 6, 4, 4)
    assert out["port"][0] == plain(prompt, 16)


def test_seeded_pool_accepts_and_saves_steps(model, plain):
    prompt = [3, 17, 42, 7]
    n, N = 20, 4
    want = plain(prompt, n)
    path = [prompt[-1]] + want
    pool = [(path[i], np.asarray(path[i + 1: i + N], np.int32))
            for i in range(len(path) - (N - 1))]
    toks, (n_predict, n_accept, n_steps), _ = _both(model, prompt, n, 4, N, 4, pool)["port"]
    assert toks == want
    assert n_accept > 0
    assert n_steps <= -(-n // (N - 1)) + 1


def test_pool_dedup_and_ring():
    pool = _NgramPool(n_vocab=32, N=3, G=2)
    pool.add(5, np.asarray([1, 2], np.int32))
    pool.add(5, np.asarray([1, 2], np.int32))  # duplicate: dropped
    assert pool.cnt[5] == 1
    pool.add(5, np.asarray([3, 4], np.int32))
    assert pool.cnt[5] == 2
    pool.add(5, np.asarray([5, 6], np.int32))  # ring wraps, cnt capped at G
    assert pool.cnt[5] == 2
    assert {tuple(g) for g in pool.tokens[5]} == {(5, 6), (3, 4)}


@pytest.mark.parametrize("bad", ["N<3", "alibi", "swa"])
def test_guards(model, bad):
    eng = _engine(model)
    if bad == "N<3":
        with pytest.raises(ValueError):
            LookaheadDecoder(eng, W=4, N=2, G=4)
        return
    field, value = {"alibi": ("alibi_max_bias", 8.0), "swa": ("swa_window", 16)}[bad]
    eng.cfg = dataclasses.replace(model["cfg"], **{field: value})
    with pytest.raises(ValueError):
        LookaheadDecoder(eng, W=4, N=3, G=4)


def test_lossless_long_run_with_pool_churn(model, plain):
    prompt = [7, 7, 7, 9]
    toks, stats, _ = _both(model, prompt, 32, 5, 4, 3)["port"]
    assert toks == plain(prompt, 32)
    assert stats[2] >= 1


def test_seeded_sampling_deterministic(model):
    prompt = [3, 17, 42]
    n_vocab = model["cfg"].n_vocab

    def run():
        return _both(model, prompt, 12, 4, 3, 3,
                     sampler=lambda: Sampler(SamplerParams(temp=0.9, seed=11), n_vocab=n_vocab),
                     jsampler=lambda: JSampler(JSamplerParams(temp=0.9, seed=11),
                                               n_vocab=n_vocab))["port"][0]

    assert run() == run()


def test_q8_0_cache_tokens_and_codes(model):
    prompt = [3, 17, 42, 7, 99, 5]
    out = _both(model, prompt, 24, 4, 3, 3, kv=("q8_0", "q8_0"))
    pdec, jdec = out["port"][2], out["jax"][2]
    used = pdec.engine.kv.used(0)
    assert used == int(jdec.engine.kv.used(0)) > len(prompt)
    for (pk, pv), (jk, jv) in zip(pdec.engine.kv.caches, jdec.engine.kv.caches):
        for p, j in ((pk, jk), (pv, jv)):
            diff = p.qs[0, :used].int().numpy() - np.asarray(j.qs)[0, :used].astype(np.int32)
            assert np.abs(diff).max() <= 1


def test_commit_copies_codes_and_scales(model):
    eng = _engine(model, "q8_0")
    dec = LookaheadDecoder(eng, W=4, N=3, G=3)
    gen = torch.Generator().manual_seed(0)
    for k, v in eng.kv.caches:
        for c in (k, v):
            c.qs.copy_(torch.randint(-127, 128, c.qs.shape, generator=gen, dtype=torch.int8))
            c.scale.copy_(torch.rand(c.scale.shape, generator=gen))
    src0, dst0 = 10 + 1 + 2 * (dec.N - 1), 11
    want = [[(c.qs[0, src0:src0 + 2].clone(), c.scale[0, src0:src0 + 2].clone())
             for c in kv] for kv in eng.kv.caches]
    dec._commit(0, src0, dst0)
    for kv, w in zip(eng.kv.caches, want):
        for c, (qs, sc) in zip(kv, w):
            assert torch.equal(c.qs[0, dst0:dst0 + 2], qs)
            assert torch.equal(c.scale[0, dst0:dst0 + 2], sc)
