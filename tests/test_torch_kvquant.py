"""The port's quantized KV caches (ops/kvquant.py, runtime/kv.py) against
the JAX package's: KVQ8 / KVQ4 codes and scales bit for bit after
quantize, update_kv, a context shift, a rope shift and seq_div, and the
same dense values after to() / astype()."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.models.config import tiny_config as jtiny_config
from prima_tpu.ops import kvquant as jkvq
from prima_tpu.runtime.kv import KVCache as JKVCache
from prima_tpu_torch.models.config import tiny_config
from prima_tpu_torch.models.llama import init_kv_caches
from prima_tpu_torch.ops import kvquant as kvq
from prima_tpu_torch.runtime.kv import KVCache

KINDS = {"q8_0": (kvq.KVQ8, jkvq.KVQ8, kvq.quantize_kv, jkvq.quantize_kv),
         "q4_0": (kvq.KVQ4, jkvq.KVQ4, kvq.quantize_kv4, jkvq.quantize_kv4)}


def _values(shape, seed):
    """Normal values at several magnitudes, a zero vector, and values that
    land exactly half way between two codes (round half to even)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-3, 3, shape[:-1] + (1,)).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0
    ties = x.reshape(-1, shape[-1])[1]
    ties[:] = np.arange(shape[-1], dtype=np.float32) * 0.5 - 2.75
    ties[0] = 127.0 * 0.5  # int8 scale 0.5: element i > 0 lands on i - 5.5
    return x


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_bit_exact(kind, dtype):
    _, _, quant, jquant = KINDS[kind]
    x = _values((3, 7, 4, 64), seed=1)
    jq, js = jquant(jnp.asarray(x, getattr(jnp, dtype)))
    q, s = quant(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), np.asarray(js))


@pytest.mark.parametrize("kind", list(KINDS))
def test_update_kv_codes_and_values_match_jax(kind):
    cls, jcls, _, _ = KINDS[kind]
    shape = (3, 16, 2, 32)
    cache, jcache = cls.zeros(shape), jcls.zeros(shape)
    rng = np.random.default_rng(2)
    for s, pos in [(5, [0, 3, 14]), (1, [5, 8, 15]), (4, [9, 20, 0])]:
        new = rng.standard_normal((3, s, 2, 32)).astype(np.float32)
        out = kvq.update_kv(cache, torch.from_numpy(new), torch.tensor(pos, dtype=torch.int32))
        assert out is cache  # in place
        jcache = jkvq.update_kv(jcache, jnp.asarray(new), jnp.asarray(pos, jnp.int32))
    assert cache.shape == tuple(jcache.shape) == shape
    np.testing.assert_array_equal(cache.qs.numpy(), np.asarray(jcache.qs))
    np.testing.assert_array_equal(cache.scale.numpy(), np.asarray(jcache.scale))
    for td, jd in [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]:
        np.testing.assert_array_equal(cache.to(td).float().numpy(),
                                      np.asarray(jcache.astype(jd).astype(jnp.float32)))
    assert kvq.kv_seq_len(cache) == jkvq.kv_seq_len(jcache) == 16


@pytest.mark.parametrize("new_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "q8_0", "q4_0"])
def test_update_kv_pair_matches_two_jax_update_kv(kind, new_dtype):
    """One update_kv_pair (the fused KV store) against update_kv for K and
    for V in the JAX package: dense values, codes and scales bit for bit,
    rows of another float type cast, the write start clamped to T - S."""
    shape = (3, 16, 2, 32)
    if kind in KINDS:
        cls, jcls, _, _ = KINDS[kind]
        caches = (cls.zeros(shape), cls.zeros(shape))
        jcaches = (jcls.zeros(shape), jcls.zeros(shape))
    else:
        seeded = np.random.default_rng(4).standard_normal((2,) + shape).astype(np.float32)
        caches = tuple(torch.from_numpy(x).to(getattr(torch, kind)) for x in seeded)
        jcaches = tuple(jnp.asarray(x, getattr(jnp, kind)) for x in seeded)
    rng = np.random.default_rng(5)
    for s, pos in [(5, [0, 3, 14]), (1, [5, 8, 15]), (4, [9, 20, 0])]:
        new = _values((2, 3, s, 2, 32), seed=s)
        new *= rng.uniform(0.5, 2.0, new.shape).astype(np.float32)
        tn = [torch.from_numpy(x).to(getattr(torch, new_dtype)) for x in new]
        out = kvq.update_kv_pair(*caches, *tn, torch.tensor(pos, dtype=torch.int32))
        assert out[0] is caches[0] and out[1] is caches[1]  # in place
        jcaches = tuple(jkvq.update_kv(c, jnp.asarray(x, getattr(jnp, new_dtype)),
                                       jnp.asarray(pos, jnp.int32))
                        for c, x in zip(jcaches, new))
    for c, jc in zip(caches, jcaches):
        if kind in KINDS:
            np.testing.assert_array_equal(c.qs.numpy(), np.asarray(jc.qs))
            np.testing.assert_array_equal(c.scale.numpy(), np.asarray(jc.scale))
        else:
            np.testing.assert_array_equal(c.float().numpy(),
                                          np.asarray(jc.astype(jnp.float32)))


@pytest.mark.parametrize("kind", list(KINDS))
def test_update_kv_pair_on_a_slot_row_view(kind):
    """The engine's prefill writes one slot's row of the full caches: codes
    and scales land in that row only."""
    cls, jcls, _, _ = KINDS[kind]
    shape = (3, 16, 2, 32)
    k, v = cls.zeros(shape), cls.zeros(shape)
    new = _values((2, 1, 4, 2, 32), seed=9)
    kvq.update_kv_pair(k[1:2], v[1:2], torch.from_numpy(new[0]), torch.from_numpy(new[1]),
                       torch.tensor([7], dtype=torch.int32))
    for c, x in ((k, new[0]), (v, new[1])):
        jc = jkvq.update_kv(jcls.zeros((1,) + shape[1:]), jnp.asarray(x),
                            jnp.asarray([7], jnp.int32))
        np.testing.assert_array_equal(c.qs[1:2].numpy(), np.asarray(jc.qs))
        np.testing.assert_array_equal(c.scale[1:2].numpy(), np.asarray(jc.scale))
        zero = cls.zeros((1,) + shape[1:])
        for row in (0, 2):
            assert torch.equal(c.qs[row:row + 1], zero.qs) and not c.scale[row].any()


def test_materialized_counts_dense_copies():
    c = kvq.KVQ4.zeros((1, 4, 2, 16))
    before = kvq.KVQ8.materialized
    c.to(torch.float32)
    kvq.KVQ8.zeros((1, 4, 2, 16)).to(torch.bfloat16)
    assert kvq.KVQ8.materialized == before + 2


@pytest.mark.parametrize("kind", list(KINDS))
def test_cache_ops_on_quantized_caches_match_jax(kind):
    """context_shift, rope_shift, seq_div, seq_cp: K is materialized to
    bf16, re-rotated and requantized; V codes move as they are."""
    jkv = JKVCache(jtiny_config(n_layers=2), 3, 16, kind)
    kv = KVCache(tiny_config(n_layers=2), 3, 16, kind, "cpu")
    rng = np.random.default_rng(3)
    new = rng.standard_normal((2, 2, 3, 12, 2, 16)).astype(np.float32)
    pos = np.zeros(3, np.int32)
    for li in range(2):
        jk, jv = jkv.caches[li]
        jkv.caches[li] = tuple(jkvq.update_kv(c, jnp.asarray(n), jnp.asarray(pos))
                               for c, n in ((jk, new[li, 0]), (jv, new[li, 1])))
        for c, n in zip(kv.caches[li], new[li]):
            kvq.update_kv(c, torch.from_numpy(n), torch.from_numpy(pos))
    jkv.cache_pos[:] = kv.cache_pos[:] = [12, 9, 11]
    delta = rng.integers(-5, 5, 16).astype(np.int32)
    for c in (jkv, kv):
        c.context_shift(0, 2, 4)
        c.rope_shift(2, delta)
        c.seq_div(1, 2, 8, 2)
        c.seq_cp(dst=2, src=0)
    np.testing.assert_array_equal(kv.cache_pos, jkv.cache_pos)
    for (k, v), (jk, jv) in zip(kv.caches, jkv.caches):
        for a, ja in ((k, jk), (v, jv)):
            np.testing.assert_array_equal(a.qs.numpy(), np.asarray(ja.qs))
            np.testing.assert_array_equal(a.scale.numpy(), np.asarray(ja.scale))


def test_init_kv_caches_quantized():
    cfg = tiny_config(n_layers=2)
    shape = (2, 8, cfg.n_kv_heads, cfg.head_dim)
    for kind, cls, qdtype in (("q8_0", kvq.KVQ8, torch.int8), ("q4_0", kvq.KVQ4, torch.uint8)):
        caches = init_kv_caches(cfg, 2, 8, kind, "cpu")
        assert len(caches) == 2 and all(isinstance(c, cls) for kv in caches for c in kv)
        k = caches[0][0]
        assert k.shape == shape and k.qs.dtype == qdtype
        assert k.scale.shape == shape[:-1] + (1,) and not k.to(torch.float32).any()
        assert isinstance(k[1:2], cls) and k[1:2].shape == (1,) + shape[1:]
    with pytest.raises(ValueError):
        init_kv_caches(cfg, 2, 8, "q5_1", "cpu")
