"""KV-cache write of the port against the JAX package's update_kv: the same
cells land in the same places, bit for bit, including the clamp of the
write start to T - S. tests/test_torch_cuda.py holds the CUDA kernel
against its plain version on the GPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.ops.kvquant import update_kv as jupdate_kv
from prima_tpu_torch.ops import kv_write as kvw
from prima_tpu_torch.ops.kvquant import update_kv

T = 32
# (B, S, heads, head_dim, positions): P = heads * head_dim of 1024 (8B),
# 256 (the trained pair, width-512 tiny models) and 128 (the draft)
CASES = [(3, 1, 8, 128, [0, 17, 31]), (3, 5, 8, 128, [2, 30, 27]),
         (4, 1, 4, 64, [5, 0, 31, 40]), (2, 8, 2, 64, [26, 100]),
         (1, 32, 4, 32, [0])]


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((b, T, h, d)).astype(np.float32)
    new = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return cache, new


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,d,pos", CASES)
def test_matches_jax_update_kv(b, s, h, d, pos, dtype):
    cache, new = _inputs(b, s, h, d, seed=b * 100 + s)
    jd = getattr(jnp, dtype)
    want = jupdate_kv(jnp.asarray(cache, jd), jnp.asarray(new, jd),
                      jnp.asarray(pos, jnp.int32))
    want = np.asarray(want.astype(jnp.float32))
    td = getattr(torch, dtype)
    tc = torch.from_numpy(cache).to(td)
    out = update_kv(tc, torch.from_numpy(new).to(td), torch.tensor(pos, dtype=torch.int32))
    assert out is tc  # in place
    np.testing.assert_array_equal(tc.float().numpy(), want)


def test_clamps_past_the_end():
    cache = torch.zeros(1, T, 2)
    new = torch.ones(1, 4, 2)
    kvw.kv_write(cache, new, torch.tensor([T + 7], dtype=torch.int32))
    assert cache[0, : T - 4].abs().sum() == 0 and torch.all(cache[0, T - 4:] == 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,d,pos", CASES)
def test_kv_store_matches_two_jax_update_kv(b, s, h, d, pos, dtype):
    """The fused store of a layer's K and V rows (its plain version on the
    CPU) against update_kv for K and for V in the JAX package."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    pairs = [_inputs(b, s, h, d, seed=b * 100 + s + i) for i in range(2)]
    want = [np.asarray(jupdate_kv(jnp.asarray(c, jd), jnp.asarray(n, jd),
                                  jnp.asarray(pos, jnp.int32)).astype(jnp.float32))
            for c, n in pairs]
    caches = [torch.from_numpy(c).to(td) for c, _ in pairs]
    new = [torch.from_numpy(n).to(td) for _, n in pairs]
    out = kvw.kv_store(*caches, *new, torch.tensor(pos, dtype=torch.int32))
    assert out[0] is caches[0] and out[1] is caches[1]  # in place
    for got, ref in zip(caches, want):
        np.testing.assert_array_equal(got.float().numpy(), ref)


def test_kv_store_counts_no_launch_on_the_cpu():
    cache, new = _inputs(2, 1, 2, 16, seed=1)
    k, v = torch.from_numpy(cache), torch.from_numpy(cache.copy())
    before = kvw.store_launches.count, kvw.launches.count
    kvw.kv_store(k, v, torch.from_numpy(new), torch.from_numpy(new),
                 torch.tensor([3, 40], dtype=torch.int32))
    assert (kvw.store_launches.count, kvw.launches.count) == before
    assert torch.equal(k, v) and torch.equal(k[1, T - 1], torch.from_numpy(new)[1, 0])
