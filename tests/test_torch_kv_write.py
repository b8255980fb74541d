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
