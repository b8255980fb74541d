"""Sequence parallelism in the port against the JAX package on the CPU:
gqa_attention_sp / update_kv_sp over two ranks' blocks of the cache
against the JAX gqa_attention / update_kv over the whole cache (a prefill
chunk that straddles the blocks, dense f32 and q8_0 caches), and the pipe
forward at sp = 2 against the JAX make_pipe_forward at sp = 2, positions
crossing the blocks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.models.config import tiny_config as jtiny
from prima_tpu.ops.kvquant import KVQ8 as JKVQ8
from prima_tpu.ops.kvquant import quantize_kv as jquantize
from prima_tpu.ops.kvquant import update_kv as jupdate_kv
from prima_tpu.ops.layers import causal_mask as jcausal
from prima_tpu.ops.layers import gqa_attention as jgqa
from prima_tpu_torch.models.config import tiny_config
from prima_tpu_torch.parallel.launch import RankPlan, init_multihost
from test_torch_pipe import close, jax_pipe
from torch_mesh_ranks import passes, plan_for, run_world, sp_attention


@pytest.mark.parametrize("kv_dtype", ["f32", "q8_0"])
def test_sp_attention_and_write_match_the_whole_cache(kv_dtype):
    rng = np.random.default_rng(4)
    b, s, h, kvh, hd, T = 2, 6, 4, 2, 16, 16
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    q, k0, v0, kn, vn = f(b, s, h, hd), f(b, T, kvh, hd), f(b, T, kvh, hd), f(b, s, kvh, hd), \
        f(b, s, kvh, hd)
    cache_pos = np.array([5, 2], np.int32)  # row 0 writes cells 5..10: both blocks
    positions = (cache_pos[:, None] + np.arange(s)).astype(np.int32)
    plan = RankPlan({"dp": 1, "pp": 1, "sp": 2, "tp": 1}, init_multihost()[0], ("none",))
    out, blocks = run_world(plan, sp_attention, q, k0, v0, kn, vn, cache_pos, positions,
                            None if kv_dtype == "f32" else kv_dtype)
    if kv_dtype == "f32":
        jk, jv = (jupdate_kv(jnp.asarray(c), jnp.asarray(n), jnp.asarray(cache_pos))
                  for c, n in ((k0, kn), (v0, vn)))
    else:
        jk, jv = (jupdate_kv(JKVQ8(*jquantize(jnp.asarray(c))), jnp.asarray(n),
                             jnp.asarray(cache_pos)).astype(jnp.float32)
                  for c, n in ((k0, kn), (v0, vn)))
    want = np.asarray(jgqa(jnp.asarray(q), jk, jv, jcausal(jnp.asarray(positions), T),
                           1.0 / np.sqrt(hd)))
    for i, (bk, bv) in enumerate(blocks):  # each rank holds its 8 cells, exactly
        assert np.array_equal(bk, np.asarray(jk)[:, 8 * i:8 * i + 8])
        assert np.array_equal(bv, np.asarray(jv)[:, 8 * i:8 * i + 8])
    close(out, want)


@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2)])
def test_pipe_sp_matches_jax(pp, tp):
    """pp x sp x tp ranks: a 12-token prefill into caches of 16 cells in
    blocks of 8, then a decode step at position 12."""
    M, B, S, T = pp, 1, 12, 16
    rng = np.random.default_rng(5)
    first = (rng.integers(0, 256, size=(M, B, S)).astype(np.int64),
             np.broadcast_to(np.arange(S, dtype=np.int32), (M, B, S)).copy(),
             np.zeros((M, B), np.int32))
    second = (rng.integers(0, 256, size=(M, B, 1)).astype(np.int64),
              np.full((M, B, 1), S, np.int32), np.full((M, B), S, np.int32))
    got = run_world(plan_for(tiny_config(n_layers=2), 1, pp, tp, sp=2), passes, B, T,
                    torch.float32, [first, second])
    want = jax_pipe(jtiny(n_layers=2), 1, pp, tp, 1, [first, second], B, T, sp=2)
    for g, w in zip(got, want):
        close(g, w)
