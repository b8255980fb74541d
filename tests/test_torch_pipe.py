"""The port's pipe forward over a gloo mesh of processes on the CPU against
the JAX package's make_pipe_forward on its 8 virtual CPU devices, for the
(dp, pp, tp, k) cases of tests/test_parallel.py and a prefill + decode
with q / k / v biases through tp: f32 logits within 1e-5 * max |logit|.
Both packages draw the same synthetic weights (synth_host_layer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.gguf.constants import GGMLType as JGG
from prima_tpu.models.config import tiny_config as jtiny
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import synth_host_head as jhead
from prima_tpu.models.llama import synth_host_layer as jlayer
from prima_tpu.parallel.mesh import make_mesh as jmake_mesh
from prima_tpu.parallel.pipeline import PipeSpec as JPipeSpec
from prima_tpu.parallel.pipeline import build_pipe_model as jbuild
from prima_tpu.parallel.pipeline import init_pipe_kv as jinit_kv
from prima_tpu.parallel.pipeline import make_pipe_forward as jmake_fwd
from prima_tpu_torch.models.config import tiny_config
from torch_mesh_ranks import passes, plan_for, run_world

JOPTS = JOpts(matmul_impl="xla", dtype=jnp.float32)
TOL = 1e-5  # times max |logit|


def jax_pipe(cfg, dp, pp, tp, k, batches, B, T, sp=1, seed=0):
    """The JAX pipeline's logits for each (tokens, positions, cache_pos)."""
    mesh = jmake_mesh(dp=dp, pp=pp, tp=tp, sp=sp)
    spec = JPipeSpec.for_model(cfg, n_pp=pp, n_tp=tp, n_dp=dp, k_cycles=k,
                               microbatches=pp, n_sp=sp)
    params = jbuild(lambda i: jlayer(cfg, i, JGG.Q4_K, seed), jhead(cfg, JGG.Q4_K, seed),
                    cfg, spec, mesh)
    fwd = jax.jit(jmake_fwd(cfg, spec, mesh, JOPTS))
    kv = jinit_kv(cfg, spec, mesh, B, T, jnp.float32)
    out = []
    for tokens, positions, cache_pos in batches:
        logits, kv = fwd(params, tokens.astype(np.int32), positions, cache_pos, kv)
        out.append(np.asarray(logits))
    return out


def close(got, want) -> None:
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, f"max |diff| / max |logit| = {err}"


def prefill(M, B, S, vocab, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(M, B, S)).astype(np.int64)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (M, B, S)).copy()
    return tokens, positions, np.zeros((M, B), np.int32)


@pytest.mark.parametrize("dp,pp,tp,k", [(2, 2, 2, 2), (1, 4, 2, 1), (1, 2, 1, 2)])
def test_pipe_matches_jax_pipeline(dp, pp, tp, k):
    M, B, S, T = pp, 2, 4, 16
    batch = prefill(M, B, S, 256, 1)
    got = run_world(plan_for(tiny_config(n_layers=4), dp, pp, tp, k=k), passes, B, T,
                    torch.float32, [batch])[0]
    want = jax_pipe(jtiny(n_layers=4), dp, pp, tp, k, [batch], B, T)[0]
    assert got.shape == want.shape == (M, B, S, 256)
    close(got, want)


def test_pipe_decode_after_prefill_with_biases():
    """Prefill 4 tokens, then one decode step over the carried caches, with
    q / k / v biases row-sharded over tp (qwen2-style)."""
    dp, pp, tp, k, M, B, S, T = 1, 2, 2, 2, 2, 1, 4, 16
    first = prefill(M, B, S, 256, 2)
    rng = np.random.default_rng(3)
    second = (rng.integers(0, 256, size=(M, B, 1)).astype(np.int64),
              np.full((M, B, 1), S, np.int32), np.full((M, B), S, np.int32))
    got = run_world(plan_for(tiny_config(n_layers=4, qkv_bias=True), dp, pp, tp, k=k),
                    passes, B, T, torch.float32, [first, second])
    want = jax_pipe(jtiny(n_layers=4, qkv_bias=True), dp, pp, tp, k, [first, second], B, T)
    for g, w in zip(got, want):
        close(g, w)
