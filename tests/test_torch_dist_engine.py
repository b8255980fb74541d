"""The port's DistributedEngine over a gloo mesh of processes (pp = 2, tp = 2,
k = 2: four ranks, 2 x 2 slots, f32) against the JAX single-device Engine
on the same synthetic weights: the cases of tests/test_distributed_engine.py
(one request, staggered joins over the slot grid, step_fused against step,
seeded sampling on both paths, two slots through the fused loop), then
verify_chain's logits, /props-style launch counts from every rank, and
/v1/embeddings' pooled vector through the pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest

from prima_tpu.gguf.constants import GGMLType as JGG
from prima_tpu.models.config import tiny_config as jtiny
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import synth_params as jsynth_params
from prima_tpu.runtime.engine import Engine as JEngine
from prima_tpu_torch.models.config import tiny_config
from torch_mesh_ranks import engines, plan_for, run_world

SEED = 5
JOPTS = JOpts(matmul_impl="xla", dtype=jnp.float32)


@pytest.fixture(scope="module")
def mesh_runs():
    return run_world(plan_for(tiny_config(n_layers=4), 1, 2, 2, k=2, seed=SEED), engines,
                     "batching", timeout=240.0)


@pytest.fixture(scope="module")
def ref():
    return JEngine(jtiny(n_layers=4), jsynth_params(jtiny(n_layers=4), JGG.Q4_K, seed=SEED),
                   n_slots=1, max_seq=64, n_batch=16, opts=JOPTS, kv_dtype=jnp.float32)


def greedy(ref, prompt, n):
    ref.slots[0].prompt = []  # no prefix reuse between cases
    return ref.run_to_completion(prompt, n_predict=n, reuse_prefix=False)


def test_matches_single_device(mesh_runs, ref):
    assert mesh_runs["alone"] == greedy(ref, [3, 17, 42, 7, 99, 5], 8)


def test_continuous_batching(mesh_runs, ref):
    prompts = [[3, 17, 42, 7], [100, 20, 8, 55, 21], [9, 9, 9], [1, 2, 3, 4, 5]]
    for p, got in zip(prompts, mesh_runs["staggered"]):
        assert got == greedy(ref, p, 6), f"prompt {p}"


def test_step_fused_matches_step(mesh_runs, ref):
    assert mesh_runs["fused"] == mesh_runs["step"] == greedy(ref, [5, 11, 23, 4], 10)


def test_step_fused_seeded_dist(mesh_runs):
    a, b, host = mesh_runs["seeded"]
    assert a == b == host and len(a) == 8


def test_step_fused_concurrent_slots(mesh_runs, ref):
    for p, got in zip([[3, 17, 42, 7], [100, 20, 8, 55, 21]], mesh_runs["fused_two"]):
        assert got == greedy(ref, p, 6)


def test_verify_chain(mesh_runs, ref):
    ref.slots[0].prompt = []
    s = ref.submit([3, 17, 42, 7, 99], n_predict=1, reuse_prefix=False)
    ref.prefill_only(s)
    want = ref.verify_chain(s.id, [99, 5, 11, 23])
    got = mesh_runs["verify"]
    assert got.shape == want.shape == (4, 256)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert mesh_runs["verify_pos"] == 4 + 4
    assert mesh_runs["by_rank"] == 4


def test_embed_matches_single_device(ref):
    prompt = [3, 17, 42, 7, 9]
    got = run_world(plan_for(tiny_config(n_layers=4), 1, 2, 2, k=2, seed=SEED), engines,
                    "embed", prompt)
    want = ref.embed(prompt)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()  # bf16 scratch caches
