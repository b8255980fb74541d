"""The cases of tests/test_pipe_kv.py on the port's DistributedEngine over a
gloo mesh of processes (pp = 2, k = 2, f32), against the JAX package:
greedy streams equal the JAX single-device Engine's (through a context
shift, under Self-Extend, over q8_0 / q4_0 caches), seq_cp / seq_rm,
seq_add against re-encoding and against the JAX KVCache's seq_add, and slot
files both ways between the mesh and the JAX engine. One mesh runs every
case (module fixture); each test checks one."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from prima_tpu.gguf.constants import GGMLType as JGG
from prima_tpu.models.config import tiny_config as jtiny
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import forward as jforward
from prima_tpu.models.llama import synth_params as jsynth_params
from prima_tpu.runtime.engine import Engine as JEngine
from prima_tpu.runtime.kv import KVCache as JKVCache
from prima_tpu.runtime.kv import _materialize_row as jrow
from prima_tpu.runtime.state import slot_restore as jslot_restore
from prima_tpu_torch.models.config import tiny_config
from torch_mesh_ranks import engines, plan_for, run_world

SEED = 5
JOPTS = JOpts(matmul_impl="xla", dtype=jnp.float32)
PROMPT = [3, 17, 42, 7]
SHIFT_N = 34  # max_seq 24 + 10: past the cache


@pytest.fixture(scope="module")
def mesh_runs():
    plan = plan_for(tiny_config(n_layers=4), 1, 2, 1, k=2, seed=SEED)
    return run_world(plan, engines, "pipe_kv", SHIFT_N, timeout=240.0)


@pytest.fixture(scope="module")
def jparams():
    return jsynth_params(jtiny(n_layers=4), JGG.Q4_K, seed=SEED)


def jengine(jparams, **kw):
    kw.setdefault("kv_dtype", jnp.float32)
    return JEngine(jtiny(n_layers=4), jparams, n_slots=1, opts=JOPTS, **kw)


def test_ctx_shift_generates_past_context(mesh_runs):
    r = mesh_runs
    assert len(r["shift"]) == SHIFT_N and r["shift_reason"] == "length"
    assert r["shift_used"] < 24
    assert r["noshift_reason"] == "context_full"


def test_ctx_shift_matches_single_device(mesh_runs, jparams):
    """With more than one grid row the mesh shifts n_batch early (its row
    limit, 24 - 8); the JAX single-device engine with a cache of that
    limit shifts at the same cell and gives the same whole stream."""
    want = jengine(jparams, max_seq=16, n_batch=8, ctx_shift=True,
                   n_keep=2).run_to_completion(PROMPT, n_predict=SHIFT_N)
    assert mesh_runs["shift"] == want


def test_seq_cp_and_rm(mesh_runs, jparams):
    r = mesh_runs
    want = jengine(jparams, max_seq=32, n_batch=8).run_to_completion([3, 17, 42, 7, 9],
                                                                     n_predict=7)
    assert r["cp_first"] == want[:4]
    assert r["cp_cont"][1:] == want[4:7]  # the copied row decodes on
    assert r["rm_same_slot"] and r["rm_again"] == r["cp_first"]


def test_seq_add_matches_reencode(mesh_runs, jparams):
    """Layer 0's moved and re-rotated cells equal re-encoding the kept
    tokens, and the JAX KVCache's seq_add over the JAX forward's cache."""
    (k1, v1), (k2, v2) = mesh_runs["seq_add"]
    np.testing.assert_allclose(k1[0], k2[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(v1[0], v2[0], rtol=2e-5, atol=2e-5)
    cfg = jtiny(n_layers=4)
    toks = np.asarray([[5, 9, 2, 33, 11, 7]], np.int32)
    kv = JKVCache(cfg, 1, 32, jnp.float32)
    _, kv.caches = jforward(jparams, cfg, toks, np.arange(6, dtype=np.int32)[None], kv.caches,
                            np.zeros(1, np.int32), JOPTS)
    kv.cache_pos[0] = 6
    kv.seq_add(0, 4, 6, -2)
    for li in range(cfg.n_layers):
        jk, jv = (np.asarray(jrow(c, 0))[:4] for c in kv.caches[li])
        np.testing.assert_allclose(k1[li], jk, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(v1[li], jv, rtol=2e-5, atol=2e-5)


def test_save_restore_roundtrip(mesh_runs):
    r = mesh_runs
    assert r["saved"] == r["restored"] > 0
    assert r["restore_got"] == r["restore_want"]


def test_mesh_slot_file_restores_in_the_jax_engine(mesh_runs, jparams, tmp_path):
    """The mesh's slot file has the single-device format: the JAX engine
    restores it and decodes on as the mesh does."""
    path = tmp_path / "slot0.bin"
    path.write_bytes(mesh_runs["slot_file"])
    eng = jengine(jparams, max_seq=24, n_batch=8)
    assert jslot_restore(eng, 0, str(path)) == mesh_runs["saved"]
    full = PROMPT + mesh_runs["save_first"]
    assert eng.run_to_completion(full, n_predict=3) == mesh_runs["restore_want"]


def test_self_extend(mesh_runs):
    out, (ga_i, delta, used, live) = mesh_runs["se24"], mesh_runs["se24_state"]
    assert len(out) == 24 and ga_i > 0 and delta < 0
    assert used == 6 + 24 - 1
    assert np.all(np.diff(live) >= 0)


def test_self_extend_prefix_matches_plain(mesh_runs):
    plain, se = mesh_runs["se_prefix"]
    assert se == plain


def test_self_extend_matches_single_device(mesh_runs, jparams):
    eng = jengine(jparams, max_seq=64, n_batch=8, grp_attn_n=2, grp_attn_w=8)
    assert mesh_runs["se16"] == eng.run_to_completion([3, 17, 42, 7, 99, 5], n_predict=16)
    assert mesh_runs["se16_delta"] == eng.slots[0].pos_delta


@pytest.mark.parametrize("ctk", ["q8_0", "q4_0"])
def test_quantized_kv_matches_single_device(mesh_runs, jparams, ctk):
    want = jengine(jparams, max_seq=32, n_batch=8, kv_dtype=ctk).run_to_completion(
        PROMPT, n_predict=8)
    assert mesh_runs[ctk] == want


def test_quantized_kv_ctx_shift(mesh_runs, jparams):
    assert len(mesh_runs["q8_shift"]) == 30 and mesh_runs["q8_shift_used"] < 24
    want = jengine(jparams, max_seq=16, n_batch=8, kv_dtype="q8_0", ctx_shift=True,
                   n_keep=2).run_to_completion(PROMPT, n_predict=30)
    assert mesh_runs["q8_shift"] == want
