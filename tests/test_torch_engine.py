"""The port's Engine against the JAX package's Engine (scan=False), f32
activations and KV, on the trained tiny model: identical greedy streams
over 4 slots with slot and prefix reuse, through step() and step_fused(),
and across a context shift. The device sampler keeps the host chain's
candidate sets, and step() and step_fused() draw one stream per seed."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.runtime.engine import Engine as JEngine
from prima_tpu.sampling import (SamplerParams, apply_min_p, apply_penalties,
                                apply_top_k, apply_top_p)
from prima_tpu_torch.models.llama import ForwardOptions
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.runtime.generate import (MAX_TOPK, SlotSampleParams,
                                              batch_params, candidates, penalize)
from prima_tpu_torch.sampling import Sampler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(ROOT, "models_tiny_pair", "target.gguf")


@pytest.fixture(scope="module")
def pair():
    return jload_model(PAIR), load_model(PAIR, device="cpu")


def _engines(pair, **kw):
    jm, m = pair
    jeng = JEngine(jm.cfg, jm.params, opts=JOpts(matmul_impl="xla", dtype=jnp.float32),
                   kv_dtype=jnp.float32, eog_ids=jm.eog_ids, scan=False, **kw)
    eng = Engine(m.cfg, m.params, opts=ForwardOptions(dtype=torch.float32),
                 kv_dtype=torch.float32, eog_ids=m.eog_ids, device="cpu", **kw)
    return jeng, eng


def _serve(eng, prompts, fused: bool, n_predict: int, sampler=None) -> list:
    queue, live, out = list(enumerate(prompts)), {}, {}
    while queue or live:
        while queue and eng.find_idle_slot() is not None:
            i, p = queue.pop(0)
            live[i] = eng.submit(p, n_predict=n_predict,
                                 sampler=sampler() if sampler else None)
        if fused:
            eng.step_fused(max_chunk=8)
        else:
            eng.step()
        for i, s in list(live.items()):
            if s.state.name == "IDLE":
                out[i] = (list(s.generated), s.stop_reason)
                del live[i]
    return [out[i] for i in range(len(prompts))]


def _prompts(pair):
    tok = pair[1].tokenizer
    texts = ["def main():", "The quick brown fox", "import numpy as np",
             "def main(): return", "class Foo:", "for i in range(10):"]
    return [tok.encode(t, add_special=True) for t in texts]


@pytest.mark.parametrize("fused", [True, False], ids=["step_fused", "step"])
def test_greedy_streams_match_jax(pair, fused):
    jeng, eng = _engines(pair, n_slots=4, max_seq=96, n_batch=16)
    prompts = _prompts(pair)
    want = _serve(jeng, prompts, fused, n_predict=12)
    got = _serve(eng, prompts, fused, n_predict=12)
    assert got == want
    assert all(len(g) == 12 or r == "eog" for g, r in got)


def test_context_shift_matches_jax(pair):
    jeng, eng = _engines(pair, n_slots=2, max_seq=32, n_batch=8, ctx_shift=True, n_keep=2)
    prompts = _prompts(pair)[:2]
    want = _serve(jeng, prompts, True, n_predict=40)
    got = _serve(eng, prompts, True, n_predict=40)
    assert got == want
    assert eng.slots[0].shifts or eng.slots[1].shifts  # a shift happened


@pytest.mark.parametrize("kw", [
    dict(top_k=40, top_p=0.9, min_p=0.05),
    dict(top_k=10, top_p=1.0, min_p=0.0),
    dict(top_k=200, top_p=0.5, min_p=0.1, min_keep=3),
    dict(top_k=50, top_p=0.95, min_p=0.3, penalty_last_n=8, penalty_repeat=1.3,
         penalty_freq=0.2, penalty_present=0.1),
])
def test_device_candidates_match_host_chain(kw):
    """The kept-candidate set on the device equals the host chain's."""
    rng = np.random.default_rng(0)
    v = 300
    logits = (rng.standard_normal((3, v)) * 3).astype(np.float32)
    prev = [list(rng.integers(0, v, 12)) for _ in range(3)]
    p = SamplerParams(temp=0.8, **kw)
    sps = [SlotSampleParams(temp=0.8, **kw) for _ in range(3)]
    sp = batch_params(sps, MAX_TOPK, "cpu")
    lt = torch.from_numpy(logits)
    if sps[0].penalties_active():
        recent = np.full((3, MAX_TOPK), -1, np.int32)
        for i, pr in enumerate(prev):
            recent[i, : min(len(pr), 8)] = pr[-8:]
        lt = penalize(lt, torch.from_numpy(recent), sp)
    vals, idx, keep = candidates(lt, sp, MAX_TOPK)
    for i in range(3):
        lg = logits[i].copy()
        apply_penalties(lg, prev[i], p.penalty_last_n, p.penalty_repeat,
                        p.penalty_freq, p.penalty_present)
        ids = apply_top_k(lg, p.top_k)
        ids = apply_top_p(lg, ids, p.top_p, p.min_keep)
        ids = apply_min_p(lg, ids, p.min_p, p.min_keep)
        assert set(idx[i][keep[i]].tolist()) == set(int(t) for t in ids)


def test_seeded_stream_is_path_independent(pair):
    """step() and step_fused() draw one stream for one seed."""
    m = pair[1]
    prompts = _prompts(pair)[:3]
    sampler = lambda: Sampler(SamplerParams(temp=0.9, top_k=40, top_p=0.95, seed=7))
    runs = []
    for fused in (True, False):
        eng = Engine(m.cfg, m.params, n_slots=3, max_seq=64, n_batch=16,
                     opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                     device="cpu")
        runs.append(_serve(eng, prompts, fused, n_predict=10, sampler=sampler))
    assert runs[0] == runs[1]


def test_kv_cache_ops_match_jax():
    """seq_cp, seq_keep, context_shift and rope_shift move and re-rotate
    the same cells as the JAX KVCache (in place here, functional there)."""
    from prima_tpu.models.config import tiny_config as jtiny_config
    from prima_tpu.runtime.kv import KVCache as JKVCache
    from prima_tpu_torch.models.config import tiny_config
    from prima_tpu_torch.runtime.kv import KVCache

    rng = np.random.default_rng(0)
    shape = (3, 16, 2, 16)
    layers = [(rng.standard_normal(shape).astype(np.float32),
               rng.standard_normal(shape).astype(np.float32)) for _ in range(2)]
    pos = np.array([12, 7, 10], np.int32)
    jkv = JKVCache(jtiny_config(n_layers=2), 3, 16, jnp.float32,
                   caches=[(jnp.asarray(k), jnp.asarray(v)) for k, v in layers],
                   cache_pos=pos.copy())
    kv = KVCache(tiny_config(n_layers=2), 3, 16, torch.float32, "cpu",
                 caches=[(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
                         for k, v in layers], cache_pos=pos.copy())
    delta = rng.integers(-5, 5, 16).astype(np.int32)
    for c in (jkv, kv):
        c.context_shift(0, 2, 4)
        c.seq_cp(dst=1, src=2)
        c.rope_shift(2, delta)
        c.seq_rm(2, p0=6)
    np.testing.assert_array_equal(kv.cache_pos, jkv.cache_pos)
    for (k, v), (jk, jv) in zip(kv.caches, jkv.caches):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0, atol=2e-6)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    for c in (jkv, kv):
        c.seq_keep(1)
    np.testing.assert_array_equal(kv.cache_pos, jkv.cache_pos)


def _engines_with(pair, kv_dtype, jopts=None, opts=None, **kw):
    """The two engines with f32 activations, a KV cache of "f32", "q8_0"
    or "q4_0", and optional forward options."""
    jm, m = pair
    jkv, kv = (jnp.float32, torch.float32) if kv_dtype == "f32" else (kv_dtype, kv_dtype)
    jeng = JEngine(jm.cfg, jm.params, eog_ids=jm.eog_ids, scan=False, kv_dtype=jkv,
                   opts=jopts or JOpts(matmul_impl="xla", dtype=jnp.float32), **kw)
    eng = Engine(m.cfg, m.params, eog_ids=m.eog_ids, device="cpu", kv_dtype=kv,
                 opts=opts or ForwardOptions(dtype=torch.float32), **kw)
    return jeng, eng


@pytest.mark.parametrize("kv_dtype", ["q8_0", "q4_0"])
def test_greedy_streams_match_jax_with_quantized_kv(pair, kv_dtype):
    jeng, eng = _engines_with(pair, kv_dtype, n_slots=3, max_seq=64, n_batch=8)
    prompts = _prompts(pair)[:4]
    want = _serve(jeng, prompts, True, n_predict=10)
    assert _serve(eng, prompts, True, n_predict=10) == want


@pytest.mark.parametrize("fused", [True, False], ids=["step_fused", "step"])
def test_self_extend_matches_jax(pair, fused):
    """grp_attn_n = 2 over a window of 16: prompts and generations cross
    several ga boundaries, so K is re-rotated and RoPE positions fall
    behind the write index."""
    jeng, eng = _engines_with(pair, "f32", n_slots=2, max_seq=96, n_batch=8,
                              grp_attn_n=2, grp_attn_w=16)
    prompts = [p * 3 for p in _prompts(pair)[:3]]
    want = _serve(jeng, prompts, fused, n_predict=24)
    got = _serve(eng, prompts, fused, n_predict=24)
    assert got == want
    assert all(s.ga_i > 0 for s in eng.slots)


def test_self_extend_with_kernel_attention_matches_jax(pair):
    """attn_impl "kernel" against JAX "pallas" under Self-Extend: the flash
    path's visibility must follow the physical positions, not the RoPE
    ones."""
    jeng, eng = _engines_with(
        pair, "q8_0", JOpts(matmul_impl="xla", attn_impl="pallas", dtype=jnp.float32),
        ForwardOptions(attn_impl="kernel", dtype=torch.float32),
        n_slots=2, max_seq=64, n_batch=16, grp_attn_n=2, grp_attn_w=16)
    prompts = [p * 2 for p in _prompts(pair)[:2]]
    want = _serve(jeng, prompts, True, n_predict=8)
    assert _serve(eng, prompts, True, n_predict=8) == want
    assert all(s.ga_i >= 16 for s in eng.slots)  # two ga boundaries crossed


def test_self_extend_arguments_are_checked(pair):
    m = pair[1]
    for kw in (dict(grp_attn_n=0), dict(grp_attn_n=3, grp_attn_w=16),
               dict(grp_attn_n=2, grp_attn_w=16, ctx_shift=True)):
        with pytest.raises(ValueError):
            Engine(m.cfg, m.params, device="cpu", **kw)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kv_dtype", ["f32", "q8_0"])
def test_slot_file_crosses_packages(pair, tmp_path, direction, kv_dtype):
    """A slot saved by one package restores in the other and continues to
    the same greedy tokens the saving engine gives."""
    from prima_tpu.runtime.state import slot_restore as jrestore
    from prima_tpu.runtime.state import slot_save as jsave
    from prima_tpu_torch.runtime.state import slot_restore, slot_save

    jeng, eng = _engines_with(pair, kv_dtype, n_slots=2, max_seq=64, n_batch=8)
    src, dst = (jeng, eng) if direction == "jax_to_port" else (eng, jeng)
    save = jsave if direction == "jax_to_port" else slot_save
    prompt = _prompts(pair)[1]
    follow = prompt + src.run_to_completion(prompt, n_predict=6)
    path = str(tmp_path / "slot0.bin")
    n = save(src, 0, path)
    assert n == len(prompt) + 5  # prompt[:-1] prefilled, 6 decode writes
    # both engines restore the file into slot 0 and continue from it
    restores = ((jrestore, slot_restore) if direction == "jax_to_port"
                else (slot_restore, jrestore))
    streams = []
    for e, rest in zip((src, dst), restores):
        assert rest(e, 0, path) == n and e.slots[0].prompt == follow
        streams.append(e.run_to_completion(follow, n_predict=6))
        assert e.kv.used(0) == n + 6  # the prefix came from the file
    assert streams[0] == streams[1]
