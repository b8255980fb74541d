"""The port's mesh plane in one process against the JAX package: the rank
layout and auto_mesh's factorization, shard_uq_rows / shard_uq_cols byte
for byte, the same cuts made on the device (shard_qtensor_*), the tp
tables (shard_layer_uq, tp_local_config), PipeSpec, the launcher's
environment, and a world of one rank (no process group) against the
port's single-device forward bit for bit."""

import os

import numpy as np
import pytest
import torch

from prima_tpu.gguf.constants import GGMLType as JGG
from prima_tpu.models.config import tiny_config as jtiny
from prima_tpu.models.llama import synth_host_layer as jsynth_layer
from prima_tpu.parallel import mesh as jmesh
from prima_tpu.parallel.pipeline import PipeSpec as JPipeSpec
from prima_tpu.parallel.sharding import shard_uq_cols as jcols
from prima_tpu.parallel.sharding import shard_uq_rows as jrows
from prima_tpu.parallel.tp import shard_layer_uq as jshard_layer
from prima_tpu.parallel.tp import tp_local_config as jtp_local
from prima_tpu_torch.gguf.constants import GGMLType
from prima_tpu_torch.models.config import tiny_config
from prima_tpu_torch.models.llama import (ForwardOptions, _synth_uq, forward, init_kv_caches,
                                          synth_host_head, synth_host_layer)
from prima_tpu_torch.parallel import launch
from prima_tpu_torch.parallel.mesh import (AXES, auto_mesh_shape, choose_transport,
                                           make_mesh, mesh_coords, mesh_rank)
from prima_tpu_torch.parallel.pipeline import PipeSpec, build_pipe_model, make_pipe_forward
from prima_tpu_torch.parallel.pipeline import init_pipe_kv
from prima_tpu_torch.parallel.sharding import (put_shard, shard_qtensor_cols,
                                               shard_qtensor_rows, shard_uq_cols,
                                               shard_uq_rows)
from prima_tpu_torch.parallel.tp import shard_layer, shard_layer_uq, tp_local_config
from prima_tpu_torch.quant.qtensor import QTensor

FIELDS = ("qs", "scales", "mins", "d", "dmin")
TYPES = [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q5_K]


def same_uq(a, b) -> None:
    assert (a.sub, a.layout, a.q_offset, tuple(a.shape), a.gsub) == \
        (b.sub, b.layout, b.q_offset, tuple(b.shape), b.gsub)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def same_qt(a: QTensor, b: QTensor) -> None:
    assert (a.shape, a.sub, a.layout, a.gsub, a.packed) == (b.shape, b.sub, b.layout, b.gsub,
                                                            b.packed)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("shape", [dict(dp=2, pp=2, sp=1, tp=2), dict(dp=1, pp=4, sp=2, tp=1),
                                   dict(dp=1, pp=2, sp=2, tp=2)])
def test_rank_layout_is_the_jax_device_order(shape):
    """Rank r sits where device r sits in the JAX mesh's (dp, pp, sp, tp)
    array: tp innermost."""
    n = shape["dp"] * shape["pp"] * shape["sp"] * shape["tp"]
    grid = np.arange(n).reshape(*(shape[a] for a in AXES))
    for r in range(n):
        c = mesh_coords(r, shape)
        assert grid[tuple(c[a] for a in AXES)] == r == mesh_rank(c, shape)


@pytest.mark.parametrize("n,want_pp", [(1, None), (2, None), (4, None), (6, None), (8, None),
                                       (8, 4), (12, None), (8, 1)])
def test_auto_mesh_factorization(n, want_pp):
    jm = jmesh.auto_mesh(n, want_pp) if n <= 8 else None
    got = auto_mesh_shape(n, want_pp)
    if jm is not None:
        assert got == {a: jm.shape[a] for a in ("dp", "pp", "tp")}
    assert got["dp"] * got["pp"] * got["tp"] == n


def test_world_of_one_needs_no_process_group():
    m = make_mesh(device="cpu")
    assert m.world == 1 and m.ctrl is None and m.transport == "gloo"
    assert all(m.axis(a).size == 1 and m.axis(a).group is None for a in AXES)
    t = torch.arange(4.0)
    assert m.axis("tp").all_reduce(t) is t
    assert m.bcast_cmd(("x", 1)) == ("x", 1)
    with pytest.raises(ValueError):
        make_mesh(pp=2, device="cpu")  # two ranks need a rendezvous


def test_transport_follows_placement():
    assert choose_transport(torch.device("cpu"), 1) == "gloo"
    n = torch.cuda.device_count()
    assert choose_transport(torch.device("cuda"), n + 1) == "gloo"


@pytest.mark.parametrize("t", TYPES)
@pytest.mark.parametrize("n", [2, 4])
def test_shard_uq_byte_for_byte(t, n):
    """Rows and columns split as the JAX package splits them, at
    super-block boundaries (K = 1024: four Q4_K super-blocks)."""
    rng_p, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    from prima_tpu.models.llama import _synth_uq as jsynth_uq

    rows, k = 64, 1024
    p, j = _synth_uq(rng_p, rows, k, t), jsynth_uq(rng_j, rows, k, JGG(int(t)))
    for got, want in ((shard_uq_rows(p, n), jrows(j, n)), (shard_uq_cols(p, n), jcols(j, n))):
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            same_uq(a, b)


@pytest.mark.parametrize("t", TYPES)
def test_device_shards_equal_host_shards(t):
    """The cut of a QTensor on a device equals the QTensor of the host
    cut, packed scales included (K = 2048: 64 sub-blocks a row, 32 a
    half, so both halves repack)."""
    uq = _synth_uq(np.random.default_rng(3), 32, 2048, t)
    qt = QTensor.from_host(uq, "cpu")
    for i in range(2):
        same_qt(shard_qtensor_rows(qt, 2, i), QTensor.from_host(shard_uq_rows(uq, 2)[i], "cpu"))
        same_qt(shard_qtensor_cols(qt, 2, i), QTensor.from_host(shard_uq_cols(uq, 2)[i], "cpu"))


def test_cols_refuse_to_cut_a_super_block():
    uq = _synth_uq(np.random.default_rng(0), 8, 256, GGMLType.Q4_K)
    with pytest.raises(AssertionError):
        shard_uq_cols(uq, 2)
    with pytest.raises(AssertionError):
        shard_qtensor_cols(QTensor.from_host(uq, "cpu"), 2, 0)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_tp_tables(qkv_bias):
    cfg, jcfg = tiny_config(n_layers=2, qkv_bias=qkv_bias), jtiny(n_layers=2,
                                                                  qkv_bias=qkv_bias)
    got = shard_layer_uq(synth_host_layer(cfg, 1, GGMLType.Q4_K, 2), 2)
    want = jshard_layer(jsynth_layer(jcfg, 1, JGG.Q4_K, 2), 2)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in g:
            if hasattr(g[name], "qs"):
                same_uq(g[name], w[name])
            else:
                assert np.array_equal(g[name], w[name]), name
    # the device tables cut the same tensors
    dev = {k: put_shard(v, "cpu") for k, v in synth_host_layer(cfg, 1, GGMLType.Q4_K, 2).items()}
    for i in range(2):
        d = shard_layer(dev, 2, i)
        for name, v in got[i].items():
            if hasattr(v, "qs"):
                same_qt(d[name], QTensor.from_host(v, "cpu"))
            else:
                assert torch.equal(d[name], torch.from_numpy(np.asarray(v, np.float32)))
    local = tp_local_config(cfg, 2)
    jl = jtp_local(jcfg, 2)
    assert (local.n_heads, local.n_kv_heads) == (jl.n_heads, jl.n_kv_heads) == (2, 1)
    with pytest.raises(ValueError):
        tp_local_config(cfg, 4)  # 2 KV heads


@pytest.mark.parametrize("n_pp,k,m", [(2, 2, 2), (4, 1, 4), (2, 1, 1), (1, 4, 1)])
def test_pipe_spec_matches_jax(n_pp, k, m):
    cfg, jcfg = tiny_config(n_layers=8), jtiny(n_layers=8)
    got = PipeSpec.for_model(cfg, n_pp, 2, 1, k, m)
    want = JPipeSpec.for_model(jcfg, n_pp, 2, 1, k, m)
    assert (got.window, got.n_steps, got.n_layers) == (want.window, want.n_steps,
                                                       want.n_layers)
    for d in range(n_pp):
        for c in range(k):
            assert got.window_layers(d, c) == want.window_layers(d, c)
    # the schedule: every (microbatch, window) runs exactly once, in ring order
    seen = []
    for t in range(got.n_steps):
        for d in range(n_pp):
            mb, c, valid = got.slot(t, d)
            if valid:
                seen.append((mb, c * n_pp + d, t))
    assert sorted((mb, v) for mb, v, _ in seen) == [(mb, v) for mb in range(m)
                                                    for v in range(n_pp * k)]
    for mb in range(m):
        steps = [t for b, v, t in sorted(seen, key=lambda s: s[1]) if b == mb]
        assert steps == list(range(mb, mb + n_pp * k))
    for bad in (dict(n_pp=3), dict(n_pp=2, microbatches=3)):
        with pytest.raises(ValueError):
            PipeSpec.for_model(cfg, **{"k_cycles": 1, **bad})


def test_init_multihost_reads_the_environment(monkeypatch):
    monkeypatch.delenv("PRIMA_COORDINATOR", raising=False)
    monkeypatch.delenv("PRIMA_NUM_PROCS", raising=False)
    monkeypatch.delenv("PRIMA_PROC_ID", raising=False)
    addr, n, pid = launch.init_multihost()
    assert addr.startswith("tcp://127.0.0.1:") and (n, pid) == (1, 0)
    assert not launch.is_multihost()
    monkeypatch.setenv("PRIMA_COORDINATOR", "10.0.0.1:7000")
    monkeypatch.setenv("PRIMA_NUM_PROCS", "2")
    monkeypatch.setenv("PRIMA_PROC_ID", "1")
    assert launch.init_multihost() == ("tcp://10.0.0.1:7000", 2, 1)
    assert launch.is_multihost()
    monkeypatch.delenv("PRIMA_COORDINATOR")
    with pytest.raises(ValueError):
        launch.init_multihost()


def test_one_rank_pipe_is_the_forward_bit_for_bit():
    """At world 1 the pipe (k = 2 windows, no process group) equals the
    port's forward over the same layers, bit for bit, over a prefill and a
    decode step."""
    cfg = tiny_config(n_layers=4)
    opts = ForwardOptions(matmul_impl="plain", dtype=torch.float32)
    spec = PipeSpec.for_model(cfg, 1, k_cycles=2, microbatches=1)
    mesh = make_mesh(device="cpu")
    params = build_pipe_model(lambda i: synth_host_layer(cfg, i, GGMLType.Q4_K, 1),
                              synth_host_head(cfg, GGMLType.Q4_K, 1), cfg, spec, mesh)
    fwd = make_pipe_forward(cfg, spec, mesh, opts)
    kv = init_pipe_kv(cfg, spec, mesh, 2, 16, torch.float32)
    ref = dict({k: put_shard(v, "cpu") for k, v in synth_host_head(cfg, GGMLType.Q4_K, 1).items()},
               layers=[{k: put_shard(v, "cpu") for k, v in
                        synth_host_layer(cfg, i, GGMLType.Q4_K, 1).items()} for i in range(4)])
    rkv = init_kv_caches(cfg, 2, 16, torch.float32)
    rng = np.random.default_rng(0)
    for s, p0 in ((5, 0), (1, 5)):
        tokens = rng.integers(0, cfg.n_vocab, (1, 2, s))
        pos = np.broadcast_to(np.arange(p0, p0 + s, dtype=np.int32), (1, 2, s)).copy()
        cp = np.full((1, 2), p0, np.int32)
        got, _ = fwd(params, tokens, pos, cp, kv)
        want, _ = forward(ref, cfg, torch.as_tensor(tokens[0]), torch.as_tensor(pos[0]), rkv,
                          torch.as_tensor(cp[0]), opts)
        assert torch.equal(got[0], want)
