"""The port's ring against the JAX package on the CPU: the wire's bytes,
RingPlan's windows, the windowed forward (bit for bit against the whole
one, and against the JAX forward over the same layer ranges), rings of
threads over loopback TCP (greedy streams against a reference built from
the JAX forward window by window with the wire's bf16 truncation at each
hop, with and without streamed windows), and TcpRingEngine against the
port's one-process Engine (4 slots in 2 groups, context shift, Self-Extend,
a q8_0 cache, a relaying rank, manual and solver-chosen windows, verify
with the target as its own draft)."""

import errno
import functools
import os
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.gguf.constants import GGMLType
from prima_tpu.gguf.reader import GGUFModel as JGGUFModel
from prima_tpu.models.config import ModelConfig as JModelConfig
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import forward as jforward
from prima_tpu.models.llama import init_kv_caches as jinit_kv
from prima_tpu.models.llama import linear as jlinear
from prima_tpu.models.llama import load_params as jload_params
from prima_tpu.models.llama import model_norm as jmodel_norm
from prima_tpu.parallel import ring_tcp as jring
from prima_tpu.profiler.device import DeviceProfile as JDeviceProfile
from prima_tpu.profiler.model_cost import model_cost_from_gguf as jmodel_cost
from prima_tpu.sched import assign_layers_and_select_devices as jassign
from prima_tpu.parallel.ring_host import RingPlan as JRingPlan
from prima_tpu.tools.make_tiny_gguf import make_tiny_gguf
from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.models.config import ModelConfig
from prima_tpu_torch.models.llama import (ForwardOptions, forward, gguf_host_layer,
                                          init_kv_caches, load_params)
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.parallel import ring_tcp
from prima_tpu_torch.parallel.bootstrap import RingConfig, RingNode, bootstrap
from prima_tpu_torch.parallel.ring_host import HostRingExecutor, RingPlan
from prima_tpu_torch.parallel.ring_tcp import (RingContext, TcpRingEngine, TcpRingWorker,
                                               relay_loop)
from prima_tpu_torch.profiler.device import DeviceProfile
from prima_tpu_torch.profiler.model_cost import model_cost_from_gguf
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.runtime.speculative import SpeculativeDecoder, SpecStats
from prima_tpu_torch.runtime.streaming import pack_host_layer
from test_torch_archs import F32, write_model
from test_torch_speculative import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
DEADLINE = 30.0  # seconds: every socket wait and thread join of a ring
F32_OPTS = ForwardOptions(dtype=torch.float32)
JOPTS = JOpts(matmul_impl="xla", dtype=jnp.float32)
WIRE_TOL = 5e-3  # the bf16 wire's resolution, times max |logit|


# -- rings of threads ----------------------------------------------------------


def ring_nodes(world: int) -> list:
    """RingNodes of one ring on loopback: the base port comes from binding
    port 0, and a base whose ports are taken is dropped for another."""
    for _ in range(20):
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        base = probe.getsockname()[1]
        probe.close()
        nodes = []
        try:
            for r in range(world):
                nodes.append(RingNode(RingConfig(rank=r, world=world, data_port=base)))
        except OSError as e:
            for n in nodes:
                n.close()
            if e.errno != errno.EADDRINUSE:
                raise
            continue
        for n in nodes:
            n.listener.settimeout(DEADLINE)
        return nodes
    raise RuntimeError("no free ports for a ring")


def run_threads(fns: list) -> list:
    """Run each fn on a thread; join each within the deadline and re-raise
    the first error. Returns their results."""
    out, errs = [None] * len(fns), []

    def wrap(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=wrap, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE)
        assert not t.is_alive(), "a ring thread missed its deadline"
    if errs:
        raise errs[0]
    return out


def connected(world: int) -> list:
    nodes = ring_nodes(world)
    run_threads([n.connect_ring for n in nodes])
    return nodes


def rank_params(m, cfg, plan: RingPlan, rank: int, ngl: int = -1, dtype=torch.float32):
    """A rank's resident params and its streamed layers (packed host
    layers): the last `ngl` layers of each window stay resident (all of
    them for ngl < 0)."""
    owned = plan.owned(rank)
    streamed = set()
    if ngl >= 0:
        for lo, hi in plan.layer_ranges()[rank]:
            streamed.update(range(lo, hi - min(ngl, hi - lo)))
    params = load_params(m, cfg, "cpu", dtype=dtype,
                         layer_filter=lambda i: i in owned and i not in streamed,
                         with_embedding=rank == 0, with_output=rank == 0)
    host = {i: pack_host_layer(gguf_host_layer(m, cfg, i, dtype), pin=False)
            for i in streamed}
    return params, host or None


def serve_ring(path: str, windows: list, k: int, fn, ngl: int = -1, n_slots: int = 1,
               n_groups: int = 1, opts=F32_OPTS, kv_dtype=torch.float32, **eng_kw):
    """A ring of len(windows) ranks on threads over the model at `path`:
    the workers serve, rank 0 builds a TcpRingEngine and returns fn(eng)."""
    m = GGUFModel.open(path)
    cfg = ModelConfig.from_gguf(m)
    plan = RingPlan(windows, k)
    world = len(windows)
    nodes = connected(world)
    eng_kw = dict(n_slots=n_slots, n_groups=n_groups, max_seq=64, n_batch=16, opts=opts,
                  kv_dtype=kv_dtype, device="cpu") | eng_kw

    def worker(r):
        params, host = rank_params(m, cfg, plan, r, ngl, opts.dtype)
        TcpRingWorker(RingContext(nodes[r], plan, r, world), cfg, params,
                      max_seq=eng_kw["max_seq"], opts=opts, kv_dtype=kv_dtype,
                      n_slots=n_slots, n_groups=n_groups, streamed_host=host,
                      device="cpu").serve(timeout=DEADLINE)

    def master():
        params, host = rank_params(m, cfg, plan, 0, ngl, opts.dtype)
        eng = TcpRingEngine(RingContext(nodes[0], plan, 0, world), cfg, params,
                            streamed_host=host, recv_timeout=DEADLINE, **eng_kw)
        try:
            return fn(eng)
        finally:
            eng.stop()

    try:
        return run_threads([master] + [lambda r=r: worker(r) for r in range(1, world)])[0]
    finally:
        for n in nodes:
            n.close()


def serve_prompts(eng, prompts: list, n_predict: int) -> list:
    """Greedy tokens for each prompt, all submitted at once."""
    slots = [eng.submit(p, n_predict=n_predict, request_id=i) for i, p in enumerate(prompts)]
    while any(s.state.name != "IDLE" for s in slots):
        eng.step()
    return [list(s.generated) for s in slots]


# -- the wire ------------------------------------------------------------------


def _bytes(send, a) -> bytes:
    r, w = socket.socketpair()
    with r, w:
        send(w, a)
        w.shutdown(socket.SHUT_WR)
        data = b""
        while chunk := r.recv(1 << 16):
            data += chunk
    return data


def _wire_input(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if kind == "int32":
        return rng.integers(-2**31, 2**31 - 1, (2, 3, 5), dtype=np.int32)
    if kind == "uint8":
        return rng.integers(0, 256, (7, 9), dtype=np.uint8)
    a = rng.standard_normal((2, 3, 16)).astype(np.float32)
    # values whose dropped low bits would round the bf16 up
    a.reshape(-1)[:4] = np.array([1 + 2**-8 + 2**-20, -3.0 - 2**-7 - 2**-15, 65504.0,
                                  1e-30], np.float32)
    return a


@pytest.mark.parametrize("kind", ["f32", "int32", "uint8", "bf16"])
def test_wire_bytes_match_jax(kind):
    a = _wire_input(kind)
    pairs = [(jring.send_tensor, ring_tcp.send_tensor)]
    if kind == "bf16":
        pairs = [(jring.send_act, ring_tcp.send_act)]
    elif kind != "f32":
        pairs.append((jring.send_act, ring_tcp.send_act))  # non-f32 acts go as they are
    for jsend, send in pairs:
        want, got = _bytes(jsend, a), _bytes(send, a)
        assert got == want
        r, w = socket.socketpair()
        with r, w:
            w.sendall(got)
            back = ring_tcp.recv_act(r)
        assert back.dtype == (np.float32 if kind in ("f32", "bf16") else a.dtype)
    if kind == "bf16":  # truncation, not the rounding of .to(torch.bfloat16)
        want = (a.view(np.uint32) & 0xFFFF0000).view(np.float32)
        assert np.array_equal(back, want)
        rounded = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
        assert not np.array_equal(back, rounded)


@pytest.mark.parametrize("windows,k", [([3, 1], 1), ([1, 1], 2), ([2, 1, 1], 1),
                                       ([4, 0, 2], 3), ([5], 2)])
def test_layer_ranges_match_jax(windows, k):
    plan, jplan = RingPlan(windows, k), JRingPlan(windows, k)
    assert plan.layer_ranges() == jplan.layer_ranges()
    assert (plan.n_layers, plan.W, plan.n_devices) == (jplan.n_layers, jplan.W, jplan.n_devices)
    owned = [plan.owned(d) for d in range(len(windows))]
    assert sorted(i for o in owned for i in o) == list(range(plan.n_layers))


# -- the windowed forward ------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny llama (4 layers, Q8_0) written by the JAX package's writer."""
    path = str(tmp_path_factory.mktemp("ring") / "tiny4.gguf")
    return make_tiny_gguf(path, n_layers=4, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128,
                          ftype=GGMLType.Q8_0, seed=3)


def _arch_model(tmp_path, arch: str, tiny: str) -> str:
    if arch == "llama":
        return tiny
    # gemma2: sliding window on even layers; openelm: per-layer heads
    return write_model(tmp_path / f"{arch}.gguf", arch, F32, n_layers=3)


@pytest.mark.parametrize("arch", ["llama", "gemma2", "openelm"])
def test_windowed_forward_matches_whole_and_jax(arch, tiny, tmp_path):
    path = _arch_model(tmp_path, arch, tiny)
    m = GGUFModel.open(path)
    cfg = ModelConfig.from_gguf(m)
    params = load_params(m, cfg, "cpu", dtype=torch.float32)
    jm = JGGUFModel.open(path)
    jcfg = JModelConfig.from_gguf(jm)
    jparams = jload_params(jm, jcfg, dtype=jnp.float32)
    L, b, s, T = cfg.n_layers, 2, 7, 16
    cuts = [(0, 1), (1, L)] if L < 4 else [(0, 1), (1, 3), (3, L)]  # at odd layers
    toks = np.random.default_rng(1).integers(0, cfg.n_vocab, (b, s))
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    tt, tp, cp = torch.from_numpy(toks), torch.from_numpy(pos), torch.zeros(b, dtype=torch.int32)
    with torch.no_grad():
        whole, _ = forward(params, cfg, tt, tp, init_kv_caches(cfg, b, T, torch.float32),
                           cp, F32_OPTS)
        kv, x = init_kv_caches(cfg, b, T, torch.float32), None
        for lo, hi in cuts:
            x, _ = forward(params, cfg, tt if lo == 0 else None, tp, kv, cp, F32_OPTS,
                           layer_range=(lo, hi), hidden_in=x)
    assert x.shape == whole.shape and torch.equal(x, whole)
    jkv, jx = jinit_kv(jcfg, b, T, jnp.float32), None
    for lo, hi in cuts:
        fwd = jax.jit(lambda p, t, x, kv, lo=lo, hi=hi: jforward(
            p, jcfg, t, pos, kv, np.zeros(b, np.int32), JOPTS, layer_range=(lo, hi),
            hidden_in=x))
        jx, jkv = fwd(jparams, toks.astype(np.int32) if lo == 0 else None, jx, jkv)
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() <= 1e-4 * np.abs(jx).max()


# -- rings of threads against the JAX forward ------------------------------------


def _trunc(x):
    return (np.asarray(x, np.float32).view(np.uint32) & 0xFFFF0000).view(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_programs(path: str):
    """The model's JAX params, and its one-layer and head programs."""
    jm = JGGUFModel.open(path)
    cfg = JModelConfig.from_gguf(jm)
    params = jload_params(jm, cfg, dtype=jnp.float32)

    @functools.partial(jax.jit, static_argnames="first")
    def layer(p, kv_i, tokens, x, pos, first):
        # the first layer (with the embedding) at index 0, any other at
        # index 1 of a short list: one program serves every later layer
        at = 0 if first else 1
        out, new = jforward({**p, "layers": [None] * at + [p["layers"]]}, cfg, tokens, pos,
                            [None] * at + [kv_i], pos[:, 0], JOPTS, return_hidden=True,
                            layer_range=(at, at + 1), hidden_in=x, mask_positions=pos)
        return out, new[at]

    @jax.jit
    def head(p, x):
        x = jmodel_norm(x, p.get("output_norm"), p.get("output_norm_b"), cfg)
        w = p["output"] if p.get("output") is not None else p["tok_embd"]
        return jlinear(x, w, "xla")

    return cfg, params, layer, head


@functools.lru_cache(maxsize=None)  # the streamed-window cases share it
def jax_ring_stream(path: str, windows: tuple, k: int, prompt: tuple, n_new: int):
    """Greedy tokens and logits of the ring computed with the JAX forward
    in f32, window by window, the activation truncated to bf16 at every hop
    between ranks (each window hop and the last one back to rank 0). A
    window runs its layers one forward(layer_range=(i, i + 1)) after
    another, each compiled once for all layers of its shape."""
    cfg, params, layer, head = _jax_programs(path)
    ranges = JRingPlan(windows, k).layer_ranges()
    order = [ranges[d][c] for c in range(k) for d in range(len(windows))
             if ranges[d][c][1] > ranges[d][c][0]]
    hops = len(windows) > 1
    kv = jinit_kv(cfg, 1, 64, jnp.float32)

    state = {"pos": 0}
    shared = {n: params[n] for n in ("tok_embd", "output_norm", "output") if n in params}

    def ring(tokens):
        n = len(tokens)
        pos = np.arange(state["pos"], state["pos"] + n, dtype=np.int32)[None]
        x = None
        for j, (lo, hi) in enumerate(order):
            if j and hops:
                x = jnp.asarray(_trunc(x))
            for i in range(lo, hi):
                x, kv[i] = layer({**shared, "layers": params["layers"][i]}, kv[i],
                                 np.asarray([tokens], np.int32) if i == 0 else None, x,
                                 pos, first=i == 0)
        if hops:
            x = jnp.asarray(_trunc(x))
        state["pos"] += n
        return np.asarray(head(params, x), np.float32)[0, -1]

    ring(list(prompt[:-1]))
    cur, toks, logits = prompt[-1], [], []
    for _ in range(n_new):
        row = ring([cur])
        cur = int(np.argmax(row))
        toks.append(cur)
        logits.append(row)
    return toks, logits


def _recording(eng) -> list:
    """Record the logits the engine's head gives at each decode step."""
    rec, head = [], eng.core.head
    eng.core.head = lambda h: rec.append(head(h)) or rec[-1]
    return rec


@pytest.mark.parametrize("ngl", [-1, 0, 1], ids=["resident", "ngl0", "ngl1"])
@pytest.mark.parametrize("windows,k", [([3, 1], 1), ([1, 1], 2), ([2, 1, 1], 1)],
                         ids=["3,1-k1", "1,1-k2", "2,1,1-k1"])
def test_ring_streams_match_jax_windows(tiny, windows, k, ngl):
    prompt, n_new = [1, 17, 42, 7, 99, 23], 8
    want, want_logits = jax_ring_stream(tiny, tuple(windows), k, tuple(prompt), n_new)

    def run(eng):
        rec = _recording(eng)
        out = serve_prompts(eng, [prompt], n_new)[0]
        return out, [r[0, -1].numpy() for r in rec]

    got, logits = serve_ring(tiny, windows, k, run, ngl=ngl)
    assert got == want
    for g, w in zip(logits, want_logits):
        assert np.abs(g - w).max() <= WIRE_TOL * np.abs(w).max()


def test_host_ring_executor_matches_forward(tiny):
    m = GGUFModel.open(tiny)
    cfg = ModelConfig.from_gguf(m)
    params = load_params(m, cfg, "cpu", dtype=torch.float32)
    head = {k: v for k, v in params.items() if k != "layers"}
    prompt = [1, 17, 42, 7, 99, 23]
    streams = []
    for windows, k in (([1, 1], 2), ([3, 1], 1), ([4], 1)):
        ex = HostRingExecutor(cfg, RingPlan(windows, k), lambda i: params["layers"][i], head,
                              ["cpu"] * len(windows), max_seq=32, opts=F32_OPTS,
                              kv_dtype=torch.float32)
        assert [sum(p is not None for p in d["layers"]) for d in ex.params] == \
            [w * k for w in windows]
        streams.append(ex.greedy_generate(prompt, 6))
    eng = Engine(cfg, params, n_slots=1, max_seq=32, opts=F32_OPTS, kv_dtype=torch.float32,
                 device="cpu")
    assert streams == [eng.run_to_completion(prompt, n_predict=6)] * 3


# -- TcpRingEngine against the one-process Engine --------------------------------


@pytest.fixture(scope="module")
def pair():
    m = load_model(PAIR, device="cpu", dtype=torch.float32)
    tok = m.tokenizer
    prompts = [tok.encode(t, add_special=True) for t in
               ("def main():", "The quick brown fox", "import numpy as np", "class Foo:")]
    return m, prompts


def _engine_streams(m, prompts, n_predict, **kw) -> list:
    kw = dict(n_slots=1, max_seq=64, n_batch=16) | kw
    eng = Engine(m.cfg, m.params, opts=F32_OPTS, kv_dtype=kw.pop("kv_dtype", torch.float32),
                 eog_ids=m.eog_ids, device="cpu", **kw)
    return serve_prompts(eng, prompts, n_predict)


def test_ring_engine_groups_match_engine(pair):
    m, prompts = pair
    got = serve_ring(PAIR, [2, 2], 1, lambda e: serve_prompts(e, prompts, 10), n_slots=4,
                     n_groups=2, eog_ids=m.eog_ids)
    assert got == _engine_streams(m, prompts, 10, n_slots=4)


@pytest.mark.parametrize("case", ["ctx_shift", "self_extend", "q8_0"])
def test_ring_engine_long_context_matches_engine(pair, case):
    m, prompts = pair
    kw = {"ctx_shift": dict(max_seq=24, ctx_shift=True, n_keep=2),
          "self_extend": dict(max_seq=64, grp_attn_n=2, grp_attn_w=8),
          "q8_0": dict(max_seq=64, kv_dtype="q8_0")}[case]
    n = 30 if case == "ctx_shift" else 16
    got = serve_ring(PAIR, [3, 1], 1, lambda e: serve_prompts(e, prompts[:1], n),
                     eog_ids=set(), **kw)
    want = _engine_streams(m, prompts[:1], n, **kw)
    assert got == want and len(got[0]) == n
    if case == "ctx_shift":
        assert len(prompts[0]) + n > kw["max_seq"]  # generated past -c


def _bootstrap_ring(path: str, world: int, profiles, manual_w, prompts, n_predict):
    """Every rank bootstraps (profile gather, the layer setup), then the
    ring serves: active ranks their windows, removed ones relay. Returns
    rank 0's streams and each rank's bootstrap result."""
    m = GGUFModel.open(path)
    cfg = ModelConfig.from_gguf(m)
    cost = model_cost_from_gguf(m)
    nodes = connected(world)
    results = [None] * world

    def rank(r):
        res = results[r] = bootstrap(nodes[r], profiles[r], cost, n_ctx=64,
                                     manual_w=manual_w)
        if not res.is_active:
            return relay_loop(nodes[r], timeout=DEADLINE)
        plan = RingPlan(res.w, res.k)
        owned = plan.owned(res.rank)
        params = load_params(m, cfg, "cpu", dtype=torch.float32,
                             layer_filter=owned.__contains__, with_embedding=res.rank == 0,
                             with_output=res.rank == 0)
        ctx = RingContext(nodes[r], plan, res.rank, res.world)
        if res.rank:
            return TcpRingWorker(ctx, cfg, params, max_seq=64, opts=F32_OPTS,
                                 kv_dtype=torch.float32, device="cpu").serve(DEADLINE)
        eng = TcpRingEngine(ctx, cfg, params, n_slots=1, max_seq=64, n_batch=16,
                            opts=F32_OPTS, kv_dtype=torch.float32, device="cpu",
                            recv_timeout=DEADLINE)
        try:
            return serve_prompts(eng, prompts, n_predict)
        finally:
            eng.stop()

    try:
        got = run_threads([lambda r=r: rank(r) for r in range(world)])[0]
    finally:
        for n in nodes:
            n.close()
    return got, results


GiB = 1 << 30


def _profile(weak: bool = False) -> DeviceProfile:
    if weak:  # device memory short of one tiny layer (0.85 MB): the solver drops it
        return DeviceProfile(platform="cpu", flops_bf16=0.01, flops_f32=0.005,
                             flops_q4k_dequant=0.005, hbm_bw=0.5, h2d_bw=0.001,
                             host_ram_bw=50.0, disk_seq_bw=0.01, disk_rand_bw=0.001,
                             hbm_total=500_000, hbm_free=500_000, host_ram_total=GiB,
                             host_ram_avail=GiB, dispatch_latency_s=1e-4)
    return DeviceProfile(platform="cpu", flops_bf16=100.0, flops_f32=50.0,
                         flops_q4k_dequant=50.0, hbm_bw=800.0, h2d_bw=5.0, host_ram_bw=50.0,
                         disk_seq_bw=1.0, disk_rand_bw=0.1, hbm_total=16 * GiB,
                         hbm_free=16 * GiB, host_ram_total=64 * GiB,
                         host_ram_avail=64 * GiB, dispatch_latency_s=1e-4)


@pytest.mark.parametrize("mode", ["manual", "auto"])
def test_bootstrap_and_relaying_rank(pair, mode):
    """Manual -lw 2,0,2 and the solver (rank 1 too weak to hold a layer):
    rank 1 gets w = 0 and relays, ranks 0 and 2 serve as a ring of two."""
    m, prompts = pair
    profiles = [_profile(), _profile(weak=True), _profile()]
    manual_w = [2, 0, 2] if mode == "manual" else None
    got, res = _bootstrap_ring(PAIR, 3, profiles, manual_w, prompts[:1], 8)
    assert [r.is_active for r in res] == [True, False, True]
    assert res[0].removed == [1] and res[2].world == 2 and res[2].rank == 1
    assert sum(res[0].w) * res[0].k == m.cfg.n_layers
    if mode == "auto":  # the JAX package's solver on the same profiles
        cost = jmodel_cost(JGGUFModel.open(PAIR))
        want = jassign([JDeviceProfile.from_dict(p.to_dict()) for p in profiles], cost,
                       n_ctx=64)
        assert [w for w in want.w if w] == res[0].w and want.k == res[0].k
    assert got == _engine_streams(m, prompts[:1], 8)


def test_verify_chain_accepts_self_draft(pair):
    """The ring target with its own weights as the draft: every draft is
    accepted, and the stream is plain greedy decoding's."""
    m, prompts = pair

    def run(eng):
        draft = Engine(m.cfg, m.params, n_slots=1, max_seq=64, opts=F32_OPTS,
                       kv_dtype=torch.float32, device="cpu")
        stats = SpecStats()
        # 15 tokens: three rounds of 4 drafts and the target's own token
        spec = SpeculativeDecoder(eng, draft, n_draft=4, p_min=0.0)
        out = [t for chunk in spec.generate_stream(prompts[1], n_predict=15, stats=stats)
               for t in chunk]
        return out, stats

    out, stats = serve_ring(PAIR, [2, 2], 1, run)
    assert (stats.n_drafted, stats.n_accepted, stats.n_target_calls) == (12, 12, 3)
    assert out == _engine_streams(m, prompts[1:2], 15)[0]
