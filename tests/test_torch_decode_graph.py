"""runtime/decode_graph.py: the decode step replayed as CUDA graphs between
its eager GEMV calls, and the cached RoPE frequencies it needs.

On the CPU: every input that rules a graph out takes the eager forward;
`rope_freqs` gives the values it gave before it was cached, on every
scaling kind, and makes no tensor after its first call; the counters count
graph and eager steps. A fake graph backend (its "capture" runs the ops at
once and its replay does nothing) drives the capture's control flow on the
CPU: the plan's segments, boundaries and spans, the boundary calls a step,
the kernel launches a segment counts on each replay, a new capture when a
cache is replaced, the eager fallback when an op cannot be captured, and
any other error of a capture raised. Its logits are meaningless.

On the card (marked cuda, skipped here; the card's machine has no JAX, so
run it there without the suite's conftest):

    python -m pytest --noconftest -q tests/test_torch_decode_graph.py

a tiny Qwen2-style dense model (q/k/v biases) and a tiny mixture of experts
run 32 decode steps of step_fused with greedy and sampled rows: each step's
logits equal, bit for bit, the eager forward's from the same caches (the
same kernels in the same order on the same inputs: no tolerance), the
tokens equal an eager engine's, wrappers on qmatmul.qgemv,
qmatmul.qgemv_indexed and llama.moe_ffn see as many calls a step as on the
eager path and fresh expert ids each step, and a replaced cache tensor
captures anew; a first step in a fresh thread captures; the launch counts of kv_store and flash_decode a step (q8_0
and bf16 caches) equal the eager path's; a `.item()` or a copy from
pageable memory inside the forward makes the engine decode eagerly, with
the eager logits.
"""

import contextlib
import math
import re
import threading
from dataclasses import replace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from prima_tpu_torch.gguf.constants import GGMLType
from prima_tpu_torch.models import llama
from prima_tpu_torch.models.config import RopeScaling, RopeType, tiny_config
from prima_tpu_torch.models.llama import ForwardOptions
from prima_tpu_torch.ops import layers
from prima_tpu_torch.quant import qmatmul as qm
from prima_tpu_torch.runtime import decode_graph as dg
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.sampling import Sampler, SamplerParams
from prima_tpu_torch.utils import nvcc, perf

N_SLOTS = 4


class _FakeGraph:
    def replay(self):
        pass


class _Ops(TorchDispatchMode):
    """Counts the ops that would launch work on a device: not views, not
    bare allocations."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and func.overloadpacket not in (
                torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided):
            self.n += 1
        return func(*args, **(kwargs or {}))


class FakeGraphs:
    """CudaGraphs' methods on the CPU: the ops run at once, nothing is
    replayed, and a segment's nodes are the ops it ran."""

    device_type = "cpu"

    def __init__(self, device):
        self.ops = _Ops()

    def new(self):
        return _FakeGraph()

    def begin(self, g):
        self.ops.n = 0

    def end(self, g):
        pass

    def nodes(self):
        return self.ops.n

    @contextlib.contextmanager
    def side_stream(self):
        with self.ops:
            yield


def _dense_cfg(**kw):
    return tiny_config(arch="qwen2", n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2,
                       head_dim=64, rope_dim=64, n_ff=512, n_vocab=512, qkv_bias=True,
                       rope_type=RopeType.NEOX, rope_base=1e6, **kw)


def _moe_cfg():
    return tiny_config(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64,
                       rope_dim=64, n_ff=512, n_vocab=512, n_expert=4, n_expert_used=2)


def _params(cfg, device, seed=0):
    params = llama.synth_params_device(cfg, GGMLType.Q4_K, seed, device)
    if cfg.n_expert:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 1)
        e, f, n = cfg.n_embd, cfg.n_ff, cfg.n_expert
        for layer in params["layers"]:
            for k in ("w_gate", "w_up", "w_down"):
                del layer[k]
            q = lambda rows, k: llama.synth_qtensor_device(gen, rows, k, GGMLType.Q4_K, device,
                                                          zero_mean=True)
            layer.update(ffn_gate_inp=torch.randn(n, e, generator=gen, device=device),
                         ffn_gate_exps=q(n * f, e), ffn_up_exps=q(n * f, e),
                         ffn_down_exps=q(n * e, f))
    return params


def _engine(cfg, params, device, opts=None, kv="bf16"):
    kv_dtype = torch.bfloat16 if kv == "bf16" else kv
    return Engine(cfg, params, n_slots=N_SLOTS, max_seq=128, n_batch=32,
                  opts=opts or ForwardOptions(), kv_dtype=kv_dtype, device=device)


def _inputs(cfg, device, b=N_SLOTS):
    tokens = torch.arange(b, device=device)[:, None] % cfg.n_vocab
    pos = torch.full((b,), 3, dtype=torch.int32, device=device)
    return tokens, pos[:, None], pos


class _Identity:
    """A tp / sp group of one rank."""

    index = 0

    def all_reduce(self, x, op="sum"):
        return x


@contextlib.contextmanager
def _recording():
    was = perf.enable(True)
    try:
        with perf.recording() as rec:
            yield rec
    finally:
        perf.enable(was)


# -- every excluded input takes the eager path --------------------------------------------


def _excluded(cfg, params, device):
    """name -> (params, tokens, opts, forward kwargs) of a call that must run eagerly."""
    tokens, pos, cpos = _inputs(cfg, device)
    e, r = cfg.n_embd, 4
    gen = torch.Generator().manual_seed(3)
    lora = dict(params, layers=[dict(params["layers"][0], wq_lora=[(
        torch.randn(r, e, generator=gen), torch.randn(e, r, generator=gen) * 0.01, 1.0)])]
        + params["layers"][1:])
    cvec = dict(params, layers=[dict(params["layers"][0], cvec=torch.ones(e) * 0.01)]
                + params["layers"][1:])
    t_cache = 128
    return {
        "taps": (params, tokens, ForwardOptions(), {"taps": {}}),
        "attn_mask": (params, tokens, ForwardOptions(),
                      {"attn_mask": torch.zeros(N_SLOTS, 1, 1, t_cache)}),
        "layer_range": (params, tokens, ForwardOptions(), {"layer_range": (0, cfg.n_layers)}),
        "tp_group": (params, tokens, ForwardOptions(tp_group=_Identity()), {}),
        "sp_group": (params, tokens, ForwardOptions(sp_group=_Identity()), {}),
        "lora": (lora, tokens, ForwardOptions(), {}),
        "control_vector": (cvec, tokens, ForwardOptions(), {}),
        "fewer_rows": (params, tokens[:2], ForwardOptions(), {}),
    }


EXCLUDED = ["taps", "attn_mask", "layer_range", "tp_group", "sp_group", "lora",
            "control_vector", "fewer_rows"]


@pytest.mark.parametrize("name", EXCLUDED + ["cpu_device"])
def test_excluded_inputs_take_the_eager_path(name):
    cfg = _dense_cfg()
    params = _params(cfg, "cpu")
    caches = llama.init_kv_caches(cfg, N_SLOTS, 128, torch.float32, "cpu")
    if name == "cpu_device":  # the real backend: CUDA only
        graph = dg.DecodeGraph(N_SLOTS)
        p, tokens, opts, kw = params, _inputs(cfg, "cpu")[0], ForwardOptions(), {}
    else:
        graph = dg.DecodeGraph(N_SLOTS, graphs=FakeGraphs)
        p, tokens, opts, kw = _excluded(cfg, params, "cpu")[name]
        assert (dg.call_blocker(tokens, opts, N_SLOTS, kw, "cpu")
                or dg.params_blocker(p)) is not None
    opts = replace(opts, dtype=torch.float32)
    b = tokens.shape[0]
    pos = torch.full((b,), 3, dtype=torch.int32)
    twin = [(k[:b].clone(), v[:b].clone()) for k, v in caches]
    mine = [(k[:b].clone(), v[:b].clone()) for k, v in caches]
    want, _ = llama.forward(p, cfg, tokens, pos[:, None], twin, pos, opts,
                            **{k: (v if k != "taps" else {}) for k, v in kw.items()})
    with _recording() as rec:
        got, _ = graph(p, cfg, tokens, pos[:, None], mine, pos, opts, **kw)
    assert dict(rec.counts) == {"decode.eager_steps": 1}
    assert graph.plan is None
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if name == "taps":
        assert kw["taps"], "the eager forward collected the taps"


def test_the_plain_call_is_not_excluded():
    cfg = _dense_cfg()
    params = _params(cfg, "cpu")
    tokens = _inputs(cfg, "cpu")[0]
    assert dg.call_blocker(tokens, ForwardOptions(), N_SLOTS, {"mask_positions": None},
                           "cpu") is None
    assert dg.params_blocker(params) is None
    assert dg.call_blocker(tokens, ForwardOptions(), N_SLOTS, {}) == "device"


# -- rope_freqs, built once --------------------------------------------------------------


def _rope_freqs_uncached(cfg, device=None):
    """rope_freqs as it was before its cache: built on every call."""
    half = cfg.rope_dim // 2
    base = cfg.rope_base
    exps = torch.arange(0, half, dtype=torch.float32, device=device) * 2.0 / cfg.rope_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32, device=device), exps)
    s = cfg.rope_scaling
    mscale = 1.0
    if s.kind == "linear":
        inv_freq = inv_freq / s.factor
    elif s.kind == "yarn":
        freq_scale = 1.0 / s.factor
        orig = s.orig_ctx or cfg.n_ctx_train
        low = max(0.0, math.floor(layers._yarn_corr_dim(cfg.rope_dim, orig, s.beta_fast,
                                                        base)))
        high = min(cfg.rope_dim / 2.0 - 1.0,
                   math.ceil(layers._yarn_corr_dim(cfg.rope_dim, orig, s.beta_slow, base)))
        ramp = layers._yarn_ramp(low, high, torch.arange(half, dtype=torch.float32,
                                                         device=device))
        ext = 1.0 if s.ext_factor < 0 else s.ext_factor
        ramp_mix = ramp * ext
        inv_freq = inv_freq * freq_scale * (1.0 - ramp_mix) + inv_freq * ramp_mix
        mscale = s.attn_factor
        if ext != 0.0:
            mscale = float(s.attn_factor * (1.0 + 0.1 * math.log(s.factor)))
    return inv_freq, mscale


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


SCALINGS = {
    "none": {},
    "linear": dict(kind="linear", factor=4.0),
    "yarn": dict(kind="yarn", factor=4.0, orig_ctx=64, ext_factor=1.0, attn_factor=1.0),
    "yarn-noext": dict(kind="yarn", factor=2.0, orig_ctx=64, ext_factor=0.0),
    "yarn-auto": dict(kind="yarn", factor=8.0, orig_ctx=128, beta_fast=16.0),
}


@pytest.mark.parametrize("scaling", list(SCALINGS))
def test_rope_freqs_cached_equals_uncached(scaling):
    cfg = tiny_config(rope_scaling=RopeScaling(**SCALINGS[scaling]), rope_dim=32,
                      head_dim=32, rope_base=500000.0 + len(scaling))
    want, want_m = _rope_freqs_uncached(cfg)
    inv, m = layers.rope_freqs(cfg)
    assert torch.equal(inv, want) and m == want_m
    with _CountOps() as ops:
        inv2, m2 = layers.rope_freqs(cfg, torch.device("cpu"))
    assert inv2 is inv and m2 == m and ops.n == 0
    # another set of parameters is another entry, not the first one's tensor
    cfg.rope_base *= 2
    inv3, _ = layers.rope_freqs(cfg)
    assert torch.equal(inv3, _rope_freqs_uncached(cfg)[0]) and inv3 is not inv


# -- the capture's control flow, on a fake backend ------------------------------------------


def _serve(eng, n_steps: int, seed: int = 5) -> list:
    """Greedy and sampled rows through step_fused until n_steps decode
    steps ran; the tokens of each request."""
    slots = []
    for i in range(N_SLOTS):
        p = SamplerParams(temp=0.0) if i % 2 else SamplerParams(temp=0.8, seed=seed + i)
        slots.append(eng.submit([1 + i, 7, 9, 11 + i, 3], sampler=Sampler(p),
                                n_predict=n_steps))
    while any(s.state.name != "IDLE" for s in slots):
        eng.step_fused(max_chunk=4)
    return [list(s.generated) for s in slots]


def _count_calls(monkeypatch):
    """Calls of qgemv, qgemv_indexed and moe_ffn, and moe_ffn's expert ids."""
    calls = {"qgemv": 0, "qgemv_indexed": 0, "moe_ffn": 0, "ids": []}
    gemv, indexed, moe = qm.qgemv, qm.qgemv_indexed, llama.moe_ffn

    def qgemv(x, qt, ksplit=None):
        calls["qgemv"] += 1
        return gemv(x, qt, ksplit)

    def qgemv_indexed(x, qt, ids, n, ksplit=None, per_expert=None):
        calls["qgemv_indexed"] += 1
        return indexed(x, qt, ids, n, ksplit, per_expert)

    def moe_ffn(layer, cfg, x, opts):
        calls["moe_ffn"] += 1
        real = torch.topk

        def topk(*a, **kw):
            out = real(*a, **kw)
            calls["ids"].append(out[1])
            return out

        monkeypatch.setattr(torch, "topk", topk)
        try:
            return moe(layer, cfg, x, opts)
        finally:
            monkeypatch.setattr(torch, "topk", real)

    monkeypatch.setattr(qm, "qgemv", qgemv)
    monkeypatch.setattr(qm, "qgemv_indexed", qgemv_indexed)
    monkeypatch.setattr(llama, "moe_ffn", moe_ffn)
    return calls


def _per_step(eng, calls, n_steps: int) -> list:
    """The boundary calls of each of n_steps single decode steps."""
    out = []
    for _ in range(n_steps):
        before = {k: calls[k] for k in ("qgemv", "qgemv_indexed", "moe_ffn")}
        n_ids = len(calls["ids"])
        eng.step_fused(max_chunk=1)
        out.append(({k: calls[k] - v for k, v in before.items()}, calls["ids"][n_ids:]))
    return out


@pytest.mark.parametrize("moe", [False, True])
def test_plan_steps_and_boundary_calls_on_a_fake_backend(moe, monkeypatch):
    cfg = _moe_cfg() if moe else _dense_cfg()
    params = _params(cfg, "cpu")
    runs = {}
    for name in ("graph", "eager"):
        eng = _engine(cfg, params, "cpu", ForwardOptions(dtype=torch.float32), torch.float32)
        if name == "graph":
            eng._decode_graph = dg.DecodeGraph(N_SLOTS, graphs=FakeGraphs)
        for i in range(N_SLOTS):
            eng.submit([1 + i, 2, 3], n_predict=8)
        eng.step()  # the prompts, and the capturing step
        calls = _count_calls(monkeypatch)
        with _recording() as rec:
            runs[name] = (_per_step(eng, calls, 4), dict(rec.counts))
        monkeypatch.undo()
    (graph_steps, graph_counts), (eager_steps, eager_counts) = runs["graph"], runs["eager"]
    part = lambda counts, kind: {k: v for k, v in counts.items() if k.startswith(kind)}
    assert part(graph_counts, "decode.") == {"decode.graph_steps": 4}
    assert part(eager_counts, "decode.") == {"decode.eager_steps": 4}
    # moe_ffn runs whole on every step, graphed or not: its counters agree
    assert part(graph_counts, "moe.") == part(eager_counts, "moe.")
    assert set(graph_counts) == set(part(graph_counts, "decode.")) | set(
        part(graph_counts, "moe."))
    for (g, g_ids), (e, e_ids) in zip(graph_steps, eager_steps):
        assert g == e and len(g_ids) == len(e_ids)
        assert g["qgemv"] == (4 if moe else 7) * cfg.n_layers + 1
        assert g["moe_ffn"] == (cfg.n_layers if moe else 0)
    ids = [t for _, step_ids in graph_steps for t in step_ids]
    assert len({id(t) for t in ids}) == len(ids) == (4 * cfg.n_layers if moe else 0)


def _walk(steps, depth=0):
    for s in steps:
        if isinstance(s, dg._Span):
            yield depth, s.name, s.attrs
            yield from _walk(s.steps, depth + 1)
        else:
            yield depth, type(s).__name__, None


def _flat(steps):
    for s in steps:
        if isinstance(s, dg._Span):
            yield from _flat(s.steps)
        else:
            yield s


def test_the_plan_of_a_dense_step():
    """Spans as the forward opens them, 7 GEMVs a layer with none between
    wq / wk / wv and w_gate / w_up, and segments between the rest."""
    cfg = _dense_cfg()
    params = _params(cfg, "cpu")
    eng = _engine(cfg, params, "cpu", ForwardOptions(dtype=torch.float32), torch.float32)
    eng._decode_graph = dg.DecodeGraph(N_SLOTS, graphs=FakeGraphs)
    for i in range(N_SLOTS):
        eng.submit([1 + i, 2, 3], n_predict=2)
    with _recording() as rec:
        eng.step()
    # the capturing step runs eagerly
    assert dict(rec.counts) == {"decode.graph_captures": 1, "decode.eager_steps": 1}
    got = [(d, n, a) for d, n, a in _walk(eng._decode_graph.plan.steps)]
    seg = "_Segment"
    layer = lambda i: [
        (0, "fwd.attn", {"layer": i}), (1, seg, None), (1, "_Gemv", None), (1, "_Gemv", None),
        (1, "_Gemv", None), (1, seg, None), (1, "_Gemv", None),
        (0, "fwd.ffn", {"layer": i}), (1, seg, None), (1, "_Gemv", None), (1, "_Gemv", None),
        (1, seg, None), (1, "_Gemv", None), (1, seg, None)]
    # f32 activations: the head's GEMV output is the logits, with no cast after it
    want = [(0, "fwd.embed", {}), (1, seg, None), (0, seg, None), *layer(0), *layer(1),
            (0, "fwd.head", {}), (1, seg, None), (1, "_Gemv", None)]
    assert got == want


def test_a_replaced_cache_or_params_captures_anew():
    cfg = _dense_cfg()
    params = _params(cfg, "cpu")
    eng = _engine(cfg, params, "cpu", ForwardOptions(dtype=torch.float32), torch.float32)
    eng._decode_graph = dg.DecodeGraph(N_SLOTS, graphs=FakeGraphs)
    for i in range(N_SLOTS):
        eng.submit([1 + i, 2, 3], n_predict=8)
    with _recording() as rec:
        eng.step()
        eng.step()
        first = eng._decode_graph.plan
        k, v = eng.kv.caches[1]
        eng.kv.caches[1] = (k.clone(), v)
        eng.step()
        second = eng._decode_graph.plan
        eng.params = dict(eng.params, layers=[dict(layer) for layer in eng.params["layers"]])
        eng.step()
        eng.step()
    assert second is not first and eng._decode_graph.plan is not second
    assert dict(rec.counts) == {"decode.graph_captures": 3, "decode.eager_steps": 3,
                                "decode.graph_steps": 2}


def test_a_refused_key_drops_the_old_plan():
    cfg = _dense_cfg()
    params = _params(cfg, "cpu")
    caches = llama.init_kv_caches(cfg, N_SLOTS, 128, torch.float32, "cpu")
    tokens, pos, cpos = _inputs(cfg, "cpu")
    opts = ForwardOptions(dtype=torch.float32)
    graph = dg.DecodeGraph(N_SLOTS, graphs=FakeGraphs)
    graph(params, cfg, tokens, pos, caches, cpos, opts)
    assert graph.plan is not None
    lora = _excluded(cfg, params, "cpu")["lora"][0]
    graph(lora, cfg, tokens, pos, caches, cpos, opts)
    assert graph.plan is None


def _norm_launches(monkeypatch):
    """A LaunchCounter that rms_norm adds one to on each call, as a kernel
    wrapper inside a segment does."""
    monkeypatch.setattr(nvcc.LaunchCounter, "every", list(nvcc.LaunchCounter.every))
    counter = nvcc.LaunchCounter("norm")
    real = llama.rms_norm

    def rms_norm(*a, **kw):
        counter.count += 1
        return real(*a, **kw)

    monkeypatch.setattr(llama, "rms_norm", rms_norm)
    return counter


def test_a_segment_counts_its_launches_on_each_replay(monkeypatch):
    """The capture's own count is taken back and each replay adds the
    segment's: the capturing step and every later one count what eager
    steps count."""
    cfg = _dense_cfg()
    params = _params(cfg, "cpu")
    counter = _norm_launches(monkeypatch)
    per_step = {}
    for name in ("graph", "eager"):
        eng = _engine(cfg, params, "cpu", ForwardOptions(dtype=torch.float32), torch.float32)
        if name == "graph":
            eng._decode_graph = dg.DecodeGraph(N_SLOTS, graphs=FakeGraphs)
        for i in range(N_SLOTS):
            eng.submit([1 + i, 2, 3], n_predict=8)
        counts = []
        for _ in range(5):  # the prompts and the capturing step, then replays
            counter.count = 0
            eng.step()
            counts.append(counter.count)
        per_step[name] = counts
        if name == "graph":
            plan = eng._decode_graph.plan
    assert per_step["graph"] == per_step["eager"]
    assert per_step["eager"][1] == 2 * cfg.n_layers + 1
    segments = [s for s in _flat(plan.steps) if isinstance(s, dg._Segment)]
    assert sum(n for s in segments for c, n in s.launches if c is counter) == \
        2 * cfg.n_layers + 1


UNCAPTURABLE = [
    "CUDA error: operation not permitted when stream is capturing",
    "CUDA error: operation failed due to a previous error during capture",
    "Cannot copy between CPU and CUDA tensors during CUDA graph capture unless the CPU "
    "tensor is pinned.",
    "kv_store: CUDA error 900",
]
RAISED = [
    "CUDA error: an illegal memory access was encountered",
    "use_count > 0 INTERNAL ASSERT FAILED at CUDACachingAllocator.cpp, during capture",
    "kv_store: CUDA error 700",
    "shape mismatch",
]


def _plant(monkeypatch, msg: str) -> dict:
    """rms_norm raises RuntimeError(msg) while a decode graph is captured."""
    real, tries = llama.rms_norm, {"n": 0}

    def rms_norm(*a, **kw):
        if llama._capturing() is not None:
            tries["n"] += 1
            raise RuntimeError(msg)
        return real(*a, **kw)

    monkeypatch.setattr(llama, "rms_norm", rms_norm)
    return tries


@pytest.mark.parametrize("msg", UNCAPTURABLE)
def test_an_op_that_cannot_be_captured_decodes_eagerly(msg, monkeypatch):
    assert dg.uncapturable(RuntimeError(msg))
    cfg = _dense_cfg()
    params = _params(cfg, "cpu")
    counter = _norm_launches(monkeypatch)
    tries = _plant(monkeypatch, msg)
    caches = llama.init_kv_caches(cfg, N_SLOTS, 128, torch.float32, "cpu")
    twin = [(k.clone(), v.clone()) for k, v in caches]
    tokens, pos, cpos = _inputs(cfg, "cpu")
    opts = ForwardOptions(dtype=torch.float32)
    graph = dg.DecodeGraph(N_SLOTS, graphs=FakeGraphs)
    want, _ = llama.forward(params, cfg, tokens, pos, twin, cpos, opts)
    counter.count = 0
    with _recording() as rec:
        for _ in range(3):
            got, _ = graph(params, cfg, tokens, pos, caches, cpos, opts)
    assert dict(rec.counts) == {"decode.eager_steps": 3}
    assert tries["n"] == 1, "the refused key is not captured again"
    assert graph.plan is None
    # the aborted capture's launches are taken back: three eager steps' worth
    assert counter.count == 3 * (2 * cfg.n_layers + 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("msg", RAISED)
def test_any_other_error_of_a_capture_is_raised(msg, monkeypatch):
    assert not dg.uncapturable(RuntimeError(msg))
    cfg = _dense_cfg()
    params = _params(cfg, "cpu")
    _plant(monkeypatch, msg)
    caches = llama.init_kv_caches(cfg, N_SLOTS, 128, torch.float32, "cpu")
    tokens, pos, cpos = _inputs(cfg, "cpu")
    graph = dg.DecodeGraph(N_SLOTS, graphs=FakeGraphs)
    with pytest.raises(RuntimeError, match="^" + re.escape(msg) + "$"):
        graph(params, cfg, tokens, pos, caches, cpos, ForwardOptions(dtype=torch.float32))
    assert llama._capture is None and graph.plan is None


def test_the_counters_count_eager_steps_on_the_cpu():
    cfg = _dense_cfg()
    eng = _engine(cfg, _params(cfg, "cpu"), "cpu", ForwardOptions(dtype=torch.float32),
                  torch.float32)
    with _recording() as rec:
        _serve(eng, 6)
    assert dict(rec.counts) == {"decode.eager_steps": 6}


# -- on the card ----------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _checked(eng, seen: list):
    """eng's decode graph, each call checked against the eager forward from
    a copy of the same caches: (got logits, want logits, caches equal)."""
    graph = eng._decode_graph

    def call(params, cfg, tokens, positions, caches, cache_pos, opts, **kw):
        twin = [(_clone(k), _clone(v)) for k, v in caches]
        want, _ = llama.forward(params, cfg, tokens, positions, twin, cache_pos, opts, **kw)
        got, out = graph(params, cfg, tokens, positions, caches, cache_pos, opts, **kw)
        same = all(_equal(a, b) for kv, tw in zip(caches, twin) for a, b in zip(kv, tw))
        seen.append((got.clone(), want, same))
        return got, out

    eng._decode_graph = call


def _clone(c):
    if hasattr(c, "qs"):
        return type(c)(c.qs.clone(), c.scale.clone())
    return c.clone()


def _equal(a, b) -> bool:
    if hasattr(a, "qs"):
        return torch.equal(a.qs, b.qs) and torch.equal(a.scale, b.scale)
    return torch.equal(a, b)


CARD_CASES = [("dense", "plain", "bf16"), ("dense", "kernel", "bf16"),
              ("dense", "kernel", "q8_0"), ("moe", "plain", "bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("model,attn,kv", CARD_CASES)
def test_graph_steps_equal_the_eager_forward(dev, model, attn, kv):
    cfg = _moe_cfg() if model == "moe" else _dense_cfg()
    params = _params(cfg, dev)
    opts = ForwardOptions(attn_impl=attn)
    eng = _engine(cfg, params, dev, opts, kv)
    seen: list = []
    _checked(eng, seen)
    with _recording() as rec:
        toks = _serve(eng, 32)
    torch.cuda.synchronize()
    assert rec.counts["decode.graph_captures"] == rec.counts["decode.eager_steps"] == 1
    assert rec.counts["decode.graph_steps"] == len(seen) - 1 and len(seen) >= 32
    for got, want, same in seen:
        assert torch.equal(got, want) and same
    ref = _engine(cfg, params, dev, opts, kv)
    ref._decode_graph = llama.forward
    assert toks == _serve(ref, 32)


BOUNDARY_CASES = [("dense", "plain", "bf16"), ("moe", "plain", "bf16"),
                  ("dense", "kernel", "bf16"), ("dense", "kernel", "q8_0"),
                  ("moe", "kernel", "q8_0")]


@pytest.mark.cuda
@pytest.mark.parametrize("model,attn,kv", BOUNDARY_CASES)
def test_boundaries_see_every_call_on_the_card(dev, model, attn, kv, monkeypatch):
    """The boundary calls, the expert ids and every kernel's launch count
    of each step equal the eager path's."""
    from prima_tpu_torch.parallel.engine import launch_counts

    cfg = _moe_cfg() if model == "moe" else _dense_cfg()
    params = _params(cfg, dev)
    opts = ForwardOptions(attn_impl=attn)
    runs = {}
    for name in ("graph", "eager"):
        eng = _engine(cfg, params, dev, opts, kv)
        if name == "eager":
            eng._decode_graph = llama.forward
        for i in range(N_SLOTS):
            eng.submit([1 + i, 2, 3], n_predict=12)
        eng.step()
        calls = _count_calls(monkeypatch)
        steps = []
        for _ in range(8):
            launch_counts(reset=True)
            steps.append((*_per_step(eng, calls, 1)[0], launch_counts()))
        runs[name] = steps
        monkeypatch.undo()
    for (g, g_ids, g_launches), (e, e_ids, e_launches) in zip(runs["graph"], runs["eager"]):
        assert g == e and g_launches == e_launches
        assert [t.tolist() for t in g_ids] == [t.tolist() for t in e_ids]
        assert g_launches["kv_store"] == cfg.n_layers
        assert g_launches["flash_decode"] == (cfg.n_layers if attn == "kernel" else 0)
        assert (g_launches["qgemv_indexed"] > 0) == (model == "moe")
    ids = [t for _, step_ids, _ in runs["graph"] for t in step_ids]
    assert len({t.data_ptr() for t in ids}) == len(ids) == (8 * cfg.n_layers
                                                             if model == "moe" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["item", "pageable_copy"])
def test_an_op_that_cannot_be_captured_decodes_eagerly_on_the_card(dev, op, monkeypatch):
    """A sync or a copy from pageable memory inside the forward: the
    capture fails, the engine decodes eagerly with the eager logits."""
    cfg = _dense_cfg()
    params = _params(cfg, dev)
    real = llama.rms_norm
    host = torch.ones(1)

    def rms_norm(x, w, eps):
        if op == "item":
            x = x + 0 * x.float().sum().item()
        else:
            x = x + host.to(x.device, x.dtype)
        return real(x, w, eps)

    monkeypatch.setattr(llama, "rms_norm", rms_norm)
    eng = _engine(cfg, params, dev)
    seen: list = []
    _checked(eng, seen)
    for i in range(N_SLOTS):
        eng.submit([1 + i, 2, 3], n_predict=6)
    with _recording() as rec:
        for _ in range(4):
            eng.step()
    assert dict(rec.counts) == {"decode.eager_steps": len(seen)} and len(seen) >= 3
    for got, want, same in seen:
        assert torch.equal(got, want) and same


@pytest.mark.cuda
def test_a_first_step_in_a_fresh_thread_captures(dev):
    """The capturing step is the first in its thread (and on its stream) to
    use cuBLAS, as in a server's warm-up: the step itself runs before the
    capture, so the handle and workspace are made outside it."""
    cfg = _dense_cfg()
    params = _params(cfg, dev)
    caches = llama.init_kv_caches(cfg, N_SLOTS, 128, torch.bfloat16, dev)
    twin = [(k.clone(), v.clone()) for k, v in caches]
    tokens, pos, cpos = _inputs(cfg, dev)
    graph, out = dg.DecodeGraph(N_SLOTS), {}

    def run():
        with _recording() as rec:
            for i in range(2):
                out[i] = graph(params, cfg, tokens, pos, caches, cpos, ForwardOptions(),
                               mask_positions=cpos[:, None])[0].clone()
        out["counts"] = dict(rec.counts)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    want, _ = llama.forward(params, cfg, tokens, pos, twin, cpos, ForwardOptions(),
                            mask_positions=cpos[:, None])
    assert out["counts"] == {"decode.graph_captures": 1, "decode.eager_steps": 1,
                             "decode.graph_steps": 1}
    assert torch.equal(out[0], want) and torch.equal(out[1], want)


@pytest.mark.cuda
def test_a_replaced_cache_tensor_captures_anew_on_the_card(dev):
    cfg = _dense_cfg()
    params = _params(cfg, dev)
    eng = _engine(cfg, params, dev)
    seen: list = []
    _checked(eng, seen)
    for i in range(N_SLOTS):
        eng.submit([1 + i, 2, 3], n_predict=12)
    with _recording() as rec:
        eng.step()
        eng.step()
        k, v = eng.kv.caches[1]
        eng.kv.caches[1] = (k.clone(), v.clone())
        eng.step()
        eng.step()
    assert dict(rec.counts) == {"decode.graph_captures": 2, "decode.eager_steps": 2,
                                "decode.graph_steps": 2}
    for got, want, same in seen:
        assert torch.equal(got, want) and same
