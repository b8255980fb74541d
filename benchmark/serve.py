"""One cell's run: the program built as its server builds it, warmed up,
driven open-loop through EngineWorker, and what the run recorded.

The program is prima_tpu_torch's serving stack below HTTP: an Engine with
the server's options, owned by the server's scheduler thread
(server/scheduler.py EngineWorker). Requests go in through
`EngineWorker.submit` at their due times; each request's event queue
stamps every event with the time the worker put it there.

With tracing on, the benchmark's own wrappers record spans around the
worker's and the engine's calls into each layer, and every GEMV launch,
and a torch.profiler sub-window covers the last seconds of the measured
window, its ends marked between two of the worker's steps.
"""

from __future__ import annotations

import bisect
import gc
import queue
import threading
import time
import types
from dataclasses import dataclass, field

import numpy as np
import torch

from .layout import tensor_table
from .roofline import ModelCost
from .traffic import Request, schedule


class TimedQueue(queue.Queue):
    """A request's event queue that stamps each event as it is put."""

    def __init__(self):
        super().__init__()
        self.stamps: list[tuple[float, object]] = []

    def put(self, item, block=True, timeout=None):
        self.stamps.append((time.perf_counter(), item))
        super().put(item, block, timeout)


@dataclass
class Span:
    name: str
    t0: float
    t1: float = 0.0
    info: dict = field(default_factory=dict)
    launches: list = field(default_factory=list)


@dataclass
class Launch:
    kind: str  # "qgemv" | "qgemv_indexed"
    b: int  # rows of x: batch rows, or (row, expert) pairs
    n: int  # output rows (of one expert)
    k: int
    ggml_type: int
    ids: object = None  # the indexed launch's expert ids (device tensor)
    n_exp: int = 1
    profiled: bool = False
    distinct: int = 1


@dataclass
class Profile:
    t_start: float  # host seconds
    t_stop: float
    events: list  # (name, start, end) in host seconds


class Recorder:
    """Spans and launches from the benchmark's wrappers (tracing on)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.launches: list[Launch] = []
        self.work: list[Span] = []  # the prefill chunks and decode calls open now
        self.profiling = False
        self.profile: Profile | None = None

    def span(self, name: str, fn, info=None, work: bool = False, before=None):
        """fn wrapped in a span called `name`; before() -> dict and
        info(args, kwargs, result, span info) -> dict fill its info. A
        `work` span (a prefill chunk, a decode call) collects the GEMV
        launches made inside it."""
        def wrapped(*a, **kw):
            s = Span(name, time.perf_counter(), info=before() if before else {})
            self.spans.append(s)
            if work:
                self.work.append(s)
            try:
                out = fn(*a, **kw)
            finally:
                if work:
                    self.work.pop()
                s.t1 = time.perf_counter()
            if info is not None:
                s.info.update(info(a, kw, out, s.info))
            return out
        return wrapped

    def launch(self, rec: Launch) -> None:
        rec.profiled = self.profiling
        self.launches.append(rec)
        if self.work:
            self.work[-1].launches.append(rec)


@dataclass
class Served:
    """One request as the run saw it."""
    req: Request
    gen: object  # the GenerationRequest
    due: float  # host seconds
    t_submit: float = 0.0


@dataclass
class Run:
    cfg: dict
    mix: dict
    seconds: float
    cost: ModelCost
    t_start: float  # process start
    t0: float = 0.0  # the first request's due time
    w0: float = 0.0
    w1: float = 0.0
    t_end: float = 0.0
    served: list = field(default_factory=list)
    perf0: dict = field(default_factory=dict)
    perf1: dict = field(default_factory=dict)
    rec: Recorder | None = None
    admitted: dict = field(default_factory=dict)  # request_id -> host seconds
    restore: list = field(default_factory=list)  # (object, attribute, original) to put back
    routes: object = None  # routes.RouteLog of a mixture of experts
    memory_peak_bytes: int = 0
    launch_counts: dict = field(default_factory=dict)

    @property
    def setup_s(self) -> float:
        return self.t0 - self.t_start

    def window(self) -> list[Served]:
        return [s for s in self.served if s.req.in_window]


def token_stamps(s: Served) -> list[float]:
    return [t for t, ev in s.gen.events.stamps if getattr(ev, "token", None) is not None]


def finished(s: Served) -> bool:
    return s.gen.done_reason == "length" and len(s.gen.tokens_out) == s.req.n_out


def make_sampler(cfg, body: dict):
    """What the server's ServerContext.make_sampler builds for a completion
    body (server/app.py), for a model of `cfg`."""
    from prima_tpu_torch.server.app import ServerContext

    return ServerContext.make_sampler(types.SimpleNamespace(model=types.SimpleNamespace(cfg=cfg)),
                                      body)


def build(cfg: dict, mix: dict, seed: int, device):
    """(engine, tokenizer) as `python -m prima_tpu_torch.server` builds them
    for a GGUF of this configuration with -np and -c from the mix, the
    other options at their defaults, and no end-of-generation ids (every
    request generates its drawn length, as with ignore_eos)."""
    from prima_tpu_torch.models.config import ModelConfig
    from prima_tpu_torch.models.llama import ForwardOptions, load_params
    from prima_tpu_torch.runtime.engine import Engine
    from prima_tpu_torch.tokenizer import Tokenizer

    from .synth import synth_gguf

    m = synth_gguf(cfg, seed, device)
    mcfg = ModelConfig.from_gguf(m)
    params = load_params(m, mcfg, device, dtype=torch.bfloat16)
    tok = Tokenizer.from_gguf(m)
    opts = ForwardOptions(matmul_impl="kernel", dtype=torch.bfloat16)
    engine = Engine(mcfg, params, n_slots=mix["n_slots"], max_seq=mix["ctx"], n_batch=256,
                    opts=opts, kv_dtype=torch.bfloat16, eog_ids=set(), ctx_shift=True,
                    n_keep=0, device=device)
    return engine, tok


def warm_up(engine, seed: int) -> None:
    """Run every shape the cell's traffic uses once: one prompt of a full
    256-row chunk and a 17-row chunk, the other slots short prompts (the
    GEMV route of a prefill), then step() and step_fused chunks at the
    cell's slot count, sampled and greedy rows together."""
    from prima_tpu_torch.runtime.engine import SlotState

    rng = np.random.default_rng(seed)
    v = engine.cfg.n_vocab
    for i in range(engine.n_slots):
        n = 256 + 17 + 1 if i == 0 else 4
        body = {"seed": i} if i % 2 == 0 else {"seed": i, "temperature": 0}
        engine.submit(rng.integers(0, v, n).tolist(), sampler=make_sampler(engine.cfg, body),
                      n_predict=12, request_id=f"warm-up {i}")
    while any(s.state != SlotState.IDLE for s in engine.slots):
        engine.step_fused(max_chunk=8)
    for s in engine.slots:
        s.prompt = []  # no request may reuse a warm-up prefix
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def install_tracing(run: Run, engine, worker) -> None:
    """The benchmark's spans and launch records (tracing on)."""
    from prima_tpu_torch.quant import qmatmul as qm

    rec = run.rec
    table = tensor_table(run.cfg["model"], run.cfg["types"])
    ranges = _weight_ranges(engine.params, {t.name: t.ggml_type for t in table})

    lows = [r[0] for r in ranges]
    memo: dict = {}

    def type_of(qt) -> int:
        p = qt.qs.data_ptr()
        t = memo.get(p)
        if t is None:
            i = bisect.bisect_right(lows, p) - 1
            if i < 0 or p >= ranges[i][1]:
                raise KeyError("a GEMV launch on a weight the configuration does not name")
            t = memo[p] = ranges[i][2]
        return t

    orig_gemv, orig_indexed = qm.qgemv, qm.qgemv_indexed

    def qgemv(x, qt, ksplit=None):
        rec.launch(Launch("qgemv", x.shape[0], qt.n_rows, qt.n_cols, type_of(qt)))
        return orig_gemv(x, qt, ksplit)

    def qgemv_indexed(x, qt, ids, n, ksplit=None, per_expert=None):
        rec.launch(Launch("qgemv_indexed", x.shape[0], n, qt.n_cols, type_of(qt), ids=ids,
                          n_exp=qt.n_rows // n))
        return orig_indexed(x, qt, ids, n, ksplit, per_expert)

    def patch(obj, name, new):
        run.restore.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    patch(qm, "qgemv", qgemv)
    patch(qm, "qgemv_indexed", qgemv_indexed)

    def chunk_info(a, kw, out, _):
        return {"rows": len(a[0]), "pos0": int(a[1])}

    def call_info(a, kw, out, start):
        counts: dict = {}
        for ev in out:
            if ev.token is not None:
                counts[ev.slot_id] = counts.get(ev.slot_id, 0) + 1
        after = engine.kv.cache_pos
        # each slot's k tokens were decoded at cells after - k ... after - 1
        visible = [int(after[sid]) - k + j + 1 for sid, k in counts.items() for j in range(k)]
        return {"steps": max(counts.values(), default=0), "visible": visible,
                # a step() that prefills syncs and books that part as prompt time
                "prompt_s": engine.perf["t_prompt_s"] - start["p0"]}

    patch(engine, "_prefill", rec.span("prefill", engine._prefill, chunk_info, work=True))
    patch(engine, "_decode_raw", rec.span("decode issue", engine._decode_raw))
    fused = engine._fused_gen
    patch(fused, "fwd", rec.span("decode issue", fused.fwd))
    patch(fused, "generate", rec.span("read-back", fused.generate))
    patch(engine, "step", rec.span("step", engine.step))
    patch(engine, "step_fused", rec.span("decode call", engine.step_fused, call_info, work=True,
                                         before=lambda: {"p0": engine.perf["t_prompt_s"]}))
    sub = engine.submit

    def submit(*a, **kw):
        run.admitted[kw.get("request_id")] = time.perf_counter()
        return sub(*a, **kw)

    patch(engine, "submit", submit)
    patch(worker, "_admit", rec.span("admit", worker._admit))
    patch(worker, "_emit", rec.span("emit", worker._emit))


def _weight_ranges(params: dict, types_by_name: dict) -> list:
    """(first byte, end, ggml type) of every quantized weight's codes."""
    from prima_tpu_torch.quant.qtensor import QTensor

    # the program's own keys of a layer's weights; a layer's other keys are
    # the GGUF names themselves (ffn_gate_exps, ffn_up_shexp, ...)
    keys = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
            "w_gate": "ffn_gate", "w_up": "ffn_up", "w_down": "ffn_down"}
    named = [("token_embd.weight", params.get("tok_embd")), ("output.weight", params.get("output"))]
    for i, layer in enumerate(params["layers"]):
        named += [(f"blk.{i}.{keys.get(k, k)}.weight", v) for k, v in layer.items()]
    out = []
    for name, qt in named:
        if isinstance(qt, QTensor) and name in types_by_name:
            lo = qt.qs.data_ptr()
            out.append((lo, lo + qt.qs.numel() * qt.qs.element_size(), types_by_name[name]))
    return sorted(out)


class Profiling(threading.Thread):
    """torch.profiler over the last seconds of the window. This thread
    brings the profiler up once in set-up, starts it at the sub-window's
    start and marks its end at the window's end, each while the worker is
    parked between two steps (a control task of EngineWorker.run), so the
    trace holds exactly the kernels of the launches recorded meanwhile. It
    stops the profiler, which holds the interpreter for seconds, only once
    the drain is over (`drained`), and keeps the events of the sub-window."""

    def __init__(self, run: Run, worker, device):
        super().__init__(daemon=True)
        self.run_, self.worker, self.device = run, worker, device
        self.ready = threading.Event()
        self.ended = threading.Event()  # the sub-window's end is marked
        self.drained = threading.Event()
        self.at: float | None = None  # when to start, set before the window
        self.length = run.mix["profile_s"]
        self.error: BaseException | None = None

    def run(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        try:
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.zeros(1, device=self.device).add_(1)
                torch.cuda.synchronize(self.device)
            self.ready.set()
            while self.at is None:
                time.sleep(0.01)
            time.sleep(max(0.0, self.at - time.perf_counter()))
            prof = profile(activities=[ProfilerActivity.CUDA])
            t_mark = self._parked(lambda: self._start_profile(prof))
            time.sleep(max(0.0, self.at + self.length - time.perf_counter()))
            t_stop = self._parked(self._end_profile)
            self.ended.set()
            self.drained.wait()
            prof.stop()
            self.run_.rec.profile = _device_events(prof, t_mark, t_stop)
        except BaseException as e:  # noqa: BLE001 - reported by serve()
            self.error = e
            self.ready.set()
            self.ended.set()

    def _parked(self, fn):
        """fn() while the worker waits in a control task."""
        parked, go = threading.Event(), threading.Event()

        def park():
            parked.set()
            go.wait(120)

        t = threading.Thread(target=self.worker.run, args=(park, 300.0), daemon=True)
        t.start()
        if not parked.wait(300):
            raise RuntimeError("the worker never reached a control point")
        try:
            return fn()
        finally:
            go.set()
            t.join(60)

    def _start_profile(self, prof) -> float:
        torch.cuda.synchronize(self.device)
        prof.start()
        mark = torch.empty(1, device=self.device)
        torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        mark.fill_(0)  # the trace's first device event: its clock against the host's
        torch.cuda.synchronize(self.device)
        self.run_.rec.profiling = True
        return t

    def _end_profile(self) -> float:
        torch.cuda.synchronize(self.device)
        self.run_.rec.profiling = False
        return time.perf_counter()


def _device_events(prof, t_mark: float, t_stop: float) -> Profile:
    """The trace's device operations in host seconds, the marker dropped."""
    from torch.autograd import DeviceType

    raw = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            raw.append((e.name(), s, s + e.duration_ns()))
    if not raw:
        raise RuntimeError("the profiler saw no device activity")
    raw.sort(key=lambda r: r[1])
    base = raw[0][1]
    events = [(n, t_mark + (s - base) / 1e9, t_mark + (e - base) / 1e9) for n, s, e in raw[1:]]
    return Profile(t_mark, t_stop, [e for e in events if e[1] < t_stop])


def serve(run: Run, engine, tok, seed: int, trace: bool, device, profile: bool = True) -> None:
    """Drive the window: submit every request at its due time, stop issuing
    at the window's end, drain the window's requests up to the mix's cap.
    With `trace`, record spans and launches, and profile a sub-window
    unless `profile` is off."""
    from prima_tpu_torch.quant import qmatmul as qm
    from prima_tpu_torch.server.scheduler import EngineWorker, GenerationRequest

    mix = run.mix
    reqs = schedule(mix, seed, run.seconds, engine.cfg.n_vocab)
    worker = EngineWorker(engine, tok)
    if trace:
        run.rec = Recorder()
        install_tracing(run, engine, worker)
    for r in reqs:
        body = {"seed": r.seed}
        if r.greedy:
            body["temperature"] = 0
        gen = GenerationRequest(prompt_tokens=r.prompt, sampler=make_sampler(engine.cfg, body),
                                n_predict=r.n_out, events=TimedQueue())
        run.served.append(Served(r, gen, 0.0))
    if engine.cfg.n_expert:
        from .routes import RouteLog

        run.routes = RouteLog(engine)
    counts0 = (qm.launches.count, qm.indexed_launches.count)
    prof = None
    if trace and profile and device.type == "cuda":
        prof = Profiling(run, worker, device)
        prof.start()
        prof.ready.wait(300)
    worker.start()
    run.t0 = time.perf_counter()
    run.w0 = run.t0 + mix["lead_in_s"]
    run.w1 = run.w0 + run.seconds
    if prof is not None:
        prof.at = run.w1 - min(mix["profile_s"], run.seconds)
    todo = sorted([(run.t0 + s.req.due, "req", s) for s in run.served]
                  + [(run.w0, "w0", None), (run.w1, "w1", None)], key=lambda x: x[0])
    try:
        for t, what, s in todo:
            now = time.perf_counter()
            if t > now:
                time.sleep(t - now)
            if what == "req":
                s.due = t
                s.t_submit = time.perf_counter()
                worker.submit(s.gen)
            elif what == "w0":
                run.perf0 = dict(engine.perf)
            else:
                run.perf1 = dict(engine.perf)
        deadline = run.w1 + mix["drain_cap_s"]
        window = run.window()
        while time.perf_counter() < deadline and not all(
                s.gen.done_reason is not None for s in window):
            time.sleep(0.01)
        run.t_end = time.perf_counter()
        if prof is not None:
            prof.ended.wait(300)  # the worker runs until the sub-window's end is marked
    finally:
        worker.shutdown()
        if prof is not None:
            prof.drained.set()
            prof.join(timeout=600)
        if worker.thread.is_alive():
            raise RuntimeError("the worker thread did not stop")
        if run.routes is not None:
            run.routes.restore()
        for obj, name, orig in reversed(run.restore):
            setattr(obj, name, orig)  # the engine as it was, for the next run on it
        run.restore.clear()
    if prof is not None and (prof.error is not None or prof.is_alive()):
        raise RuntimeError(f"the profiled sub-window failed: {prof.error!r}")
    run.launch_counts = {"qgemv": qm.launches.count - counts0[0],
                         "qgemv_indexed": qm.indexed_launches.count - counts0[1]}
    if trace:
        _count_distinct(run.rec.launches, device)
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)


def _count_distinct(launches: list, device) -> None:
    """Each indexed launch's distinct experts, from its ids, in one pass."""
    idx = [l for l in launches if l.kind == "qgemv_indexed"]
    if not idx:
        return
    n_exp = max(l.n_exp for l in idx)
    ids = torch.cat([l.ids.reshape(-1).long() for l in idx])
    seg = torch.repeat_interleave(torch.arange(len(idx), device=ids.device),
                                  torch.tensor([l.ids.numel() for l in idx],
                                               device=ids.device))
    hit = torch.zeros(len(idx), n_exp, dtype=torch.bool, device=ids.device)
    hit[seg, ids] = True
    for l, d in zip(idx, hit.sum(1).tolist()):
        l.distinct = int(d)
        l.ids = None


def free(engine) -> None:
    """Drop the program's state so the reference starts from an empty card."""
    engine.params = None
    engine.kv = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
