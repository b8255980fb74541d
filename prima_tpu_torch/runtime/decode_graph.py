"""The decode step as CUDA graphs between its eager GEMV calls.

At one token a row, `llama.forward` issues about a hundred small ops a
layer around its GEMV calls, and on an H100 the host takes longer to
launch them than the device takes to run them. `DecodeGraph` captures each
run of small ops between two boundary calls once, as a CUDA graph (a
segment), and from then on runs a decode step as segment 0, boundary 0,
segment 1, ... on the current stream. The boundaries run eagerly on every
step, as they do without a graph:

- each GEMV: `qmatmul.qgemv(x, qt)`, looked up on its module at each call,
  so a wrapper set there sees every call. Its output is copied into the
  next segment's fixed input; the copy takes the place of `qmatmul`'s cast
  to the activation dtype. GEMVs on one input (wq / wk / wv, w_gate /
  w_up) have no segment between them;
- the whole of `llama.moe_ffn`, looked up on its module at each call, so
  its router's top-k gives fresh expert ids on each step.

A plan's first step runs the forward eagerly on a side stream, for the
step's result and for whatever an op does on its first use in a thread or
on a stream. Then the forward is captured on that stream, with the
boundaries cut out (it launches no GEMV and no expert), every segment into
one memory pool, and later steps replay the plan. Segments read fixed
buffers and replay in the order they were captured. The forward's spans
(`fwd.embed`, `fwd.attn` and `fwd.ffn` / `fwd.moe` of each layer,
`fwd.head`) are cut points of the capture and are opened again around
their segments and boundaries on every replay.

A graph applies where the call shows it can (`call_blocker`,
`params_blocker`): a CUDA device, one token a row over every slot, all
layers, none of forward's window, mask, tap or embedding inputs, no tp /
sp group, and no layer with LoRA adapters or a control vector (their
Python scalars would be baked into a segment).
A plan is keyed on the inputs' shapes, the options, the identity of the
params and of every value in them, and the storage of the caches; a change
captures anew. Anything else runs `llama.forward` eagerly, and so does a
key whose capture met an op that cannot be captured (`uncapturable`); any
other error of a capture is raised. The recorder's counters
(utils/perf.py) `decode.graph_steps`, `decode.eager_steps` and
`decode.graph_captures` say how often each happens.

A segment holds launches of the port's own kernels (`kv_store`,
`flash_decode`): what their `LaunchCounter`s rose by while it was captured
is taken back (the capture ran nothing) and added on each replay, so the
counts are those of the eager path.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import threading
import warnings

import torch

from ..models import llama
from ..quant import qmatmul as qm
from ..utils import perf
from ..utils.log import warn
from ..utils.nvcc import LaunchCounter

# forward's inputs that rule a graph out when given
_FORWARD_INPUTS = ("layer_range", "hidden_in", "attn_mask", "taps", "inputs_embeds")
# one capture at a time: llama._capture is the process's
_lock = threading.Lock()
# what the CUDA runtime or PyTorch says of an op that a capture cannot hold:
# a sync (cudaErrorStreamCaptureUnsupported, 900, as from `.item()`), a
# capture an earlier such op invalidated (901), a use of the legacy stream
# (906), a copy from pageable host memory
_UNCAPTURABLE = re.compile(
    r"operation not permitted when stream is capturing"
    r"|operation failed due to a previous error during capture"
    r"|legacy stream depend on a capturing blocking stream"
    r"|during CUDA graph capture"
    r"|CUDA error (900|901|906)\b")  # the port's kernels (nvcc.check)


def uncapturable(e: RuntimeError) -> bool:
    """Whether a capture's error means that an op of the forward cannot
    be captured, and nothing else went wrong."""
    msg = str(e)
    return "INTERNAL ASSERT" not in msg and _UNCAPTURABLE.search(msg) is not None


def call_blocker(tokens: torch.Tensor, opts, n_slots: int, kw: dict,
                 device_type: str = "cuda") -> str | None:
    """What in a decode call's inputs rules a graph out, or None."""
    if tokens.device.type != device_type:
        return "device"
    if tuple(tokens.shape) != (n_slots, 1):
        return "not one token on every slot"
    if opts.tp_group is not None or opts.sp_group is not None:
        return "tp or sp group"
    if kw.get("return_hidden") or any(kw.get(k) is not None for k in _FORWARD_INPUTS):
        return "forward inputs"
    return None


def params_blocker(params: dict) -> str | None:
    """What in the params rules a graph out, or None."""
    for layer in params["layers"]:
        if layer is None:
            return "a layer is not loaded"
        if layer.get("cvec") is not None or any(
                k.endswith("_lora") and v for k, v in layer.items()):
            return "LoRA adapters or a control vector"
    return None


def _storage(caches: list) -> tuple:
    """The device addresses of every cache tensor (codes and scales of a
    quantized cache)."""
    out = []
    for kv in caches:
        for c in kv:
            if hasattr(c, "qs"):
                out += (c.qs.data_ptr(), c.scale.data_ptr())
            else:
                out.append(c.data_ptr())
    return tuple(out)


def _key(params: dict, cfg, opts, inputs: tuple, caches: list) -> tuple:
    ids = [id(v) for v in params.values()]
    for layer in params["layers"]:
        ids.extend(map(id, layer.values()))
    shapes = tuple(None if t is None else (t.shape, t.dtype, t.device) for t in inputs)
    return (id(cfg), opts, shapes, tuple(ids), _storage(caches))


class CudaGraphs:
    """CUDA graphs for one plan: a side stream to capture on and one memory
    pool for all of its segments."""

    device_type = "cuda"

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def new(self):
        return torch.cuda.CUDAGraph()

    def begin(self, g) -> None:
        # the engine's worker is a thread of its own: only its calls are held
        # to the capture's rules
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self, g) -> None:
        with warnings.catch_warnings():
            # the forward's last segment may hold nothing
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            g.capture_end()

    def nodes(self) -> int:
        """The nodes captured so far on the stream (libcuda's count)."""
        return _capture_nodes(self.stream.cuda_stream)

    @contextlib.contextmanager
    def side_stream(self):
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            yield
        main.wait_stream(self.stream)


_libcuda = None  # (cuStreamGetCaptureInfo_v2, cuGraphGetNodes), loaded on first use


def _capture_nodes(stream: int) -> int:
    """The nodes of the graph being captured on `stream`, from libcuda
    (PyTorch has no call for it)."""
    global _libcuda
    if _libcuda is None:
        lib = ctypes.CDLL("libcuda.so.1")
        info, nodes = lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes
        p = ctypes.POINTER
        info.argtypes = [ctypes.c_void_p, p(ctypes.c_int), p(ctypes.c_uint64),
                         p(ctypes.c_void_p), p(ctypes.c_void_p), p(ctypes.c_size_t)]
        nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, p(ctypes.c_size_t)]
        info.restype = nodes.restype = ctypes.c_int
        _libcuda = (info, nodes)
    info, nodes = _libcuda
    status, graph, n = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_size_t()
    rc = info(stream, ctypes.byref(status), ctypes.byref(ctypes.c_uint64()),
              ctypes.byref(graph), ctypes.byref(ctypes.c_void_p()),
              ctypes.byref(ctypes.c_size_t()))
    if rc != 0 or status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError(f"cuStreamGetCaptureInfo: error {rc}, status {status.value}")
    rc = nodes(graph, None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes: error {rc}")
    return n.value


class _Gemv:
    """A GEMV boundary: its f32 rows in, its output into the next
    segment's input."""

    __slots__ = ("x", "qt", "out")

    def __init__(self, x, qt, out):
        self.x, self.qt, self.out = x, qt, out

    def __call__(self) -> None:
        self.out.copy_(qm.qgemv(self.x, self.qt).view(self.out.shape))


class _Experts:
    """The experts' boundary: moe_ffn on the segment's output."""

    __slots__ = ("layer", "cfg", "x", "opts", "out")

    def __init__(self, layer, cfg, x, opts, out):
        self.layer, self.cfg, self.x, self.opts, self.out = layer, cfg, x, opts, out

    def __call__(self) -> None:
        self.out.copy_(llama.moe_ffn(self.layer, self.cfg, self.x, self.opts))


class _Segment:
    """A captured segment: its graph's replay, then the launches of the
    port's kernels it holds added to their counters."""

    __slots__ = ("graph", "launches")

    def __init__(self, graph, launches: list):
        self.graph, self.launches = graph, launches

    def __call__(self) -> None:
        self.graph.replay()
        for counter, n in self.launches:
            counter.count += n


class _Span:
    """A span of the forward around the steps captured inside it."""

    __slots__ = ("name", "attrs", "steps")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.steps = name, attrs, []

    def __call__(self) -> None:
        with perf.span(self.name) as sp:
            if sp:
                sp.set(**self.attrs)
            for step in self.steps:
                step()


class _Capture:
    """One plan's capture. Every op of the forward goes into the segment
    being captured; a boundary or a span's end closes it and opens the
    next, unless nothing was captured since it opened: then it goes on, so
    no segment is empty."""

    def __init__(self, graphs):
        self.graphs = graphs
        self.thread = threading.get_ident()
        self.steps: list = []  # the plan's steps, top level
        self.open = [self.steps]  # the step list of each open span
        self.graph = None  # the segment being captured
        self.every: list = []  # each graph captured
        self.last = None  # (x, its version, its f32 rows) of the last GEMV
        self.counts: list = []  # (counter, its count) when the segment opened

    def begin(self) -> None:
        self.counts = [(c, c.count) for c in LaunchCounter.every]
        self.graph = self.graphs.new()
        self.graphs.begin(self.graph)

    def launched(self) -> list:
        """(counter, rise) of each counter that rose since the segment
        opened; the rise is taken back, since the capture launched nothing."""
        out = [(c, c.count - n) for c, n in self.counts if c.count != n]
        for c, n in self.counts:
            c.count = n
        return out

    def cut(self) -> None:
        if self.graphs.nodes():
            self.finish()
            self.begin()

    def finish(self) -> None:
        """Close the segment; it is replayed if it holds anything."""
        work = self.graphs.nodes()
        g, self.graph = self.graph, None
        self.graphs.end(g)
        # every graph lives as long as the plan: freeing one would release
        # its use of the pool the later captures share
        self.every.append(g)
        launched = self.launched()
        if work:
            self.open[-1].append(_Segment(g, launched))

    def abort(self) -> None:
        g, self.graph = self.graph, None
        if g is not None:
            self.launched()
            with contextlib.suppress(RuntimeError):
                self.graphs.end(g)

    def gemv(self, x: torch.Tensor, qt) -> torch.Tensor:
        """llama.linear over a quantized weight."""
        rows = x.numel() // x.shape[-1]
        if rows >= qm.MAX_B:
            return qm.qmatmul(x, qt)  # dequant and one matmul: a segment's work
        last = self.last
        if last is not None and last[0] is x and last[1] == x._version:
            xin = last[2]
        else:
            xin = x.reshape(rows, x.shape[-1]).float().contiguous()
            self.last = (x, x._version, xin)
        self.cut()
        out = torch.empty((*x.shape[:-1], qt.n_rows), dtype=x.dtype, device=x.device)
        self.open[-1].append(_Gemv(xin, qt, out))
        return out

    def experts(self, layer: dict, cfg, x: torch.Tensor, opts) -> torch.Tensor:
        """llama._experts: moe_ffn's output has x's shape and dtype."""
        self.cut()
        out = torch.empty_like(x)
        self.open[-1].append(_Experts(layer, cfg, x, opts, out))
        return out

    def span(self, name: str) -> "_SpanCut":
        return _SpanCut(self, _Span(name, {}))


class _SpanCut:
    """A forward's span during a capture (llama._span): cuts the segment
    at both ends and collects the steps inside."""

    def __init__(self, cap: _Capture, step: _Span):
        self.cap, self.step = cap, step

    def __enter__(self) -> "_SpanCut":
        self.cap.cut()
        self.cap.open[-1].append(self.step)
        self.cap.open.append(self.step.steps)
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if exc_type is None:
            self.cap.cut()
        self.cap.open.pop()
        return False

    def set(self, **attrs) -> None:
        self.step.attrs.update(attrs)

    def __bool__(self) -> bool:
        return True


class _Plan:
    """A captured decode step: its fixed inputs, its steps, its logits."""

    def __init__(self, key: tuple, steps: list, inputs: list, logits: torch.Tensor,
                 held: tuple):
        self.key, self.steps, self.inputs, self.logits = key, steps, inputs, logits
        self.held = held  # what the key names by identity, kept alive with it

    def replay(self, inputs: tuple) -> torch.Tensor:
        for buf, t in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(t)
        for step in self.steps:
            step()
        return self.logits


class DecodeGraph:
    """`llama.forward` for the decode steps of an engine with `n_slots`
    rows: a replayed plan where one applies, else the eager forward.
    `graphs` makes a plan's capture stream and pool (`CudaGraphs`; a test
    may hand in a fake with the same methods)."""

    def __init__(self, n_slots: int, graphs=CudaGraphs):
        self.n_slots = n_slots
        self.graphs = graphs
        self.plan: _Plan | None = None
        self.refused = None  # the key for which the params or the capture ruled a graph out

    def __call__(self, params: dict, cfg, tokens: torch.Tensor, positions: torch.Tensor,
                 kv_caches: list, cache_pos: torch.Tensor, opts, **kw):
        """forward(params, cfg, tokens, positions, kv_caches, cache_pos,
        opts, **kw) -> (logits, kv_caches). A replay returns the plan's own
        logits tensor, which the next replay overwrites."""
        if call_blocker(tokens, opts, self.n_slots, kw, self.graphs.device_type) is None:
            inputs = (tokens, positions, cache_pos, kw.get("mask_positions"))
            key = _key(params, cfg, opts, inputs, kv_caches)
            plan = self.plan
            if plan is not None and plan.key == key:
                perf.count("decode.graph_steps")
                return plan.replay(inputs), kv_caches
            self.plan = None  # the old plan's memory goes back to its stream
            if key != self.refused and params_blocker(params) is None:
                return self._capture(key, params, cfg, opts, inputs, kv_caches, kw), kv_caches
            self.refused = key
        perf.count("decode.eager_steps")
        return llama.forward(params, cfg, tokens, positions, kv_caches, cache_pos, opts, **kw)

    def _capture(self, key: tuple, params: dict, cfg, opts, inputs: tuple, caches: list,
                 kw: dict) -> torch.Tensor:
        """This step's logits, from the eager forward on the capture's
        stream; then the plan of the steps after it, captured."""
        perf.count("decode.eager_steps")
        graphs = self.graphs(inputs[0].device)
        statics = [None if t is None else t.clone() for t in inputs]
        cap = _Capture(graphs)
        with _lock, graphs.side_stream():
            # the step itself, before the capture and on its stream: what an
            # op does on its first use in a thread or on a stream (cuBLAS's
            # handle and workspace, a kernel library's load, rope_freqs'
            # build) cannot be captured, and happens here
            step, _ = llama.forward(params, cfg, inputs[0], inputs[1], caches, inputs[2], opts,
                                    **kw)
            try:
                llama._capture = cap
                try:
                    cap.begin()
                    logits, _ = llama.forward(params, cfg, statics[0], statics[1], caches,
                                              statics[2], opts, mask_positions=statics[3])
                    cap.finish()
                except BaseException:
                    cap.abort()
                    raise
                finally:
                    llama._capture = None
            except RuntimeError as e:
                if not uncapturable(e):
                    raise
                warn("decode graph: an op cannot be captured, decoding eagerly: %s", e)
                self.refused = key
                return step
        held = (cap.every, params, cfg, list(params.values()),
                [list(layer.values()) for layer in params["layers"]],
                [tuple(kv) for kv in caches])
        self.plan = _Plan(key, cap.steps, statics, logits, held)
        perf.count("decode.graph_captures")
        return step
