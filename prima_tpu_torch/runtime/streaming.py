"""Weight streaming: run models larger than device memory.

Counterpart of prima_tpu/runtime/streaming.py (prima.cpp's mmap + madvise
prefetch and release, manage_graph_tensors src/llama.cpp:18152). Layer
weights are held once in host memory in the device format the kernels read
(QTensors and dense tensors, `pack_host_layer`), pinned when they go to a
CUDA device. A layer's tensors are allocated on the compute stream, so a
released layer's memory is reused in stream order and the device never
holds more than what is in flight; the copy into them runs on a side
stream, non-blocking, after the compute stream's work so far and while the
compute stream runs the layer before it; the compute stream waits on the
copy's event before it reads the layer (`Uploads`).

The scheduler decides how many layers of a window stay resident (n[m])
and how many stream (w[m] - n[m]) — see sched/milp.py; `StreamedRunner`
executes that decision on one device, and the ring's `_WindowStreamer`
(parallel/ring_tcp.py) window by window.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import ForwardOptions, forward, init_kv_caches, lm_head
from ..quant.qtensor import QTensor, dequant_slices

# A device that streams layers holds little beyond them, so the dense
# dequant of a wide (>= 32 row) matmul goes by slices of this many weights
# (~32 MB of f32 a temporary; one pass of an 8B-shape FFN weight holds ~1 GB).
STREAM_DEQUANT_WEIGHTS = 1 << 23


def map_layer(tree, fn):
    """`tree` (a layer or head dict: tensors, QTensors, lists, None) with
    fn applied to every tensor."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, **{
            f: map_layer(getattr(tree, f), fn) for f in ("qs", "scales", "mins", "d", "dmin")})
    if isinstance(tree, dict):
        return {k: map_layer(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_layer(v, fn) for v in tree)
    return tree


def tensors_of(tree) -> list:
    """Every tensor in `tree`, in map_layer's order."""
    out = []
    map_layer(tree, lambda t: out.append(t) or t)
    return out


def layer_nbytes(tree) -> int:
    """The bytes of every tensor in `tree`."""
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


def pack_host_layer(layer: dict, pin: bool) -> dict:
    """A layer (tensors and QTensors in the device format, e.g. from
    `llama.gguf_host_layer`) as one host copy, page-locked when `pin` so
    that copies to the card run asynchronously at the link's rate."""
    return map_layer(layer, lambda t: (t.cpu().pin_memory() if pin
                                       else t.to("cpu", copy=True).contiguous()))


def _to_device(packed: dict, device) -> dict:
    """A fresh device copy of a packed host layer, on the current stream."""
    return map_layer(packed, lambda t: t.to(device, copy=True))


class Uploads:
    """Host-to-device layer uploads of `device` (on the CPU, plain copies).

    `start` allocates the layer's tensors on the current (compute) stream,
    where they reuse memory the compute stream freed, in stream order, and
    copies into them on a side stream that first waits for the compute
    stream's work so far (which may still read that memory); `ready` makes
    the compute stream wait for the copy and returns the layer. Every
    started upload must go through `ready` before it is dropped, so that
    its memory is not handed out while the copy runs. `bytes` counts what
    went up."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                       else None)
        self.bytes = 0

    def start(self, packed: dict) -> tuple:
        self.bytes += layer_nbytes(packed)
        if self.stream is None:
            return _to_device(packed, self.device), None
        layer = map_layer(packed, lambda t: torch.empty_like(t, device=self.device))
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for src, dst in zip(tensors_of(packed), tensors_of(layer)):
                dst.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record(self.stream)
        return layer, event

    def ready(self, pending: tuple) -> dict:
        layer, event = pending
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        return layer


@dataclass
class StreamedModel:
    cfg: ModelConfig
    head: dict  # tok_embd / output_norm / output: always resident
    resident: list  # the first n_resident layers, on the device
    streamed_host: list  # packed host layers for ids >= n_resident
    n_resident: int
    device: torch.device


def build_streamed_model(get_layer, head: dict, cfg: ModelConfig, n_resident: int,
                         device, pin: bool | None = None) -> StreamedModel:
    """get_layer(i) -> layer i in host memory (`llama.gguf_host_layer`).
    The first n_resident layers go to `device` now; the rest stay in host
    memory, pinned unless `pin` is False (it defaults to True for a CUDA
    device)."""
    device = torch.device(device)
    pin = device.type == "cuda" if pin is None else pin
    resident, streamed = [], []
    for i in range(cfg.n_layers):
        packed = pack_host_layer(get_layer(i), pin)
        if i < n_resident:
            resident.append(_to_device(packed, device))
        else:
            streamed.append(packed)
    head = map_layer(head, lambda t: t.to(device))
    return StreamedModel(cfg, head, resident, streamed, n_resident, device)


class StreamedRunner:
    """Decode on one device with double-buffered layer streaming: while
    streamed layer j computes, layer j + 1 goes up; layer j's memory is
    released once its compute is enqueued."""

    def __init__(self, model: StreamedModel, batch: int, max_seq: int,
                 opts: ForwardOptions | None = None, kv_dtype=torch.bfloat16):
        self.m = model
        self.opts = opts or ForwardOptions()
        self.kv = init_kv_caches(model.cfg, batch, max_seq, kv_dtype, model.device)
        self.cache_pos = np.zeros(batch, np.int32)
        self.uploads = Uploads(model.device)
        # the forward's params view: the head, and the layers in flight
        self._params = dict(model.head, layers=list(model.resident)
                            + [None] * len(model.streamed_host))

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.m.device)

    @torch.no_grad()
    def forward(self, tokens: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """tokens / positions (B, S). Returns logits (B, S, V) in f32 on the
        host; writes the caches."""
        m, p = self.m, self._params
        L, nr = m.cfg.n_layers, m.n_resident
        tok, pos = self._tensor(tokens, torch.int64), self._tensor(positions)
        cache_pos = self._tensor(self.cache_pos)
        run = lambda x, lo, hi: forward(p, m.cfg, tok, pos, self.kv, cache_pos, self.opts,
                                        return_hidden=True, layer_range=(lo, hi),
                                        hidden_in=x)[0]
        with dequant_slices(STREAM_DEQUANT_WEIGHTS):
            x = run(None, 0, nr) if nr else None
            pending = self.uploads.start(m.streamed_host[0]) if nr < L else None
            for i in range(nr, L):
                p["layers"][i] = self.uploads.ready(pending)
                if i + 1 < L:  # the next layer goes up while this one computes
                    pending = self.uploads.start(m.streamed_host[i + 1 - nr])
                x = run(x, i, i + 1)
                p["layers"][i] = None  # released once its compute has run
        logits = lm_head(p, m.cfg, x, self.opts)
        self.cache_pos += tokens.shape[1]
        return logits.float().cpu().numpy()

    def greedy_generate(self, prompt: list[int], n_new: int) -> list[int]:
        if self.cache_pos.shape[0] != 1:
            raise ValueError("greedy_generate runs one sequence (batch 1)")
        out = []
        if len(prompt) > 1:
            pos = np.arange(len(prompt) - 1, dtype=np.int32)[None]
            self.forward(np.asarray([prompt[:-1]], np.int64), pos)
        cur = prompt[-1]
        for _ in range(n_new):
            p = int(self.cache_pos[0])
            logits = self.forward(np.asarray([[cur]], np.int64), np.asarray([[p]], np.int32))
            cur = int(np.argmax(logits[0, -1]))
            out.append(cur)
        return out
