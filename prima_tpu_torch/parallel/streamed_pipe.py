"""Weight streaming composed with the piped-ring pipeline.

Counterpart of prima_tpu/parallel/streamed_pipe.py (the reference's
manage_graph_tensors inside the k-cycle decode loop,
src/llama.cpp:18152-18218 + 18567-18575): each rank keeps only n_resident
layers of each of its windows on its card, the LAST n_resident of the
window as the reference's GPU split keeps them
(src/llama.cpp:7597-7605), and uploads the first W - n_resident of its
next window from pinned host memory on a side stream while the ring
computes the current one. A rank revisited k times a token so holds

  k * n_resident + 2 * (W - n_resident)

layers on its card instead of k * W: the resident ones, the current
window's streamed ones and the next window's, in flight. The JAX package
swaps the streamed rows of its sharded arrays between jitted steps of one
host-driven schedule; here the rank's own schedule (pipeline.PipeForward)
asks the streamer (ring_tcp._WindowStreamer, the TCP ring's) for window c
before it runs it, which commits c, releases the previous window's
streamed layers and starts the upload of the next. The numbers are those
of the resident pipe: the same kernels on the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import ForwardOptions
from ..runtime.streaming import pack_host_layer
from .mesh import Mesh
from .pipe_kv import PipeKV
from .pipeline import PipeForward, PipeSpec, build_pipe_model
from .ring_tcp import _WindowStreamer


@dataclass
class StreamedPipeModel:
    cfg: ModelConfig
    spec: PipeSpec
    mesh: Mesh
    n_resident: int  # device-resident layers a window (the solver's n[m])
    params: dict  # the rank's params; streamed layers None until committed
    streamed_host: dict  # layer id -> packed host layer (pinned on CUDA)
    streamer: _WindowStreamer


def build_streamed_pipe_model(get_layer: Callable[[int], dict], head: dict,
                              cfg: ModelConfig, spec: PipeSpec, mesh: Mesh,
                              n_resident: int) -> StreamedPipeModel:
    """The rank's params with the first W - n_resident layers of each of
    its windows in host memory (pinned for a CUDA device)."""
    W = spec.window
    if not 0 <= n_resident <= W:
        raise ValueError(f"n_resident {n_resident} not in [0, {W}]")
    d = mesh.coords["pp"]
    streamed = {li for c in range(spec.k_cycles)
                for li in list(spec.window_layers(d, c))[:W - n_resident]}
    params = build_pipe_model(get_layer, head, cfg, spec, mesh, streamed=streamed)
    pin = mesh.device.type == "cuda"
    host = {li: pack_host_layer(layer, pin)
            for li, layer in params.pop("streamed_host", {}).items()}
    ranges = [(spec.window_layers(d, c)[0], spec.window_layers(d, c)[-1] + 1)
              for c in range(spec.k_cycles)]
    streamer = _WindowStreamer(params, ranges, host, mesh.device)
    return StreamedPipeModel(cfg, spec, mesh, n_resident, params, host, streamer)


class StreamedPipeRunner:
    """The streamed pipe as a forward of its own: every rank calls
    forward with the same arrays (the JAX runner's interface), rank 0 gets
    the logits."""

    def __init__(self, model: StreamedPipeModel, batch_per_micro: int, max_seq: int,
                 opts: ForwardOptions | None = None, kv_dtype=torch.float32):
        self.m = model
        self.kv = PipeKV(model.cfg, model.spec, model.mesh, batch_per_micro, max_seq,
                         kv_dtype)
        self.fwd = PipeForward(model.cfg, model.spec, model.mesh, opts,
                               streamer=model.streamer)

    def forward(self, tokens: np.ndarray, positions: np.ndarray,
                cache_pos: np.ndarray) -> torch.Tensor | None:
        """tokens / positions (M, B, S), cache_pos (M, B); logits
        (M, B, S, V) on rank 0, None elsewhere. The caches are written in
        place."""
        out, _ = self.fwd(self.m.params, tokens, positions, cache_pos, self.kv.caches)
        return out
