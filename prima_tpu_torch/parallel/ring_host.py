"""Host-orchestrated ring executor: heterogeneous layer windows in one
process.

Counterpart of prima_tpu/parallel/ring_host.py. Each device of a list
(`["cuda:0", "cuda:1"]`, or `["cpu", "cpu"]` in tests) holds only its own
windows' layers and KV caches; one traversal runs the k ring cycles, each
window on its device, and hands the activation device to device (the ring
hop) — the reference's recv -> compute -> send loop
(llama_decode_internal). CUDA work is enqueued without a host barrier, so
the hops chain as the data dependencies allow, until the logits are read.

RingPlan is the scheduler's w[m] with k cycles (sched/milp.py); the TCP
ring (parallel/ring_tcp.py) shares it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import ForwardOptions, forward, init_kv_caches, lm_head
from ..runtime.streaming import map_layer


@dataclass
class RingPlan:
    """Per-device layer windows (the scheduler's w[m] with k cycles)."""

    windows: list[int]  # w[m] per device
    k: int

    @property
    def n_devices(self) -> int:
        return len(self.windows)

    @property
    def W(self) -> int:
        return sum(self.windows)

    @property
    def n_layers(self) -> int:
        return self.W * self.k

    def layer_ranges(self) -> list[list[tuple[int, int]]]:
        """[device][cycle] -> (lo, hi): ring-cyclic ownership, matching
        this_layer_is_mine (src/llama.cpp:3838)."""
        out = [[None] * self.k for _ in range(self.n_devices)]
        lo = 0
        for c in range(self.k):
            for d in range(self.n_devices):
                out[d][c] = (lo, lo + self.windows[d])
                lo += self.windows[d]
        return out

    def owned(self, d: int) -> set[int]:
        """The layers device d holds over its k windows."""
        return {i for lo, hi in self.layer_ranges()[d] for i in range(lo, hi)}


def to_device(tree, device):
    """A layer or head dict with every tensor on `device`."""
    return map_layer(tree, lambda t: t.to(device))


class HostRingExecutor:
    def __init__(self, cfg: ModelConfig, plan: RingPlan, get_layer, head: dict,
                 devices, batch: int = 1, max_seq: int = 256,
                 opts: ForwardOptions | None = None, kv_dtype=torch.bfloat16):
        """get_layer(i) -> layer i's params (any device); head -> the
        embedding, output norm and output head, kept on the first device."""
        if plan.n_layers != cfg.n_layers:
            raise ValueError(f"plan covers {plan.n_layers} layers, the model has "
                             f"{cfg.n_layers}")
        if len(devices) < plan.n_devices:
            raise ValueError(f"{plan.n_devices} windows need as many devices")
        self.cfg = cfg
        self.plan = plan
        self.opts = opts or ForwardOptions()
        self.devices = [torch.device(d) for d in devices[: plan.n_devices]]
        self.max_seq = max_seq
        self.ranges = plan.layer_ranges()
        # rank-filtered placement: device d holds only its own windows
        self.params, self.kv = [], []
        for d, dev in enumerate(self.devices):
            owned = plan.owned(d)
            p = {"layers": [to_device(get_layer(i), dev) if i in owned else None
                            for i in range(cfg.n_layers)]}
            if d == 0:
                p.update(to_device(head, dev))
            self.params.append(p)
            self.kv.append(init_kv_caches(cfg, batch, max_seq, kv_dtype, dev,
                                          layer_filter=owned.__contains__))
        self.cache_pos = np.zeros(batch, np.int32)

    @torch.no_grad()
    def forward(self, tokens: np.ndarray, positions: np.ndarray) -> torch.Tensor:
        """One ring traversal (k cycles): logits (B, S, V) on the first
        device; writes every window's caches."""
        x = None
        for c in range(self.plan.k):
            for d, dev in enumerate(self.devices):
                lo, hi = self.ranges[d][c]
                if hi == lo:
                    continue
                if x is not None:
                    x = x.to(dev, non_blocking=True)  # the ring hop
                t = lambda a, dt=torch.int32: torch.as_tensor(a, dtype=dt, device=dev)
                x, _ = forward(self.params[d], self.cfg,
                               t(tokens, torch.int64) if lo == 0 else None,
                               t(positions), self.kv[d], t(self.cache_pos), self.opts,
                               return_hidden=True, layer_range=(lo, hi), hidden_in=x)
        # the master shortcut: the last window's output returns to device 0
        logits = lm_head(self.params[0], self.cfg, x.to(self.devices[0]), self.opts)
        self.cache_pos = self.cache_pos + tokens.shape[1]
        return logits

    def greedy_generate(self, prompt: list[int], n_new: int) -> list[int]:
        if self.cache_pos.shape[0] != 1:
            raise ValueError("greedy_generate runs one sequence (batch 1)")
        if len(prompt) > 1:
            self.forward(np.asarray([prompt[:-1]], np.int64),
                         np.arange(len(prompt) - 1, dtype=np.int32)[None])
        cur = prompt[-1]
        out = []
        for _ in range(n_new):
            p = int(self.cache_pos[0])
            logits = self.forward(np.asarray([[cur]], np.int64), np.asarray([[p]], np.int32))
            cur = int(torch.argmax(logits[0, -1]).item())
            out.append(cur)
        return out
