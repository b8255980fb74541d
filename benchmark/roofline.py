"""The yardstick's arithmetic: peaks, a step's and a launch's operations
and bytes, and the reduction of a device trace.

Bytes are counted from the configuration's GGUF types and the shapes,
whatever format the program stores: each weight's blocks read once, the
activations read once, the output written once; for the expert-indexed
GEMV only the distinct experts its ids chose. A later change of storage
format then does not move the yardstick.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

from . import spec
from .blocks import row_bytes

# NVIDIA H100 SXM data sheet: dense bf16 tensor cores, HBM3
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
KV_BYTES = 2  # a bf16 cache element

# a kernel's time goes to the first entry whose names it matches (indexed first)
KERNEL_NAMES = {"qgemv_indexed": ("qgemv_mma_indexed", "qgemv_fma_indexed"),
                "qgemv": ("qgemv_mma", "qgemv_fma"), "kv_write": ("kv_write_kernel",),
                "kv_store": ("kv_store_dense", "kv_store_quant"),
                "flash_decode": ("decode_mma", "decode_f32"),
                "flash_prefill": ("prefill_mma", "prefill_f32", "prefill_combine")}


def least_time(flops: float, nbytes: float) -> float:
    """The least seconds the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def gemv_weight_bytes(n: int, k: int, ggml_type: int, distinct: int = 1) -> float:
    """The weight bytes of one GEMV launch: `distinct` matrices of n rows of
    k weights in `ggml_type` (one for qgemv; the chosen experts for the
    indexed GEMV)."""
    return float(distinct * n * row_bytes(ggml_type, k))


def gemv_work(b: int, n: int, k: int, ggml_type: int, distinct: int = 1) -> tuple[float, float]:
    """(FLOPs, bytes) of one GEMV launch: b rows of x (k f32 each; for the
    indexed GEMV (row, expert) pairs) through its weights, y (b, n) f32
    written once."""
    return 2.0 * b * n * k, gemv_weight_bytes(n, k, ggml_type, distinct) + 4.0 * b * (n + k)


def kind_of(name: str) -> str:
    return next((k for k, ms in KERNEL_NAMES.items() if any(m in name for m in ms)), "other")


class BlockCost(NamedTuple):
    """What an architecture file's `cost(model)` gives: a token's FLOPs
    through every layer's weights (2 per weight it multiplies: the experts
    it uses, routers included), the attention FLOPs of one visible cache
    cell over all layers, and the cache bytes of one cell over all layers."""
    layer_flops: float
    attn_flops_cell: float
    kv_bytes_cell: float


class ModelCost:
    """A configuration's operations and bytes (configs/<name>.json "model",
    its architecture's cost and its tensor table)."""

    def __init__(self, model: dict, table: list):
        self.layer_flops, self.attn_flops_cell, self.kv_bytes_cell = spec.arch(model).cost(model)
        self.head_flops = 2.0 * model["n_embd"] * model["n_vocab"]
        self.weight_bytes = 0.0  # every quantized weight but the head and embedding
        self.head_bytes = 0.0
        self.embd_row_bytes = 0.0
        for t in table:
            if t.dense is not None:
                continue
            nb = row_bytes(t.ggml_type, t.shape[-1])
            rows = 1
            for s in t.shape[:-1]:
                rows *= s
            if t.name == "output.weight":
                self.head_bytes = rows * nb
            elif t.name == "token_embd.weight":
                self.embd_row_bytes = nb
            else:
                self.weight_bytes += rows * nb

    def token_flops(self, visible: int, head: bool) -> float:
        """One token's FLOPs through every layer with `visible` cache cells
        (itself included), and the head's where it is computed."""
        f = self.layer_flops + self.attn_flops_cell * visible
        return f + (self.head_flops if head else 0.0)

    def prefill_chunk(self, rows: int, pos0: int, launch_bytes: float | None) -> float:
        """Least seconds of a prefill chunk of `rows` at positions pos0...:
        its FLOPs (no head: a chunk returns hidden states) against its
        weights read once (`launch_bytes`, the GEMV launches' own, where
        the chunk took the GEMV route; else every weight: the dense route
        reads each expert), its embedding rows and its visible cache."""
        flops = sum(self.token_flops(pos0 + i + 1, head=False) for i in range(rows))
        w = self.weight_bytes if launch_bytes is None else launch_bytes
        nbytes = w + rows * self.embd_row_bytes + (pos0 + rows) * self.kv_bytes_cell
        return least_time(flops, nbytes)

    def decode_steps(self, visible: list[int], steps: int, launch_bytes: float | None) -> float:
        """Least seconds of `steps` decode steps whose active rows had
        `visible` cells each (one entry a row a step): their FLOPs with the
        head against the weights their GEMV launches read (`launch_bytes`;
        where they made none, every weight once a step) plus each row's
        visible cache and embedding row."""
        flops = sum(self.token_flops(v, head=True) for v in visible)
        w = (launch_bytes if launch_bytes is not None
             else steps * (self.weight_bytes + self.head_bytes))
        nbytes = w + sum(visible) * self.kv_bytes_cell + len(visible) * self.embd_row_bytes
        return least_time(flops, nbytes)


def union_seconds(intervals: list[tuple[float, float]]) -> tuple[float, list]:
    """(total seconds covered, merged intervals) of (start, end) pairs."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def device_ops(events: list[tuple[str, float, float]], top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time: the
    port's kernels by KERNEL_NAMES, then the other names."""
    by_kind: Counter = Counter()
    by_name: Counter = Counter()
    for name, s, e in events:
        k = kind_of(name)
        if k == "other":
            by_name[name[:80]] += e - s
        else:
            by_kind[k] += e - s
    return [[n, t] for n, t in (by_kind + by_name).most_common(top)]
