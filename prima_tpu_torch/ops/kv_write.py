"""In-place KV-cache write: the CUDA kernel and its plain version.

Kernel note. `kv_write` launches ops/cuda/kv_write.cu, which replaces
prima_tpu/ops/kv_pallas.py:_kv_write_kernel (entry kv_write). On the H100
it is bound by device-memory bytes (the new rows read once and written
once), which at decode are a few KB, so the launch dominates. Its design
writes every batch row in one launch at per-row offsets read from a
device int32 tensor (no host sync), clamped to [0, T - S] like
dynamic_update_slice, with 16-byte vector copies and a bytewise tail; it
has no alignment gate on the row width.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc

SOURCE = "ops/cuda/kv_write.cu"
launches = nvcc.LaunchCounter("kv_write")


def write_starts(pos: torch.Tensor, t: int, s: int) -> torch.Tensor:
    return pos.to(torch.int64).clamp(min=0, max=t - s)


def kv_write_plain(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """cache (B, T, ...) <- new (B, S, ...) at rows clamp(pos, 0, T - S),
    in place (JAX's functional update becomes an index_put_)."""
    b, t, s = cache.shape[0], cache.shape[1], new.shape[1]
    rows = write_starts(pos, t, s)[:, None] + torch.arange(s, device=cache.device)
    cache[torch.arange(b, device=cache.device)[:, None], rows] = new.to(cache.dtype)
    return cache


def _lib():
    fn = nvcc.load(SOURCE).prima_kv_write
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def kv_write(cache: torch.Tensor, new: torch.Tensor,
             pos: torch.Tensor) -> torch.Tensor:
    """In-place write of new (B, S, ...) into cache (B, T, ...) at per-row
    positions pos (B,). A CUDA cache launches the kernel (or raises); a CPU
    cache takes `kv_write_plain`. Returns `cache`."""
    if cache.device.type == "cpu":
        return kv_write_plain(cache, new, pos)
    b, t, s = cache.shape[0], cache.shape[1], new.shape[1]
    if new.shape[0] != b or new.shape[2:] != cache.shape[2:] or s > t:
        raise ValueError(f"kv_write: new {tuple(new.shape)} into cache "
                         f"{tuple(cache.shape)}")
    if new.dtype != cache.dtype or not new.is_contiguous():
        raise ValueError("kv_write: new rows must be contiguous and of the "
                         "cache's dtype")
    if not cache[0].is_contiguous():
        raise ValueError("kv_write: each cache row (T, ...) must be contiguous")
    if pos.dtype != torch.int32 or pos.shape != (b,) or not pos.is_contiguous():
        raise ValueError("kv_write: pos must be a contiguous (B,) int32 tensor")
    if new.device != cache.device or pos.device != cache.device:
        raise ValueError("kv_write: cache, new and pos must share a device")
    esz = cache.element_size()
    row_bytes = cache[0, 0].numel() * esz
    rc = _lib()(cache.data_ptr(), new.data_ptr(), pos.data_ptr(), b, t, s,
                row_bytes, cache.stride(0) * esz,
                torch.cuda.current_stream(cache.device).cuda_stream)
    nvcc.check(rc, "kv_write launch")
    launches.count += 1
    return cache
