"""In-place KV-cache writes: the CUDA kernels and their plain versions.

Kernel note. `kv_write` launches ops/cuda/kv_write.cu, which replaces
prima_tpu/ops/kv_pallas.py:_kv_write_kernel (entry kv_write). On the H100
it is bound by device-memory bytes (the new rows read once and written
once), which at decode are a few KB, so the launch dominates. Its design
writes every batch row in one launch at per-row offsets read from a
device int32 tensor (no host sync), clamped to [0, T - S] like
dynamic_update_slice, with 16-byte vector copies and a bytewise tail; it
has no alignment gate on the row width.

Kernel note. `kv_store` launches `prima_kv_store` of the same source: one
layer's K rows and V rows into both caches in one launch, where the decoder
of the JAX package calls the TPU kernel twice and, for a KVQ8 / KVQ4 cache,
runs quantize_kv / quantize_kv4 (prima_tpu/ops/kvquant.py:82-102) around
it. Its bound is bytes, in practice the launch, so its design is fewer
launches: dense rows are copied (and cast, when they are of the other float
type) by 16-byte accesses; for a quantized cache a warp takes one (row,
head) vector through amax, the two IEEE divisions, round half to even, the
clamp and the nibble packing, and stores codes and scale in place, bit for
bit what `quantize_kv` / `quantize_kv4` give.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc

SOURCE = "ops/cuda/kv_write.cu"
launches = nvcc.LaunchCounter("kv_write")
store_launches = nvcc.LaunchCounter("kv_store")


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


def kv_store_plain(k_cache, v_cache, k_new: torch.Tensor, v_new: torch.Tensor,
                   pos: torch.Tensor):
    """What `kv_store` computes, in plain PyTorch: `update_kv` for K and for
    V (quantize_kv / quantize_kv4 for a quantized cache, a cast for a dense
    one, then `kv_write_plain`)."""
    from .kvquant import update_kv_plain

    return update_kv_plain(k_cache, k_new, pos), update_kv_plain(v_cache, v_new, pos)


def _store_lib():
    fn = nvcc.load(SOURCE).prima_kv_store
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_FLOATS = (torch.float32, torch.bfloat16)


def kv_store(k_cache, v_cache, k_new: torch.Tensor, v_new: torch.Tensor,
             pos: torch.Tensor):
    """One layer's K and V rows (B, S, H, D) into both caches (B, T, H, D)
    at per-row positions pos (B,), in place, in one launch. The caches are
    both dense (bf16 or f32; rows of the other float type are cast), both
    KVQ8 or both KVQ4 (the rows are quantized in the kernel). CUDA caches
    launch the kernel (or raise); CPU caches take `kv_store_plain`. Returns
    the caches."""
    quant = hasattr(k_cache, "qs")
    kx, vx = (k_cache.qs, v_cache.qs) if quant else (k_cache, v_cache)
    if kx.device.type == "cpu":
        return kv_store_plain(k_cache, v_cache, k_new, v_new, pos)
    if type(k_cache) is not type(v_cache) or tuple(k_cache.shape) != tuple(v_cache.shape) \
            or kx.dtype != vx.dtype:
        raise ValueError("kv_store: the K and V caches must be of one kind and shape")
    b, t, h, d = k_cache.shape
    s = k_new.shape[1]
    if k_new.shape != v_new.shape or tuple(k_new.shape) != (b, s, h, d) or s > t:
        raise ValueError(f"kv_store: new rows {tuple(k_new.shape)}, {tuple(v_new.shape)} "
                         f"into caches {tuple(k_cache.shape)}")
    if k_new.dtype not in _FLOATS or v_new.dtype != k_new.dtype:
        raise ValueError("kv_store: new rows must both be float32 or both bfloat16")
    if pos.dtype != torch.int32 or pos.shape != (b,) or not pos.is_contiguous():
        raise ValueError("kv_store: pos must be a contiguous (B,) int32 tensor")
    parts = [kx, vx, k_new, v_new, pos] + ([k_cache.scale, v_cache.scale] if quant else [])
    if any(x.device != kx.device for x in parts):
        raise ValueError("kv_store: caches, new rows and pos must share a device")
    if s == 0:
        return k_cache, v_cache
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    if k_new.data_ptr() % 16 or v_new.data_ptr() % 16:
        raise ValueError("kv_store: new rows must be 16-byte aligned")
    for x in parts[:2] + parts[5:]:
        if not x[0].is_contiguous():
            raise ValueError("kv_store: each cache row (T, ...) must be contiguous")
    kind, ks, vs, sc_strides = 0, None, None, (0, 0)
    if quant:
        kind = 2 if kx.shape[3] * 2 == d else 1
        ks, vs = k_cache.scale, v_cache.scale
        if d % 8 or ks.dtype != torch.float32 or vs.dtype != torch.float32 \
                or any(x.data_ptr() % 4 or x.stride(0) % 4 for x in (kx, vx)):
            raise ValueError("kv_store: quantized caches need head_dim % 8 == 0, f32 "
                             "scales and 4-byte aligned code rows")
        sc_strides = (ks.stride(0), vs.stride(0))
    elif kx.dtype not in _FLOATS:
        raise ValueError(f"kv_store: dense caches of {kx.dtype}")
    ptr = lambda a: None if a is None else a.data_ptr()
    rc = _store_lib()(
        kx.data_ptr(), vx.data_ptr(), ptr(ks), ptr(vs), k_new.data_ptr(), v_new.data_ptr(),
        pos.data_ptr(), kind, int(k_new.dtype == torch.bfloat16),
        int(kx.dtype == torch.bfloat16), b, t, s, h, d,
        kx.stride(0) * kx.element_size(), vx.stride(0) * vx.element_size(), *sc_strides,
        torch.cuda.current_stream(kx.device).cuda_stream)
    nvcc.check(rc, "kv_store launch")
    store_launches.count += 1
    return k_cache, v_cache
