"""Quantized matmul: the fused dequant-GEMV kernel and its dispatch.

Kernel note. `qgemv` launches quant/cuda/qmatmul.cu, which replaces
prima_tpu/quant/pallas/qmatmul.py:_qmm_kernel (entry qmatmul_pallas). On
the H100 it is bound by device-memory bytes: a decode step reads every
packed weight once (about 4.2 GB for an 8B Q4_K model, about 1.26 ms at
3.35 TB/s). Its design gives each warp two rows, reads them as 16-byte
chunks in natural column order with the next chunk's bytes in flight,
turns quants into floats with one byte permute and one subtract, forms
each weight with one fma (within one rounding of `dequant`), and
accumulates in f32; see the source for the rest. The JAX package's sigma
column permutation, tile repeats, 8-row padding and VMEM knobs have no
counterpart: they only serve the TPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc
from .qtensor import QTensor, qmatmul_plain

SOURCE = "quant/cuda/qmatmul.cu"
launches = nvcc.LaunchCounter("qgemv")
MAX_B = 32  # rows at or above this take dequant + one matmul
_SMODE = {"flat": 0, "grouped": 1, "packed": 2}


def scale_mode(qt: QTensor) -> str:
    if qt.gsub == 1:
        return "flat"
    return "packed" if qt.packed else "grouped"


def _lib():
    lib = nvcc.load(SOURCE)
    fn = lib.prima_qgemv
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, qt: QTensor) -> None:
    n, k = qt.n_rows, qt.n_cols
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("qgemv wants a contiguous f32 (B, K) activation")
    if not 1 <= x.shape[0] <= MAX_B or x.shape[1] != k:
        raise ValueError(f"qgemv: x {tuple(x.shape)} against weight ({n}, {k})")
    pow2 = lambda v: v > 0 and v & (v - 1) == 0
    if (qt.sub % 16 or not pow2(qt.sub) or not pow2(qt.gsub) or k % qt.sub
            or k % (32 if qt.layout == "nib4" else 16)):
        raise ValueError(f"qgemv: unsupported sub={qt.sub} gsub={qt.gsub} K={k}")
    if qt.layout == "nib4" and (k // 2) % qt.sub:
        raise ValueError("qgemv: nib4 halves must start on a sub-block")
    for a in (x, *qt.tensors()):
        if a is None:
            continue
        if a.device != x.device or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError("qgemv: operands must be contiguous, 16-byte "
                             "aligned and on one device")


def qgemv(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (B, K) f32, B <= 32 -> (B, N) f32. A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes `qmatmul_plain`, the kernel's
    function in plain PyTorch."""
    if x.device.type == "cpu":
        return qmatmul_plain(x, qt)
    _check(x, qt)
    b, n, k = x.shape[0], qt.n_rows, qt.n_cols
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    ptr = lambda a: None if a is None else a.data_ptr()
    rc = _lib()(ptr(x), ptr(qt.qs), ptr(qt.scales), ptr(qt.mins), ptr(qt.d),
                ptr(qt.dmin), ptr(out), b, n, k,
                0 if qt.layout == "nib4" else 1, qt.sub, qt.gsub, qt.q_offset,
                _SMODE[scale_mode(qt)], torch.cuda.current_stream(x.device).cuda_stream)
    nvcc.check(rc, "qgemv launch")
    launches.count += 1
    return out


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., K) @ dequant(W)^T -> (..., N) in x's dtype. Fewer than 32
    rows stream through the GEMV; wider inputs dequantize and run one
    matmul (the counterpart of qmatmul.py:457-459 in the JAX package)."""
    lead = x.shape[:-1]
    b = 1
    for s in lead:
        b *= s
    if b >= MAX_B:
        return qmatmul_plain(x, qt)
    y = qgemv(x.reshape(b, x.shape[-1]).float().contiguous(), qt)
    return y.reshape(*lead, qt.n_rows).to(x.dtype)
