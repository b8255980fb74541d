"""Quantized matmul: the fused dequant-GEMV kernel and its dispatch.

Kernel note. `qgemv` launches quant/cuda/qmatmul.cu, which replaces
prima_tpu/quant/pallas/qmatmul.py:_qmm_kernel (entry qmatmul_pallas). On
the H100 it is bound by device-memory bytes: a decode step reads every
packed weight once (about 4.2 GB for an 8B Q4_K model, about 1.26 ms at
3.35 TB/s), so the work the SM spends per weight decides how near it gets.
Its design: a block owns 128 rows and one slice of K; the activations are
staged once per block in shared memory; the weights stream through a
3-stage cp.async ring in shared memory; the scale is factored out of the
inner loop, sum_k (q_k sc_s + bias_s) x_k = sc_s sum_k q_k x_k + bias_s X_s,
with the sums X_s of x taken once per block (`qmatmul_factored_plain` is
that arithmetic in plain PyTorch); K is split over blocks (`gemv_split`)
so that narrow matrices fill the card and the staged slice of x fits; the
slices write their parts to scratch and the block that finishes a row
block last adds them in the order of their index (an integer arrival
counter per row block, kept per stream by this module, zero between
launches), so the same bits come out on every run. nib4 weights (Q4_K, Q4_0, Q4_1) run
on the tensor cores: nibbles are exact in bf16, x is split into a bf16
high and low part (residual <= 2^-17 |x|, inside the 1e-4 tolerance),
accumulators are f32. int8 weights stay exact in f32 on the CUDA cores,
where a lane owns two rows and x is read as broadcast float4s. More than
8 rows run in passes of 8. `qgemv_indexed` runs the same bodies for
mixture-of-experts decode (the counterpart of the JAX package's dynamic
slice of the stacked experts followed by qmatmul_pallas), grouped by
expert: a third grid axis over expert slots, each block finding its
slot's expert among the ids on the device, offsetting its weight rows and
running that expert's pairs as the batch columns of one body, so each
chosen expert's bytes are read once a launch (`indexed_launch` sizes it
from the shapes alone). The JAX package's sigma column permutation,
tile repeats, 8-row padding and VMEM knobs have no counterpart: they only
serve the TPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc
from .qtensor import QTensor, eff_scales, qmatmul_plain, unpack_q

SOURCE = "quant/cuda/qmatmul.cu"
launches = nvcc.LaunchCounter("qgemv")
indexed_launches = nvcc.LaunchCounter("qgemv_indexed")
MAX_B = 32  # rows at or above this take dequant + one matmul
_SMODE = {"flat": 0, "grouped": 1, "packed": 2}
ROW_BLOCK = 128  # output rows per block of qmatmul.cu
STAGE_BYTES = 128  # bytes of a row per pipeline stage: slices are multiples
X_STAGE_FLOATS = 8192  # floats of x a block stages (32 KB)
MAX_SLICE_BYTES = 1024  # a longer slice's scale words do not fit their staging area
TARGET_BLOCKS = 132  # one block on each of the H100's 132 SMs


def scale_mode(qt: QTensor) -> str:
    if qt.gsub == 1:
        return "flat"
    return "packed" if qt.packed else "grouped"


def gemv_split(n: int, row_bytes: int, b: int, layout: str) -> tuple[int, int]:
    """(ksplit, ksb): the number of K slices and the bytes of each row in a
    slice, a pure function of the shapes. A slice is a multiple of 128
    bytes and small enough that the block's part of x fits its 32 KB
    staging area (nib4: both nibble halves of 4 or 8 batch rows; int8:
    min(B, 8) rows rounded up to a power of two) and its scale words
    theirs (1024 bytes at most). Within that, the slices are as many as
    keep the grid at one block an SM (measured faster than two: the merge
    grows with the slices)."""
    if layout == "nib4":
        halves, nb = 2, 4 if b <= 4 else 8
    else:
        halves, nb = 1, min(8, 1 << (b - 1).bit_length())
    max_ksb = min(MAX_SLICE_BYTES,
                  X_STAGE_FLOATS // (halves * nb) // STAGE_BYTES * STAGE_BYTES)
    want = max(1, TARGET_BLOCKS // -(-n // ROW_BLOCK))  # slices that fill the SMs once
    ksb = -(-(-(-row_bytes // want)) // STAGE_BYTES) * STAGE_BYTES
    ksb = max(STAGE_BYTES, min(max_ksb, ksb))
    return -(-row_bytes // ksb), ksb


def _slices(n: int, row_bytes: int, b: int, layout: str,
            ksplit: int | None) -> tuple[int, int]:
    """(ksplit, ksb) of a launch: `gemv_split`'s, or `ksplit` slices where
    a caller asks for them (fewer than the staging area allows cannot run)."""
    if ksplit is None:
        return gemv_split(n, row_bytes, b, layout)
    ksb = -(-(-(-row_bytes // ksplit)) // STAGE_BYTES) * STAGE_BYTES
    if not 1 <= ksplit or ksb > gemv_split(1 << 30, row_bytes, b, layout)[1] \
            or -(-row_bytes // ksb) != ksplit:
        raise ValueError(f"qgemv: cannot cut {row_bytes} bytes a row into {ksplit}")
    return ksplit, ksb


def qmatmul_factored_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: per sub-block s,
    y += sc_s * sum_k q_k x_k + bias_s * X_s with X_s = sum_{k in s} x_k and
    bias_s = q_offset * sc_s - min_s. x (B, K) f32 -> (B, N) f32."""
    sc, mn = eff_scales(qt, qt.scales, qt.mins, qt.d, qt.dmin)  # (N, S)
    q = unpack_q(qt, qt.qs) - qt.q_offset  # stored integers, (N, K)
    bias = qt.q_offset * sc - (mn if mn is not None else 0.0)
    n_sub = sc.shape[-1]
    xs = x.float().reshape(x.shape[0], n_sub, qt.sub)
    dots = torch.einsum("nsk,bsk->bns", q.reshape(q.shape[0], n_sub, qt.sub), xs)
    return (dots * sc).sum(-1) + xs.sum(-1) @ bias.t()


_done: dict[tuple[int, int], torch.Tensor] = {}


def _done_counters(device: torch.device, stream: int, n_blocks: int) -> torch.Tensor:
    """The split-K arrival counters of one stream: one int32 per block of
    128 rows, zero between launches (the kernel wraps each back to 0)."""
    key = (device.index or 0, stream)
    buf = _done.get(key)
    if buf is None or buf.numel() < n_blocks:
        buf = _done[key] = torch.zeros(max(4096, n_blocks), dtype=torch.int32,
                                       device=device)
    return buf


def _lib():
    lib = nvcc.load(SOURCE)
    fn = lib.prima_qgemv
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, qt: QTensor) -> None:
    n, k = qt.n_rows, qt.n_cols
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("qgemv wants a contiguous f32 (B, K) activation")
    if not 1 <= x.shape[0] <= MAX_B or x.shape[1] != k:
        raise ValueError(f"qgemv: x {tuple(x.shape)} against weight ({n}, {k})")
    pow2 = lambda v: v > 0 and v & (v - 1) == 0
    if (qt.sub not in (16, 32) or not pow2(qt.gsub) or k % qt.sub
            or k % (64 if qt.layout == "nib4" else 32)):
        raise ValueError(f"qgemv: unsupported sub={qt.sub} gsub={qt.gsub} K={k}")
    if qt.layout == "nib4" and ((k // 2) % qt.sub or qt.sub != 32):
        raise ValueError("qgemv: nib4 halves must start on a sub-block of 32")
    for a in (x, *qt.tensors()):
        if a is None:
            continue
        if a.device != x.device or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError("qgemv: operands must be contiguous, 16-byte "
                             "aligned and on one device")


def qgemv(x: torch.Tensor, qt: QTensor, ksplit: int | None = None) -> torch.Tensor:
    """x (B, K) f32, B <= 32 -> (B, N) f32. A CUDA tensor launches the
    kernel (or raises), K cut into `gemv_split` slices unless `ksplit` asks
    for another number; a CPU tensor takes `qmatmul_plain`, the kernel's
    function in plain PyTorch."""
    if x.device.type == "cpu":
        return qmatmul_plain(x, qt)
    _check(x, qt)
    b, n, k = x.shape[0], qt.n_rows, qt.n_cols
    n_slices, ksb = _slices(n, qt.qs.shape[1], b, qt.layout, ksplit)
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part = done = None
    if n_slices > 1:
        part = torch.empty((n_slices, min(b, 8), n), dtype=torch.float32, device=x.device)
        done = _done_counters(x.device, stream, -(-n // ROW_BLOCK))
    ptr = lambda a: None if a is None else a.data_ptr()
    rc = _lib()(ptr(x), ptr(qt.qs), ptr(qt.scales), ptr(qt.mins), ptr(qt.d),
                ptr(qt.dmin), ptr(out), ptr(part), ptr(done), b, n, k,
                0 if qt.layout == "nib4" else 1, qt.sub, qt.gsub, qt.q_offset,
                _SMODE[scale_mode(qt)], ksb, n_slices, stream)
    nvcc.check(rc, "qgemv launch")
    launches.count += 1
    return out


def _lib_indexed():
    lib = nvcc.load(SOURCE)
    fn = lib.prima_qgemv_indexed
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
                       + [ctypes.c_longlong] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def indexed_cols(per_expert: int, layout: str) -> int:
    """Batch columns of the indexed kernel's body a pass for experts of at
    most `per_expert` pairs. nib4: 4, one mma column tile (8 columns were
    slower than passes of 4 on the H100 at every grouping measured). int8: 1
    for one pair, else 2: the CUDA cores pay an FMA a weight a column, so 4
    columns lose wherever an expert holds 2 pairs or fewer, the common case
    of a 4-row decode."""
    if layout == "nib4":
        return 4
    return 1 if per_expert <= 1 else 2


def indexed_launch(n: int, row_bytes: int, p: int, n_exp: int, per_expert: int,
                   layout: str, ksplit: int | None = None) -> tuple[int, int, int, int, int]:
    """(slots, cols, passes, ksplit, ksb) of an indexed launch, a pure
    function of the shapes and of `per_expert`, the most pairs one expert
    can hold: min(E, P) expert slots on the grid, `indexed_cols` batch
    columns a pass, enough passes for `per_expert` pairs, and K cut as
    `gemv_split` cuts it for `cols` rows of x and n * slots output rows (the
    slots bound the distinct experts from above; `ksplit` overrides the cut
    as qgemv's does)."""
    if not 1 <= per_expert <= p:
        raise ValueError(f"qgemv_indexed: per_expert {per_expert} for {p} pairs")
    cols = indexed_cols(per_expert, layout)
    slots = min(n_exp, p)
    n_slices, ksb = _slices(n * slots, row_bytes, cols, layout, ksplit)
    return slots, cols, -(-per_expert // cols), n_slices, ksb


def _expert_count(qt: QTensor, n: int) -> int:
    if n <= 0 or qt.n_rows % n:
        raise ValueError(f"{qt.n_rows} stacked rows are not whole experts of {n}")
    return qt.n_rows // n


def qgemv_indexed_plain(x: torch.Tensor, qt: QTensor, ids: torch.Tensor,
                        n: int, per_expert: int | None = None) -> torch.Tensor:
    """The expert-indexed GEMV in plain PyTorch: row p of x (P, K) through
    rows [ids[p] n, (ids[p] + 1) n) of the stacked experts `qt`, each
    expert's slice dequantized once for the pairs that chose it -> (P, n)
    in x's dtype. Reads the ids on the host; `per_expert` (the kernel's
    launch bound) is not needed here."""
    _expert_count(qt, n)
    out = torch.empty((x.shape[0], n), dtype=x.dtype, device=x.device)
    ids_host = ids.cpu()
    for e in ids_host.unique().tolist():
        rows = (ids_host == e).nonzero()[:, 0].to(x.device)
        out[rows] = qmatmul_plain(x[rows], qt.rows(e * n, (e + 1) * n))
    return out


def qgemv_indexed(x: torch.Tensor, qt: QTensor, ids: torch.Tensor, n: int,
                  ksplit: int | None = None, per_expert: int | None = None) -> torch.Tensor:
    """The expert-indexed GEMV: x (P, K) f32, P <= 32 (row, expert) pairs,
    `qt` the stacked experts of E * n rows, ids (P,) int32 expert ids on
    the device -> (P, n) f32, row p = dequant(expert ids[p]) @ x[p]. One
    launch for all pairs: a block a distinct expert finds it among the ids
    on the device, reads its bytes once for all its pairs, and offsets its
    weight rows, so nothing syncs to the host and no expert is copied.
    `per_expert` (default P) bounds the pairs of any one expert; a caller
    whose rows pick distinct experts passes the row count. `ksplit`
    overrides `indexed_launch`'s K cut. A CPU tensor takes
    `qgemv_indexed_plain`."""
    n_exp = _expert_count(qt, n)
    if x.device.type == "cpu":
        return qgemv_indexed_plain(x, qt, ids, n, per_expert)
    _check(x, qt)
    p, k = x.shape[0], qt.n_cols
    if ids.dtype != torch.int32 or ids.shape != (p,) or ids.device != x.device \
            or not ids.is_contiguous():
        raise ValueError("qgemv_indexed wants contiguous int32 ids (P,) on x's device")
    slots, cols, passes, n_slices, ksb = indexed_launch(
        n, qt.qs.shape[1], p, n_exp, p if per_expert is None else per_expert, qt.layout,
        ksplit)
    out = torch.empty((p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part = done = None
    if n_slices > 1:  # each (slot, pass) has its own scratch and arrival counters
        part = torch.empty((slots, passes, n_slices, cols, n), dtype=torch.float32,
                           device=x.device)
        done = _done_counters(x.device, stream, slots * passes * -(-n // ROW_BLOCK))
    ptr = lambda a: None if a is None else a.data_ptr()
    # bytes between two experts in each array (every array holds E * n rows)
    stride = lambda a: 0 if a is None else a.numel() * a.element_size() // n_exp
    rc = _lib_indexed()(ptr(x), ptr(qt.qs), ptr(qt.scales), ptr(qt.mins), ptr(qt.d),
                        ptr(qt.dmin), ptr(out), ptr(part), ptr(done), ptr(ids), p, n, k,
                        0 if qt.layout == "nib4" else 1, qt.sub, qt.gsub, qt.q_offset,
                        _SMODE[scale_mode(qt)], ksb, n_slices, slots, cols, passes,
                        *(stride(a) for a in qt.tensors()), stream)
    nvcc.check(rc, "qgemv_indexed launch")
    indexed_launches.count += 1
    return out


def qmatmul_indexed(x: torch.Tensor, qt: QTensor, ids: torch.Tensor, n: int,
                    per_expert: int | None = None) -> torch.Tensor:
    """x (P, K) through the experts ids (P,) of stacked `qt` -> (P, n) in
    x's dtype, through the expert-indexed GEMV."""
    return qgemv_indexed(x.float().contiguous(), qt, ids, n,
                         per_expert=per_expert).to(x.dtype)


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
