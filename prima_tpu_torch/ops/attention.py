"""Flash attention over the KV cache (GQA, causal): the CUDA kernels and
their plain versions.

Counterpart of prima_tpu/ops/attention_pallas.py. Queries are (B, S, H, D),
the caches (B, T, KVH, D) in their natural layout, positions (B, S). The
GQA group folds into rows (row = g * S + s per KV head) and row r of batch
row b sees cell c iff c <= positions[b, 0] + r % S, as the TPU kernels
compute it. Scores, softmax and P.V run in f32 (unlike `gqa_attention`,
which casts the probabilities to v's dtype); the output is in q's dtype.
Positions must be >= 0: cell 0 is then visible to every row.

Kernel notes.
- `flash_decode` launches ops/cuda/flash_decode.cu, which replaces
  prima_tpu/ops/attention_pallas.py:_decode_kernel (entry flash_decode).
  It is bound by the bytes of the visible K/V cells, so it takes a KVQ8 or
  KVQ4 cache as it is and reads the codes and scales (half and a quarter
  of the bf16 bytes), dequantizing to the reference's own bits on the way
  to the arithmetic. Its design splits the T axis over blocks
  (`decode_split`, a pure function of the shapes) so that B * KVH = 32 at
  the 8B shape still fills the card, reads the positions on the device (no
  host sync) and skips every chunk past the last visible cell. Each warp
  streams its own 16-cell tiles through a ring of cp.async stages in the
  cache's own type; bf16 queries run both products on the tensor cores
  (mma.sync.m16n8k16), f32 queries exact f32 FMAs. The chunks' parts are
  merged by the last block to arrive, in index order: one launch, the same
  bits on every run. Arrival counters live per stream in `_done` and are
  zero between launches.
- `flash_prefill` launches ops/cuda/flash_attn.cu, which replaces
  prima_tpu/ops/attention_pallas.py:_attn_kernel (entry flash_attention,
  s_q > 8). At prefill it is bound by operations. For bf16 tensors both
  products run on the tensor cores (mma.sync.m16n8k16, f32 accumulators,
  f32 softmax in registers, P rounded to bf16 for P.V); K/V tiles of 64
  cells are copied asynchronously (cp.async, two stages) from the cache's
  natural layout and strides into swizzled bf16 shared memory, with no
  transpose copy. f32 tensors keep exact f32 FMAs on the CUDA cores. Both
  split the KV axis over `prefill_n_split` blocks (interleaved tiles, so
  the split is even wherever the positions lie; chosen from the shapes
  alone), merge the parts in a second kernel from f32 scratch, stop at each
  row tile's last visible cell and mask only the tiles that cross a
  position. `flash_prefill_split_plain` is that split and merge in plain
  PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc
from .kvquant import KVQ4, KVQ8, is_quantized

NEG_INF = -1e30
DECODE_SOURCE = "ops/cuda/flash_decode.cu"
PREFILL_SOURCE = "ops/cuda/flash_attn.cu"
# blocks over all of T: one for each resident slot (2 x 132 SMs), so a full
# cache runs in one wave; measured against 512 for every cache kind
# (decode_sweep.py)
DECODE_BLOCKS = 256
DECODE_MIN_SPLIT = 256  # KV cells: a shorter chunk does not fill a block's rings
PREFILL_ROWS = 64  # folded query rows per block of flash_attn.cu
PREFILL_SLOTS = 2 * 132  # blocks the card holds at once: 2 on each of 132 SMs
PREFILL_MAX_SPLIT = 8  # each split costs f32 scratch, written and read once
decode_launches = nvcc.LaunchCounter("flash_decode")
prefill_launches = nvcc.LaunchCounter("flash_prefill")


def decode_kv_blk(t: int) -> int:
    """The TPU decode kernel's KV block: min(T, 256), halved until it
    divides T. Only cells below clip(ceil((pos_last + 1) / kv_blk), 1,
    T / kv_blk) * kv_blk are read."""
    kv_blk = min(t, 256)
    while t % kv_blk:
        kv_blk //= 2
    return kv_blk


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            positions: torch.Tensor, scale: float,
            limit: torch.Tensor | None) -> torch.Tensor:
    """Plain f32 attention with the kernels' visibility rule. Cells at or
    past limit (B,) are not read at all; visible cells follow
    c <= pos0 + s and masked ones score -1e30, as in the TPU kernels."""
    b, s_q, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s_q, n_kv, h // n_kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    cols = torch.arange(t, device=q.device)
    qpos = positions[:, :1].long() + torch.arange(s_q, device=q.device)  # (b, s)
    visible = cols[None, None, :] <= qpos[:, :, None]  # (b, s, t)
    scores = torch.where(visible[:, None, None], scores, NEG_INF)
    if limit is not None:
        inside = cols[None, :] < limit[:, None]  # (b, t)
        scores = torch.where(inside[:, None, None, None, :], scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s_q, h, d).to(q.dtype)


def flash_decode_plain(q, k, v, positions, scale: float) -> torch.Tensor:
    """What _decode_kernel computes, in plain PyTorch (reads all of T, then
    drops the cells the kernel does not read). A quantized cache is
    materialized in q's dtype first, as the reference does."""
    k, v = k.to(q.dtype), v.to(q.dtype)
    t = k.shape[1]
    kv_blk = decode_kv_blk(t)
    nblk = ((positions[:, -1].long() + kv_blk) // kv_blk).clamp(1, t // kv_blk)
    return _attend(q, k, v, positions, scale, nblk * kv_blk)


def decode_rows_per_block(rows: int, dtype: torch.dtype) -> int:
    """Folded query rows a block of the decode kernel takes. bf16: one
    16-row tensor-core tile, or two with more than 16 rows. f32: 1, 4 or 16
    rows in registers, the least that holds them all."""
    if dtype == torch.bfloat16:
        return 32 if rows > 16 else 16
    return 1 if rows == 1 else (4 if rows <= 4 else 16)


def decode_split(b: int, s: int, h: int, n_kv: int, t: int,
                 dtype: torch.dtype) -> tuple[int, int]:
    """(n_split, split_len) of the decode kernel's cut of the T axis: a pure
    function of the shapes (no host sync on positions), the same for every
    cache kind. About DECODE_BLOCKS blocks cover all of T; a chunk keeps at
    least DECODE_MIN_SPLIT cells and is a multiple of 64 (four warps of
    16-cell tiles)."""
    rows = (h // n_kv) * s
    blocks = b * n_kv * -(-rows // decode_rows_per_block(rows, dtype))
    n_split = max(1, min(DECODE_BLOCKS // blocks, -(-t // DECODE_MIN_SPLIT)))
    split_len = -(-(-(-t // n_split)) // 64) * 64
    return -(-t // split_len), split_len


def flash_prefill_plain(q, k, v, positions, scale: float) -> torch.Tensor:
    """What _attn_kernel computes, in plain PyTorch."""
    return _attend(q, k, v, positions, scale, None)


def prefill_tile(dtype: torch.dtype) -> int:
    """KV cells per tile of the prefill kernel: 64 on the tensor cores
    (bf16), 32 on the CUDA cores (f32)."""
    return 64 if dtype == torch.bfloat16 else 32


def prefill_n_split(b: int, s: int, h: int, n_kv: int, t: int, tile: int) -> int:
    """How many blocks share one row tile's walk over the KV axis: a pure
    function of the shapes (no host sync on positions). The grid
    B * KVH * row tiles * n_split fills the card's resident block slots
    (two on each of 132 SMs) once and no more; every split keeps at least
    4 of the cache's tiles, and at most 8 splits write scratch."""
    blocks = b * n_kv * -(-(h // n_kv) * s // PREFILL_ROWS)
    n_tiles = -(-t // tile)
    return max(1, min(PREFILL_SLOTS // blocks, PREFILL_MAX_SPLIT, n_tiles // 4))


def flash_prefill_split_plain(q, k, v, positions, scale: float, n_split: int,
                              tile: int) -> torch.Tensor:
    """What the prefill kernel computes with n_split > 1, in plain PyTorch:
    split j of a row tile (64 folded rows) takes the KV tiles j, j + n_split,
    ... below the row tile's last visible cell and keeps an online-softmax
    part (m, l, acc); a split with no such tile stays empty; the parts are
    merged in the order of their index."""
    b, s_q, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    rows = g * s_q
    dev = q.device
    qf = q.float().reshape(b, s_q, n_kv, g, d).permute(0, 2, 3, 1, 4).reshape(b, n_kv, rows, d)
    scores = torch.einsum("bkrd,btkd->bkrt", qf, k.float()) * scale
    r = torch.arange(rows, device=dev)
    cols = torch.arange(t, device=dev)
    pos0 = positions[:, :1].long()  # (b, 1)
    qpos = pos0 + r % s_q  # (b, rows)
    # the row tile's last visible cell: pos0 + the largest r % S among its rows
    r0 = r // PREFILL_ROWS * PREFILL_ROWS
    s_last = r0 % s_q + (r0 + PREFILL_ROWS).clamp(max=rows) - 1 - r0
    end = (pos0 + s_last.clamp(max=s_q - 1) + 1).clamp(max=t)  # (b, rows)
    scores = torch.where((cols <= qpos[:, :, None])[:, None], scores, NEG_INF)
    inside = cols < end[:, :, None]  # (b, rows, t)
    vf = v.float()
    parts = []
    for j in range(n_split):
        mine = (inside & ((cols // tile) % n_split == j))[:, None]  # (b, 1, rows, t)
        active = mine.any(-1, keepdim=True)
        sj = torch.where(mine, scores, float("-inf"))
        m = torch.where(active, sj.max(-1, keepdim=True).values, NEG_INF)
        p = torch.exp(sj - m)
        parts.append((active, m, p.sum(-1, keepdim=True),
                      torch.einsum("bkrt,btkd->bkrd", p, vf)))
    m_all = torch.stack([m for _, m, _, _ in parts]).max(0).values
    l = torch.zeros_like(m_all)
    acc = torch.zeros_like(parts[0][3])
    for active, m, lj, aj in parts:  # an empty split has weight 0
        w = torch.where(active, torch.exp(m - m_all), 0.0)
        l = l + lj * w
        acc = acc + aj * w
    out = acc / l.clamp(min=1e-30)
    return (out.reshape(b, n_kv, g, s_q, d).permute(0, 3, 1, 2, 4)
            .reshape(b, s_q, h, d).to(q.dtype))


def _cache_parts(cache) -> tuple[torch.Tensor, torch.Tensor | None, int]:
    """(values or codes, scales, kind) of a cache: kind 0 dense, 1 KVQ8,
    2 KVQ4, as ops/cuda/flash_decode.cu numbers them."""
    if isinstance(cache, KVQ4):
        return cache.qs, cache.scale, 2
    if isinstance(cache, KVQ8):
        return cache.qs, cache.scale, 1
    return cache, None, 0


def _check(q, k, v, positions, name: str) -> None:
    """Raise on what the kernels do not take. k and v are dense tensors of
    q's dtype or, for `flash_decode`, both KVQ8 or both KVQ4."""
    (kx, ks, kind), (vx, vs, vkind) = _cache_parts(k), _cache_parts(v)
    if kind != vkind:
        raise ValueError(f"{name}: k and v must be caches of one kind")
    tensors = [kx, vx, positions] + ([ks, vs] if kind else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError(f"{name}: q, k, v and positions must share a device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16 (got {q.dtype})")
    if kind == 0 and (kx.dtype != q.dtype or vx.dtype != q.dtype):
        raise ValueError(f"{name}: q, k and v must all be float32 or all bfloat16 "
                         f"(got {q.dtype}, {kx.dtype}, {vx.dtype})")
    if q.dim() != 4 or kx.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"{name}: q (B, S, H, D), k and v (B, T, KVH, D)")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} against k {tuple(k.shape)}")
    if d not in (64, 128):
        raise ValueError(f"{name}: head_dim {d} (the kernel takes 64 or 128)")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError(f"{name}: q must be contiguous and 16-byte aligned")
    for x in (kx, vx):
        esz = x.element_size()
        if x.stride(3) != 1 or x.stride(2) != x.shape[3]:
            raise ValueError(f"{name}: each cache cell (KVH, D) must be contiguous")
        if x.data_ptr() % 16 or (x.stride(0) * esz) % 16 or (x.stride(1) * esz) % 16:
            raise ValueError(f"{name}: cache rows must be 16-byte aligned")
    if kind:
        for x in (ks, vs):
            if x.dtype != torch.float32 or tuple(x.shape) != tuple(k.shape[:3]) + (1,) \
                    or x.stride(2) != 1:
                raise ValueError(f"{name}: scales must be f32 (B, T, KVH, 1), KVH contiguous")
    if positions.dtype != torch.int32 or positions.shape != (b, s) \
            or not positions.is_contiguous():
        raise ValueError(f"{name}: positions must be a contiguous (B, S) int32 tensor")


_done: dict[tuple[int, int], torch.Tensor] = {}


def _done_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The arrival counters of one stream's decode launches: one int32 per
    (batch row, KV head, row tile), zero between launches (the kernel wraps
    each back to 0)."""
    key = (device.index or 0, stream)
    buf = _done.get(key)
    if buf is None or buf.numel() < n:
        buf = _done[key] = torch.zeros(max(4096, n), dtype=torch.int32, device=device)
    return buf


def _decode_lib():
    fn = nvcc.load(DECODE_SOURCE).prima_flash_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _prefill_lib():
    fn = nvcc.load(PREFILL_SOURCE).prima_flash_prefill
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 4
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_decode(q: torch.Tensor, k, v, positions: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Decode attention (s_q <= 8) reading only the visible KV prefix. k
    and v are dense tensors of q's dtype, or both KVQ8 or both KVQ4, whose
    codes and scales the kernel reads as they are. CUDA tensors launch the
    kernel (or raise); CPU tensors take `flash_decode_plain`."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, positions, scale)
    _check(q, k, v, positions, "flash_decode")
    b, s, h, d = q.shape
    if s > 8:
        raise ValueError(f"flash_decode: {s} query rows a batch row (at most 8)")
    t, n_kv = k.shape[1], k.shape[2]
    (kx, ks, kind), (vx, vs, _) = _cache_parts(k), _cache_parts(v)
    rows = (h // n_kv) * s
    n_split, split_len = decode_split(b, s, h, n_kv, t, q.dtype)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part_acc = part_ml = done = None
    if n_split > 1:
        part_acc = torch.empty((b * n_kv, n_split, rows, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b * n_kv, n_split, rows, 2), dtype=torch.float32,
                              device=q.device)
        done = _done_counters(q.device, stream,
                              b * n_kv * -(-rows // decode_rows_per_block(rows, q.dtype)))
    ptr = lambda a: None if a is None else a.data_ptr()
    sstr = lambda a: (0, 0) if a is None else (a.stride(0), a.stride(1))
    rc = _decode_lib()(
        q.data_ptr(), kx.data_ptr(), vx.data_ptr(), ptr(ks), ptr(vs), positions.data_ptr(),
        out.data_ptr(), ptr(part_acc), ptr(part_ml), ptr(done),
        int(q.dtype == torch.bfloat16), kind, d, b, s, h, n_kv, t,
        kx.stride(0) * kx.element_size(), kx.stride(1) * kx.element_size(),
        vx.stride(0) * vx.element_size(), vx.stride(1) * vx.element_size(),
        *sstr(ks), *sstr(vs), decode_kv_blk(t), split_len, n_split, float(scale), stream)
    nvcc.check(rc, "flash_decode launch")
    decode_launches.count += 1
    return out


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, scale: float,
                  n_split: int | None = None) -> torch.Tensor:
    """Prefill attention (any s_q). CUDA tensors launch the kernel (or
    raise): tensor cores for bf16, CUDA cores for f32, the KV axis split
    over `prefill_n_split` blocks unless `n_split` says otherwise. CPU
    tensors take `flash_prefill_plain`."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, positions, scale)
    _check(q, k, v, positions, "flash_prefill")
    b, s, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    if n_split is None:
        n_split = prefill_n_split(b, s, h, n_kv, t, prefill_tile(q.dtype))
    if not 1 <= n_split <= 64:
        raise ValueError(f"flash_prefill: n_split {n_split}")
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if n_split > 1:
        rows = (h // n_kv) * s
        part_acc = torch.empty((b * n_kv, n_split, rows, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b * n_kv, n_split, rows, 2), dtype=torch.float32,
                              device=q.device)
    ptr = lambda a: None if a is None else a.data_ptr()
    rc = _prefill_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(), out.data_ptr(),
        ptr(part_acc), ptr(part_ml), int(q.dtype == torch.bfloat16), d, b, s, h, n_kv, t,
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), n_split, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    nvcc.check(rc, "flash_prefill launch")
    prefill_launches.count += 1
    return out


def flash_attention(q: torch.Tensor, k, v, positions: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Causal GQA attention from absolute positions: s_q <= 8 goes to
    `flash_decode`, longer chunks to `flash_prefill` (attention_pallas.py
    flash_attention). k and v are the caches as they are stored: dense, KVQ8
    or KVQ4. The decode kernel reads a quantized cache's codes; the prefill
    kernel, and a dense cache of another dtype than q's, get the
    materialized `to(q.dtype)` copy."""
    if q.shape[1] <= 8:
        if not is_quantized(k):
            k, v = k.to(q.dtype), v.to(q.dtype)
        return flash_decode(q, k, v, positions, scale)
    return flash_prefill(q, k.to(q.dtype), v.to(q.dtype), positions, scale)
