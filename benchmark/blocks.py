"""GGUF tensor content made from a seed: raw blocks in ggml's layouts.

Each tensor's bytes are a pure function of (seed, tensor name, type, shape):
the harness hands them to the program's loader and the reference makes
them again for itself, so neither side takes anything from the other.
They are made on the device the caller names with a `torch.Generator`,
in a few large calls.

The quantized blocks are centred: every sub-block's minimum is set so that
its weights have mean zero, and the scales are drawn so that a tensor's
weights have an RMS of about `WEIGHT_RMS`. With uncentred weights every
hidden state shares one direction, and a random router sends every row to
the same two experts.

Layouts (ggml-common.h, little-endian):
  Q4_K  144 B / 256: d f16, dmin f16, scales[12] (6-bit sc and m of 8
        sub-blocks of 32), qs[128] (4-bit)
  Q5_K  176 B / 256: d, dmin, scales[12], qh[32] (5th bits), qs[128]
  Q6_K  210 B / 256: ql[128], qh[64], scales[16] (int8), d f16
  Q5_0   22 B / 32:  d f16, qh[4] (5th bits), qs[16] (4-bit: element j in
        the low nibble of qs[j], j + 16 in its high nibble)
  Q8_0   34 B / 32:  d f16, qs[32] (int8)
(Q5_0 is what llama-quantize gives a Q4_K tensor whose rows are not whole
blocks of 256.)
"""

from __future__ import annotations

import hashlib

import torch

WEIGHT_RMS = 0.02

# ggml type ids (ggml.h) and (block elements, block bytes)
F32, F16, Q5_0, Q8_0, Q4_K, Q5_K, Q6_K = 0, 1, 6, 8, 12, 13, 14
TYPE_IDS = {"F32": F32, "F16": F16, "Q5_0": Q5_0, "Q8_0": Q8_0, "Q4_K": Q4_K,
            "Q5_K": Q5_K, "Q6_K": Q6_K}
BLOCK = {F32: (1, 4), F16: (1, 2), Q5_0: (32, 22), Q8_0: (32, 34), Q4_K: (256, 144),
         Q5_K: (256, 176), Q6_K: (256, 210)}

# 6-bit sub-block scale codes and the quant offset that centres them:
# w = d * sc * q - dmin * m with m = sc and dmin = d * centre
_KQUANT = {Q4_K: (16, 63, 7.5, 4.6098), Q5_K: (8, 31, 15.5, 9.2331)}


def row_bytes(ggml_type: int, k: int) -> int:
    """Bytes of one row of k weights."""
    n, b = BLOCK[ggml_type]
    if k % n:
        raise ValueError(f"row of {k} is not whole blocks of {n}")
    return k // n * b


def tensor_seed(seed: int, name: str) -> int:
    """The generator seed of one tensor: a hash of the run's seed and the
    tensor's name, so each tensor can be made alone and in any order."""
    h = hashlib.blake2b(f"{int(seed)}/{name}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & (2 ** 63 - 1)


def _gen(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(tensor_seed(seed, name))
    return g


def _f16_bytes(x: torch.Tensor) -> torch.Tensor:
    """f32 (n,) -> its f16 bits as (n, 2) uint8, little-endian."""
    return x.to(torch.float16).view(torch.uint8).reshape(-1, 2)


def _uniform(g, n: int, lo: float, hi: float, device) -> torch.Tensor:
    return torch.rand(n, generator=g, device=device) * (hi - lo) + lo


def _ints(g, n: int, lo: int, hi: int, device) -> torch.Tensor:
    """n integers in [lo, hi] as int32."""
    return torch.randint(lo, hi + 1, (n,), generator=g, device=device, dtype=torch.int32)


def _code_rms(lo: int, hi: int) -> float:
    """RMS of an integer drawn evenly from [lo, hi]."""
    sq = (hi * (hi + 1) * (2 * hi + 1) - (lo - 1) * lo * (2 * lo - 1)) / 6
    return (sq / (hi - lo + 1)) ** 0.5


def _kquant_scales(sc: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """6-bit codes sc, m (n, 8) -> the 12 packed bytes of get_scale_min_k4."""
    s = torch.empty((sc.shape[0], 12), dtype=torch.int32, device=sc.device)
    s[:, 0:4] = sc[:, 0:4] | ((sc[:, 4:8] >> 4) << 6)
    s[:, 4:8] = m[:, 0:4] | ((m[:, 4:8] >> 4) << 6)
    s[:, 8:12] = (sc[:, 4:8] & 15) | ((m[:, 4:8] & 15) << 4)
    return s.to(torch.uint8)


def make_blocks(seed: int, name: str, ggml_type: int, shape: tuple, device) -> torch.Tensor:
    """The raw bytes of tensor `name`: (rows, row_bytes) uint8 on `device`
    for a quantized type, shape (..., k) with k the GGUF row length. F32
    tensors are not blocks: see `make_dense`."""
    k = shape[-1]
    rows = 1
    for s in shape[:-1]:
        rows *= s
    nb = rows * (k // BLOCK[ggml_type][0])
    g = _gen(seed, name, device)
    raw = torch.randint(0, 256, (nb, BLOCK[ggml_type][1]), generator=g, device=device,
                        dtype=torch.uint8)
    if ggml_type in _KQUANT:
        lo, hi, centre, q_rms = _KQUANT[ggml_type]
        sc = _ints(g, nb * 8, lo, hi, device).reshape(nb, 8)
        d = (WEIGHT_RMS / (_code_rms(lo, hi) * q_rms) * _uniform(g, nb, 0.75, 1.25, device)
             ).to(torch.float16).float()
        raw[:, 0:2] = _f16_bytes(d)
        raw[:, 2:4] = _f16_bytes(d * centre)
        raw[:, 4:16] = _kquant_scales(sc, sc)
    elif ggml_type == Q6_K:
        # int8 scales of either sign in [4, 15]; q - 32 over 0..63 has RMS 18.48
        mag = _ints(g, nb * 16, 4, 15, device)
        sign = _ints(g, nb * 16, 0, 1, device) * 2 - 1
        raw[:, 192:208] = (mag * sign).to(torch.int8).view(torch.uint8).reshape(nb, 16)
        d = WEIGHT_RMS / (_code_rms(4, 15) * 18.476) * _uniform(g, nb, 0.75, 1.25, device)
        raw[:, 208:210] = _f16_bytes(d)
    elif ggml_type == Q8_0:
        d = WEIGHT_RMS / 73.9 * _uniform(g, nb, 0.75, 1.25, device)
        raw[:, 0:2] = _f16_bytes(d)
    elif ggml_type == Q5_0:
        # q - 16 over -16..15 has mean -1/2: scales of either sign centre it
        sign = _ints(g, nb, 0, 1, device) * 2 - 1
        d = sign * WEIGHT_RMS / _code_rms(-16, 15) * _uniform(g, nb, 0.75, 1.25, device)
        raw[:, 0:2] = _f16_bytes(d)
    else:
        raise ValueError(f"no block maker for ggml type {ggml_type}")
    return raw.reshape(rows, -1)


def make_dense(seed: int, name: str, kind: str, shape: tuple, device) -> torch.Tensor:
    """An f32 tensor: "norm" weights in [0.8, 1.2], "bias" N(0, 0.05^2),
    "router" N(0, WEIGHT_RMS^2)."""
    g = _gen(seed, name, device)
    n = 1
    for s in shape:
        n *= s
    if kind == "norm":
        x = _uniform(g, n, 0.8, 1.2, device)
    elif kind == "bias":
        x = torch.randn(n, generator=g, device=device) * 0.05
    elif kind == "router":
        x = torch.randn(n, generator=g, device=device) * WEIGHT_RMS
    else:
        raise ValueError(f"unknown dense kind {kind!r}")
    return x.reshape(shape)
