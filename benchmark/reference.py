"""The plain reference: the decoder in float32 PyTorch, from the blocks up.

It imports nothing of the program. It makes each tensor's blocks again
from (seed, name) (blocks.py), dequantizes them with its own dequantizers,
written from ggml's block layouts (ggml-quants.c dequantize_row_*), and
runs llama.cpp's decoder over whole sequences with no cache: the token
embedding, each layer as the configuration's architecture file gives it
(archs/<arch>.py `block`, built from the helpers here: RMSNorm, RoPE,
causal grouped-query attention, SwiGLU, and for a mixture of experts the
softmax router, its top-k and the weighted sum of the chosen experts),
the output norm and the head. TF32 is switched off: every product is f32.

It runs layer by layer, so that one layer's weights in f32 are all it
holds besides the hidden states.

`precision="fp8"` is the control: every linear layer's input and weight
(`linear`) rounded to float8 e4m3 with a scale a row, as an fp8 GEMM would
take them, and multiplied in f32; the router, norms and attention stay
f32. `precision="bf16"` rounds the same operands, and the hidden state
after each layer, to bfloat16: the sensitivity of the model itself to the
precision the configuration states (a reading beside the control).
"""

from __future__ import annotations

import math

import torch

from . import spec
from .blocks import F32, Q4_K, Q5_0, Q5_K, Q6_K, Q8_0, make_blocks, make_dense
from .layout import Tensor, tensor_table

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def _f16(raw: torch.Tensor) -> torch.Tensor:
    """(nb, 2) uint8 little-endian f16 bits -> (nb, 1) f32."""
    return raw.contiguous().view(torch.float16).float()


def _scale_min_k4(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """get_scale_min_k4 over the 12 scale bytes (nb, 12) -> sc, m (nb, 8)."""
    s = s.int()
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 15) | ((s[:, 0:4] >> 6) << 4)], 1)
    m = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], 1)
    return sc.float(), m.float()


def dequant_q4_k(raw: torch.Tensor) -> torch.Tensor:
    """(nb, 144) -> (nb, 256): y = d*sc_j * q - dmin*m_j, sub-block j of 32;
    each 32-byte chunk c holds sub-block 2c in its low and 2c+1 in its high
    nibbles."""
    d, dmin = _f16(raw[:, 0:2]), _f16(raw[:, 2:4])
    sc, m = _scale_min_k4(raw[:, 4:16])
    qs = raw[:, 16:144].reshape(-1, 4, 32).int()
    q = torch.stack([qs & 15, qs >> 4], 2).reshape(-1, 8, 32).float()
    return ((d * sc)[:, :, None] * q - (dmin * m)[:, :, None]).reshape(-1, 256)


def dequant_q5_k(raw: torch.Tensor) -> torch.Tensor:
    """(nb, 176) -> (nb, 256): Q4_K's nibbles plus a fifth bit from qh,
    bit 2c for sub-block 2c and bit 2c+1 for 2c+1."""
    d, dmin = _f16(raw[:, 0:2]), _f16(raw[:, 2:4])
    sc, m = _scale_min_k4(raw[:, 4:16])
    qh = raw[:, 16:48].int()  # (nb, 32)
    qs = raw[:, 48:176].reshape(-1, 4, 32).int()
    bits = torch.arange(8, device=raw.device).reshape(1, 4, 2, 1)  # bit of sub-block 2c + i
    hi = ((qh[:, None, None, :] >> bits) & 1) * 16  # (nb, 4, 2, 32)
    q = (torch.stack([qs & 15, qs >> 4], 2) + hi).reshape(-1, 8, 32).float()
    return ((d * sc)[:, :, None] * q - (dmin * m)[:, :, None]).reshape(-1, 256)


def dequant_q6_k(raw: torch.Tensor) -> torch.Tensor:
    """(nb, 210) -> (nb, 256): two halves of 128; in half n, for l < 32,
    y[l + 32 i] = d * sc[8n + l//16 + 2i] * (q_i - 32) with q_0 / q_1 the
    low nibbles of ql[l] / ql[l + 32], q_2 / q_3 their high nibbles, and
    bits 2i..2i+1 of qh[l] on top."""
    ql = raw[:, 0:128].reshape(-1, 2, 2, 32).int()  # (nb, half, l / l+32, 32)
    qh = raw[:, 128:192].reshape(-1, 2, 1, 32).int()
    sc = raw[:, 192:208].contiguous().view(torch.int8).float().reshape(-1, 2, 8)
    d = _f16(raw[:, 208:210])
    low = ql & 15  # (nb, 2, 2, 32): i = 0, 1
    high = ql >> 4  # i = 2, 3
    nib = torch.cat([low, high], 2)  # (nb, 2, 4, 32), i = 0..3
    shifts = (2 * torch.arange(4, device=raw.device)).reshape(1, 1, 4, 1)
    q = (nib | (((qh >> shifts) & 3) << 4)) - 32  # (nb, 2, 4, 32)
    # scale index: 8n + l // 16 + 2 i
    idx = (torch.arange(32, device=raw.device) // 16)[None, :] + 2 * torch.arange(
        4, device=raw.device)[:, None]  # (4, 32)
    s = sc[:, :, idx]  # (nb, 2, 4, 32)
    return ((d[:, :, None, None] * s) * q.float()).reshape(-1, 256)


def dequant_q5_0(raw: torch.Tensor) -> torch.Tensor:
    """(nb, 22) -> (nb, 32): y = d * (q - 16), q element l's nibble (the low
    one of qs[l] for l < 16, the high one of qs[l - 16] above) with bit l
    of qh as its fifth bit."""
    qs = raw[:, 6:22].int()
    nib = torch.cat([qs & 15, qs >> 4], 1)  # (nb, 32)
    l = torch.arange(32, device=raw.device)
    hi = (raw[:, 2:6].int()[:, l // 8] >> (l % 8)) & 1
    return _f16(raw[:, 0:2]) * ((nib | (hi << 4)) - 16).float()


def dequant_q8_0(raw: torch.Tensor) -> torch.Tensor:
    """(nb, 34) -> (nb, 32): y = d * q."""
    return _f16(raw[:, 0:2]) * raw[:, 2:34].contiguous().view(torch.int8).float()


DEQUANT = {Q4_K: dequant_q4_k, Q5_K: dequant_q5_k, Q6_K: dequant_q6_k, Q5_0: dequant_q5_0,
           Q8_0: dequant_q8_0}
_BLOCK_BYTES = {Q4_K: 144, Q5_K: 176, Q6_K: 210, Q5_0: 22, Q8_0: 34}


def weight(seed: int, t: Tensor, device) -> torch.Tensor:
    """Tensor t in f32, in its numpy shape."""
    if t.ggml_type == F32:
        return make_dense(seed, t.name, t.dense, t.shape, device)
    raw = make_blocks(seed, t.name, t.ggml_type, t.shape, device)
    w = DEQUANT[t.ggml_type](raw.reshape(-1, _BLOCK_BYTES[t.ggml_type]))
    return w.reshape(t.shape)


def _fp8(a: torch.Tensor) -> torch.Tensor:
    """a rounded to float8 e4m3 with one scale a row (amax maps to 448)."""
    s = a.abs().amax(-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (a / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ w^T with both operands at `precision` (the control rounds here)."""
    if precision == "fp8":
        x, w = _fp8(x), _fp8(w)
    elif precision == "bf16":
        x, w = x.bfloat16().float(), w.bfloat16().float()
    return x @ w.t()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, base: float, kind: str) -> torch.Tensor:
    """x (T, heads, d) at positions pos (T,): theta_i = pos * base^(-2i/d).
    NORM rotates the pairs (2i, 2i+1), NEOX the pairs (i, i + d/2)."""
    d = x.shape[-1]
    inv = base ** (-torch.arange(0, d // 2, device=x.device, dtype=torch.float64) * 2 / d)
    th = (pos.double()[:, None] * inv[None]).float()[:, None, :]  # (T, 1, d/2)
    cos, sin = torch.cos(th), torch.sin(th)
    if kind == "norm":
        a, b = x[..., 0::2], x[..., 1::2]
        return torch.stack([a * cos - b * sin, a * sin + b * cos], -1).reshape(x.shape)
    if kind == "neox":
        a, b = x[..., : d // 2], x[..., d // 2:]
        return torch.cat([a * cos - b * sin, a * sin + b * cos], -1)
    raise ValueError(f"unknown rope type {kind!r}")


def _causal(q, k, v, n_kv: int) -> torch.Tensor:
    t, h, d = q.shape
    g = h // n_kv
    k = k.repeat_interleave(g, 1)
    v = v.repeat_interleave(g, 1)
    s = torch.einsum("thd,uhd->htu", q, k) / math.sqrt(d)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("htu,uhd->thd", p, v).reshape(t, -1)


def attention(q, k, v, n_kv: int, lens: list[int]) -> torch.Tensor:
    """Causal GQA within each sequence of `lens` rows, scores over sqrt(d):
    q / k (T, H / KVH, d), v (T, KVH, dv) -> (T, H * dv); dv may differ
    from d (latent attention's values)."""
    return torch.cat([_causal(q[o:o + n], k[o:o + n], v[o:o + n], n_kv)
                      for o, n in zip(_offsets(lens), lens)])


def swiglu(f: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           precision: str) -> torch.Tensor:
    """down(silu(gate(f)) * up(f))."""
    return linear(torch.nn.functional.silu(linear(f, gate, precision))
                  * linear(f, up, precision), down, precision)


class Reference:
    """The model of one configuration and seed on `device`."""

    def __init__(self, cfg: dict, seed: int, device, precision: str = "f32"):
        self.m = cfg["model"]
        self.seed = seed
        self.device = torch.device(device)
        self.precision = precision
        self.arch = spec.arch(self.m)
        self.tensors = {t.name: t for t in tensor_table(self.m, cfg["types"])}
        # the layers whose router runs: routes and router readings are
        # indexed by these alone, in order
        self.moe_layers = [i for i in range(self.m["n_layers"])
                           if f"blk.{i}.ffn_gate_inp.weight" in self.tensors]

    def w(self, name: str) -> torch.Tensor:
        return weight(self.seed, self.tensors[name], self.device)

    @torch.no_grad()
    def logits(self, seqs: list[list[int]], first: list[int],
               routes: list[torch.Tensor] | None = None) -> list[torch.Tensor]:
        """For each token sequence, the f32 logits (len - first, V) at its
        positions first, first + 1, ...: each row predicts the token after.
        `routes`, for a mixture of experts, gives each sequence's experts
        (len, MoE layers, k) to follow instead of its own top-k; the
        weights stay the reference's own softmax at those experts, under
        the layer's weight rule. Where they are followed, each MoE layer's
        `route_rows`, `route_differ` (the rows whose experts it would have
        chosen otherwise) and `route_margins` (the largest margin between
        its own k-th and (k+1)-th probabilities among those) are kept;
        after the call `chosen` holds each sequence's experts as used."""
        m, dev, prec = self.m, self.device, self.precision
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            lens = [len(s) for s in seqs]
            self.routes = None if routes is None else torch.cat(routes).to(dev)
            n = len(self.moe_layers)
            self.route_rows, self.route_differ, self.route_margins = [0] * n, [0] * n, [0.0] * n
            self.chosen = []  # the experts each MoE layer used, (T, k)
            ids = torch.tensor([t for s in seqs for t in s], device=dev)
            x = self.w("token_embd.weight")[ids]
            pos = torch.cat([torch.arange(n, device=dev) for n in lens])
            for i in range(m["n_layers"]):
                x = self.arch.block(self, i, x, pos, lens)
                if prec == "bf16":
                    x = x.bfloat16().float()
            rows = torch.cat([torch.arange(o + f, o + n, device=dev) for o, f, n in
                              zip(_offsets(lens), first, lens)])
            h = rms_norm(x[rows], self.w("output_norm.weight"), m["rms_eps"])
            out = linear(h, self.w("output.weight"), prec)
            if self.chosen:
                routes = torch.stack(self.chosen, 1).cpu()  # (T, MoE layers, k)
                self.chosen = list(routes.split(lens))
            return list(out.split([n - f for n, f in zip(lens, first)]))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def route_mismatch_share(self, layers: int | None = None) -> float:
        """The share of rows and MoE layers, over the first `layers` MoE
        layers or all, whose followed experts differ from the reference's
        own."""
        n = len(self.moe_layers) if layers is None else layers
        return sum(self.route_differ[:n]) / max(sum(self.route_rows[:n]), 1)

    def experts(self, i: int, f: torch.Tensor, norm: bool = True,
                scale: float = 1.0) -> torch.Tensor:
        """The routed experts of layer i over its FFN input f: the f32
        softmax router, its top-k (or the routes followed), and the sum of
        the chosen SwiGLU experts under the softmax at those experts,
        renormalised over them where `norm` (build_llama's MoE branch),
        else as they are, times `scale`. Shared experts are the block's."""
        prec, k, p = self.precision, self.m["n_expert_used"], f"blk.{i}."
        j = self.moe_layers.index(i)
        probs = torch.softmax(f @ self.w(p + "ffn_gate_inp.weight").t(), -1)
        top = torch.topk(probs, k + 1, -1)
        ids = top.indices[:, :k]
        if self.routes is not None:
            forced = self.routes[:, j]
            differ = (ids.sort(-1).values != forced.sort(-1).values).any(-1)
            self.route_differ[j] += int(differ.sum())
            self.route_rows[j] += differ.numel()
            if bool(differ.any()):
                margin = top.values[:, k - 1] - top.values[:, k]
                self.route_margins[j] = max(self.route_margins[j], float(margin[differ].max()))
            ids = forced
        self.chosen.append(ids)
        wts = probs.gather(1, ids)
        if norm:
            wts = wts / wts.sum(-1, keepdim=True)
        if scale != 1.0:
            wts = wts * scale
        gate, up, down = (self.w(p + n) for n in ("ffn_gate_exps.weight", "ffn_up_exps.weight",
                                                  "ffn_down_exps.weight"))
        out = torch.zeros_like(f)
        for e in range(gate.shape[0]):
            rows, slot = (ids == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            ye = swiglu(f[rows], gate[e], up[e], down[e], prec)
            out.index_add_(0, rows, wts[rows, slot, None] * ye)
        return out


def _offsets(lens: list[int]) -> list[int]:
    out, o = [], 0
    for n in lens:
        out.append(o)
        o += n
    return out
