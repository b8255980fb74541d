"""Model cost model: per-layer FLOPs, bytes, and KV sizes by weight dtype.

A copy of prima_tpu/profiler/model_cost.py (host-side only): the port keeps its own.

The analogue of llama_model_n_flops (reference src/llama.cpp:22144: dry
tensor walk counting FLOPs per dtype by matching `blk.N.` tensor names),
llama_model_compute_buf_size (@21930) and llama_kv_size (@22117) — the
inputs the layer-assignment solver consumes.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

from ..gguf.constants import GGMLType, TYPE_TRAITS
from ..models.config import ModelConfig

_BLK = re.compile(r"^blk\.(\d+)\.")


@dataclass
class ModelCost:
    n_layers: int
    # per-LAYER matmul FLOPs by weight ggml dtype (one token)
    layer_flops: dict[int, float] = field(default_factory=dict)
    # embedding + output head FLOPs (rank-0 work)
    head_flops: dict[int, float] = field(default_factory=dict)
    # bytes of one layer's weights (quantized, as stored on device)
    layer_bytes: int = 0
    head_bytes: int = 0
    largest_tensor_bytes: int = 0
    n_params: int = 0
    # per-layer KV bytes for a given context (filled by kv_bytes())
    n_embd_k_gqa: int = 0
    n_embd_v_gqa: int = 0
    # model dims for the activation-buffer bound
    n_embd: int = 0
    n_ff: int = 0
    n_heads: int = 0
    n_vocab: int = 0

    def kv_bytes_per_layer(self, n_ctx: int, bytes_per_el: float = 2.0) -> float:
        """llama_kv_size analogue: 2 * (k_gqa + v_gqa) * ctx * elsize / 2."""
        return (self.n_embd_k_gqa + self.n_embd_v_gqa) * n_ctx * bytes_per_el

    def compute_buf_bytes(self, n_ctx: int, n_ubatch: int = 1,
                          is_master: bool = True,
                          xla_dequant: bool = False) -> float:
        """Activation-buffer upper bound per decode step — the TPU analogue
        of llama_model_compute_buf_size's per-tensor accounting (reference
        src/llama.cpp:21930-22095): residual/norm/qcur streams, the
        attention score matrix (n_ctx*B*heads, the n_kq term), the KQ mask,
        and the live peak of {ffn gate+up} vs {q,q,kq}; the master adds the
        io tensors (input ids, embeddings, out_embd, vocab logits —
        @21963-21965). XLA's buffer assignment reuses everything else.

        xla_dequant adds the largest materialized dequant scratch (only the
        non-Pallas fallback path materializes weights in HBM)."""
        f32 = 4
        e = self.n_embd or max(self.n_embd_k_gqa * 4, 1)
        f = self.n_ff or 4 * e
        h = self.n_heads or max(e // 128, 1)
        B = n_ubatch
        n_kq = n_ctx * B * h
        n_mask = n_ctx * B
        buf = (3 * e * B + n_mask) * f32  # bak_embd + norm + qcur + mask
        buf += max(2 * f * B, 2 * e * B + n_kq) * f32
        if is_master:
            vocab = self.n_vocab or 32000
            buf += (B + 2 * e * B + vocab * B) * f32
        if xla_dequant:
            buf += self.largest_tensor_bytes
        return float(buf)

    def total_flops(self) -> float:
        return sum(self.layer_flops.values()) * self.n_layers + sum(self.head_flops.values())

    def layer_seconds(self, profile) -> float:
        """Per-layer per-token latency on a device profile: the max of the
        compute-bound and HBM-bound estimates (decode is bandwidth-bound on
        TPU, so the byte term usually dominates)."""
        t_flops = 0.0
        for gt, fl in self.layer_flops.items():
            tflops = _dtype_tflops(profile, gt)
            if tflops > 0:
                t_flops += fl / (tflops * 1e12)
        t_mem = self.layer_bytes / (profile.hbm_bw * 1e9) if profile.hbm_bw else 0.0
        return max(t_flops, t_mem)

    def layer_stream_seconds(self, profile) -> float:
        """Per-layer latency when weights stream host RAM -> HBM each visit."""
        if profile.h2d_bw <= 0:
            return float("inf")
        return self.layer_bytes / (profile.h2d_bw * 1e9)

    def head_seconds(self, profile) -> float:
        t = 0.0
        for gt, fl in self.head_flops.items():
            tflops = _dtype_tflops(profile, gt)
            if tflops > 0:
                t += fl / (tflops * 1e12)
        t_mem = self.head_bytes / (profile.hbm_bw * 1e9) if profile.hbm_bw else 0.0
        return max(t, t_mem)


def _dtype_tflops(profile, gt: int) -> float:
    t = GGMLType(gt)
    if t in (GGMLType.F32,):
        return profile.flops_f32
    if t in (GGMLType.F16, GGMLType.BF16):
        return profile.flops_bf16
    # quantized: fused dequant-matmul path; fall back to bf16 estimate
    return profile.flops_q4k_dequant or profile.flops_bf16


def model_cost_from_gguf(m) -> ModelCost:
    """Dry tensor walk over a GGUFModel (no data read)."""
    cfg = ModelConfig.from_gguf(m)
    cost = ModelCost(n_layers=cfg.n_layers,
                     n_embd_k_gqa=cfg.n_embd_k_gqa, n_embd_v_gqa=cfg.n_embd_v_gqa,
                     n_embd=cfg.n_embd, n_ff=cfg.n_ff, n_heads=cfg.n_heads,
                     n_vocab=cfg.n_vocab)
    layer_flops: dict[int, float] = defaultdict(float)
    head_flops: dict[int, float] = defaultdict(float)
    layer_bytes = 0
    seen_layer0 = False
    for name, ti in m.tensors.items():
        nb = ti.nbytes
        cost.n_params += ti.n_elements
        cost.largest_tensor_bytes = max(cost.largest_tensor_bytes, nb)
        blk = _BLK.match(name)
        is_matmul = ti.ne[0] > 1 and len([d for d in ti.ne if d > 1]) >= 2
        fl = 2.0 * ti.n_elements if is_matmul else 0.0
        if blk:
            if int(blk.group(1)) == 0:
                seen_layer0 = True
                layer_bytes += nb
                if fl:
                    layer_flops[int(ti.ggml_type)] += fl
        else:
            cost.head_bytes += nb
            if fl:
                head_flops[int(ti.ggml_type)] += fl
    assert seen_layer0, "no blk.0.* tensors found"
    cost.layer_bytes = layer_bytes
    cost.layer_flops = dict(layer_flops)
    cost.head_flops = dict(head_flops)
    return cost


def model_cost_from_config(cfg: ModelConfig, ggml_type: GGMLType = GGMLType.Q4_K) -> ModelCost:
    """Synthetic cost model from a ModelConfig (benchmarks, tests)."""
    tt = TYPE_TRAITS[ggml_type]
    bpw = tt.type_size / tt.block_size  # bytes per weight as stored
    e, h, kvh, hd, f = cfg.n_embd, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_ff
    layer_params = e * hd * (h + 2 * kvh) + h * hd * e + 3 * e * f
    head_params = cfg.n_vocab * e * (1 if cfg.tie_embeddings else 2)
    cost = ModelCost(
        n_layers=cfg.n_layers,
        layer_flops={int(ggml_type): 2.0 * layer_params},
        head_flops={int(ggml_type): 2.0 * cfg.n_vocab * e},
        layer_bytes=int(layer_params * bpw * 1.4),  # uniform layout overhead
        head_bytes=int(head_params * bpw * 1.4),
        largest_tensor_bytes=int(max(e * f, cfg.n_vocab * e) * bpw),
        n_params=layer_params * cfg.n_layers + head_params,
        n_embd_k_gqa=cfg.n_embd_k_gqa,
        n_embd_v_gqa=cfg.n_embd_v_gqa,
        n_embd=e, n_ff=f, n_heads=h, n_vocab=cfg.n_vocab,
    )
    return cost
