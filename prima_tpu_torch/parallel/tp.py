"""Tensor parallelism: Megatron-style sharding of one transformer layer.

Counterpart of prima_tpu/parallel/tp.py: every layer splits inside its
stage's tp ranks,

  row-parallel    (output features sharded): wq, wk, wv, w_gate, w_up and
                  the q / k / v / up biases: attention heads and FFN
                  columns are local
  column-parallel (input features sharded): wo, w_down: partial outputs,
                  summed over the tp group once per block

Output-side biases (bo, b_down) and the norms stay replicated; the biases
are added after the sum (models/llama.py: `_tp_sum`). A layer splits on
the host (`shard_layer_uq`, byte for byte the JAX split) or, made on the
card, there (`shard_layer`).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..models.config import ModelConfig
from ..quant.device_format import UQTensor
from ..quant.qtensor import QTensor
from .sharding import (shard_qtensor_cols, shard_qtensor_rows, shard_uq_cols,
                       shard_uq_rows)

# layer-weight name -> how it shards over tp
ROW_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up")
COL_PARALLEL = ("wo", "w_down")
ROW_PARALLEL_DENSE = ("bq", "bk", "bv", "b_up")


def tp_local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Per-shard view of the model: heads divided over tp ranks."""
    if tp == 1:
        return cfg
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(
            f"n_heads={cfg.n_heads}/n_kv_heads={cfg.n_kv_heads} not divisible by tp={tp}")
    return replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp)


def shard_layer_uq(layer: dict, tp: int) -> list[dict]:
    """Split one layer's host tensors into `tp` shard dicts."""
    shards: list[dict] = [{} for _ in range(tp)]
    for name, t in layer.items():
        if t is None:
            continue
        if isinstance(t, UQTensor):
            if name in ROW_PARALLEL:
                parts = shard_uq_rows(t, tp)
            elif name in COL_PARALLEL:
                parts = shard_uq_cols(t, tp)
            else:
                raise KeyError(f"unknown quantized layer tensor {name!r}")
            for i in range(tp):
                shards[i][name] = parts[i]
        else:
            a = np.asarray(t)
            if name in ROW_PARALLEL_DENSE or name in ROW_PARALLEL:
                parts = np.split(a, tp, axis=0)
            elif name in COL_PARALLEL:
                parts = np.split(a, tp, axis=1)
            else:  # norms: replicated
                parts = [a] * tp
            for i in range(tp):
                shards[i][name] = parts[i]
    return shards


def shard_layer(layer: dict, tp: int, i: int) -> dict:
    """Shard i of a layer whose tensors are on a device (QTensors and
    dense tensors), by the same tables."""
    if tp == 1:
        return layer
    out = {}
    for name, t in layer.items():
        if t is None:
            continue
        if isinstance(t, QTensor):
            if name in ROW_PARALLEL:
                out[name] = shard_qtensor_rows(t, tp, i)
            elif name in COL_PARALLEL:
                out[name] = shard_qtensor_cols(t, tp, i)
            else:
                raise KeyError(f"unknown quantized layer tensor {name!r}")
        elif name in ROW_PARALLEL_DENSE or name in ROW_PARALLEL:
            out[name] = torch.chunk(t, tp, dim=0)[i].contiguous()
        elif name in COL_PARALLEL:
            out[name] = torch.chunk(t, tp, dim=1)[i].contiguous()
        else:
            out[name] = t
    return out
