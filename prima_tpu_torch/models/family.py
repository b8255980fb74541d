"""What the dense family runtimes (deepseek2 / minicpm3, mamba, rwkv6, t5)
share: GGUF tensors dequantized on the host into dense tensors on one
device, and the config, params, tokenizer and end-of-generation ids that
each runtime's `load` reads, as each JAX runtime's `load` reads them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..gguf.reader import GGUFModel
from ..quant.dequant_np import dequantize_tensor


def dense_getter(m: GGUFModel, dtype, device):
    """get(name, required=True, flat=False) -> the tensor dequantized on the
    host, dense in `dtype` on `device` (flattened to 1-D when `flat`), or
    None for a missing optional tensor."""

    def get(name: str, required: bool = True, flat: bool = False):
        ti = m.tensors.get(name)
        if ti is None:
            if required:
                raise KeyError(f"missing tensor {name}")
            return None
        x = dequantize_tensor(ti).astype(np.float32)
        if flat:
            x = x.reshape(-1)
        return torch.from_numpy(x).to(device=device, dtype=dtype)

    return get


def open_runtime(path: str, config_cls, load_params, dtype, device) -> tuple:
    """(device, cfg, params, tokenizer or None, eog ids) of the GGUF at
    `path`; `device` is resolved (CUDA by default, raising without a GPU)."""
    from ..tokenizer import Tokenizer

    device = resolve_device(device)
    m = GGUFModel.open(path)
    cfg = config_cls.from_gguf(m)
    params = load_params(m, cfg, dtype, device)
    try:
        tok = Tokenizer.from_gguf(m)
    except Exception:
        tok = None
    eog = set()
    eos = m.get("tokenizer.ggml.eos_token_id")
    if eos is not None:
        eog.add(int(eos))
    m.close()
    return device, cfg, params, tok, eog


def tokens_tensor(tokens, device) -> torch.Tensor:
    """Token ids (a list, a numpy array or a tensor of shape (b, s)) as an
    int64 tensor on `device`."""
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=device)
