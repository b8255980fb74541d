"""One-call model loading: GGUF -> (config, params, tokenizer).

Counterpart of prima_tpu/models/loader.py for a single device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import resolve_device
from ..gguf.reader import GGUFModel
from ..tokenizer import Tokenizer
from .config import ModelConfig
from .llama import load_params


@dataclass
class LoadedModel:
    cfg: ModelConfig
    params: dict
    tokenizer: Tokenizer
    gguf: GGUFModel

    @property
    def eog_ids(self) -> set[int]:
        v = self.tokenizer.vocab
        return {t for t in (v.eos_id, v.eot_id, v.eom_id) if t >= 0}


def parse_kv_override(spec: str) -> tuple[str, object]:
    """--override-kv KEY=TYPE:VALUE (types int, float, bool, str)."""
    key, _, rest = spec.partition("=")
    typ, _, val = rest.partition(":")
    if not key or not typ or _ != ":":
        raise ValueError(f"invalid KV override {spec!r} (expected KEY=TYPE:VALUE)")
    if typ == "int":
        return key, int(val)
    if typ == "float":
        return key, float(val)
    if typ == "bool":
        if val not in ("true", "false"):
            raise ValueError(f"invalid bool {val!r} in {spec!r}")
        return key, val == "true"
    if typ == "str":
        return key, val
    raise ValueError(f"invalid type {typ!r} in {spec!r} (int/float/bool/str)")


def load_model(path: str, device=None, dtype=torch.bfloat16, fuse: bool = False,
               kv_overrides: dict | None = None) -> LoadedModel:
    """Load a GGUF model onto `device` (CUDA unless told otherwise)."""
    device = resolve_device(device)
    m = GGUFModel.open(path)
    if kv_overrides:  # --override-kv: patch metadata before config parse
        m.metadata.update(kv_overrides)
    cfg = ModelConfig.from_gguf(m)
    params = load_params(m, cfg, device, dtype=dtype, fuse=fuse)
    return LoadedModel(cfg, params, Tokenizer.from_gguf(m), m)
