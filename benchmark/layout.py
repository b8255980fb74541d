"""The tensors of a configuration's GGUF: names, shapes and types.

A configuration file (configs/<name>.json) states the model's sizes under
"model" and llama-quantize's type of each tensor under "types"; its
architecture file (archs/<arch>.py) turns them into the tensor table that
both the synthetic GGUF and the reference read. Shapes are numpy's (C
order): the last axis is the GGUF row length ne[0].
"""

from __future__ import annotations

from dataclasses import dataclass

from . import spec
from .blocks import TYPE_IDS


@dataclass(frozen=True)
class Tensor:
    name: str
    shape: tuple
    ggml_type: int
    dense: str | None = None  # make_dense's kind for an F32 tensor


def tensor_type(types: dict, name: str) -> int:
    """The type of `name`: its own entry, else the entry of its suffix after
    "blk.<i>.", a type or a list of one type a layer."""
    if name in types:
        return TYPE_IDS[types[name]]
    parts = name.split(".", 2)
    t = types[parts[2]]
    return TYPE_IDS[t[int(parts[1])] if isinstance(t, list) else t]


def quant(types: dict, name: str, shape: tuple) -> Tensor:
    """A quantized tensor of the type llama-quantize gives `name`."""
    return Tensor(name, shape, tensor_type(types, name))


def tensor_table(model: dict, types: dict) -> list[Tensor]:
    """Every tensor of the model, in the order of a llama.cpp GGUF: its
    architecture file's table (spec.arch)."""
    return spec.arch(model).tensors(model, types)
