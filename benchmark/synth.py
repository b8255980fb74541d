"""A configuration's GGUF, held in memory and made when read.

`synth_gguf` gives the program's loader what `GGUFModel.open` gives it for
a file: the metadata a GGUF of that model holds, a generated vocabulary of
the model's size, and a tensor table whose entries make their raw blocks
from (seed, name) when they are looked up, so the host holds only the
tensors the loader is converting (q, k and v of a layer at most), and
nothing is written to disk. The blocks are made on `device`.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from prima_tpu_torch.gguf.constants import GGMLType
from prima_tpu_torch.gguf.reader import GGUFModel, TensorInfo

from .blocks import F32, make_blocks, make_dense
from .layout import Tensor, tensor_table

_ALNUM = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"


def vocab_tokens(n: int) -> list[str]:
    """n distinct tokens of three printable ASCII letters or digits, so that
    every token decodes to text of its own under both byte-level BPE and
    SentencePiece, and each one streams as an event."""
    b = len(_ALNUM)
    if n > b ** 3:
        raise ValueError(f"{n} tokens do not fit in three characters")
    return [_ALNUM[i // (b * b)] + _ALNUM[i // b % b] + _ALNUM[i % b] for i in range(n)]


class _Tensors(Mapping):
    """name -> TensorInfo whose data is made on each lookup."""

    def __init__(self, table: list[Tensor], seed: int, device):
        self.table = {t.name: t for t in table}
        self.seed = seed
        self.device = torch.device(device)

    def __getitem__(self, name: str) -> TensorInfo:
        t = self.table[name]
        ne = tuple(reversed(t.shape))
        info = TensorInfo(name=name, ne=ne, ggml_type=GGMLType(t.ggml_type), offset=0)
        if t.ggml_type == F32:
            info.data = make_dense(self.seed, name, t.dense, t.shape, self.device).cpu().numpy()
            return info
        raw = make_blocks(self.seed, name, t.ggml_type, t.shape, self.device)
        if raw.device.type != "cpu":
            # pinned host memory, which PyTorch's host allocator hands out
            # again once the loader has dropped the tensor's data
            host = torch.empty(raw.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(raw)
            raw = host
        info.data = raw.numpy()
        return info

    def __iter__(self):
        return iter(self.table)

    def __len__(self) -> int:
        return len(self.table)


def synth_gguf(cfg: dict, seed: int, device) -> GGUFModel:
    """The configuration's GGUF as the loader reads one: a GGUFModel with
    the metadata of cfg["gguf"] and cfg["tokenizer"] and lazily made
    tensors, each made anew on every lookup."""
    m = GGUFModel.__new__(GGUFModel)
    m.readers = []
    meta = dict(cfg["gguf"])
    tok = cfg["tokenizer"]
    n = cfg["model"]["n_vocab"]
    meta.update({
        "tokenizer.ggml.model": tok["model"],
        "tokenizer.ggml.pre": tok["pre"],
        "tokenizer.ggml.tokens": vocab_tokens(n),
        "tokenizer.ggml.token_type": np.ones(n, np.int32),  # all NORMAL
        "tokenizer.ggml.bos_token_id": tok["bos_token_id"],
        "tokenizer.ggml.eos_token_id": tok["eos_token_id"],
        "tokenizer.ggml.add_bos_token": tok["add_bos_token"],
    })
    if tok["model"] == "llama":
        meta["tokenizer.ggml.scores"] = np.zeros(n, np.float32)
    m.metadata = meta
    m.tensors = _Tensors(tensor_table(cfg["model"], cfg["types"]), seed, device)
    return m
