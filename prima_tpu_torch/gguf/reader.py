"""GGUF container reader: mmap-backed, zero-copy numpy views.

Parses the GGUF v2/v3 binary container (layout per reference parser
ggml/src/ggml.c:21970-22440): header {magic, version, n_tensors, n_kv},
KV metadata pairs, tensor-info records, then an aligned data section.

Tensor dims are stored in ggml order (ne[0] = innermost / contiguous).
We expose numpy-shaped views: shape == tuple(reversed(ne)), so a matmul
weight with ne=[n_in, n_out] reads as a (n_out, n_in) C-order array whose
rows are the quantized input-dim vectors.

Multi-file split models (split.no / split.count / split.tensors.count KVs,
common/common.h:569-571 in the reference) are handled by `open_split`.
"""

from __future__ import annotations

import mmap
import os
import re
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Iterator

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    Keys,
    TYPE_TRAITS,
    row_nbytes,
)

_SCALAR_FMT = {
    GGUFValueType.UINT8: ("<B", 1),
    GGUFValueType.INT8: ("<b", 1),
    GGUFValueType.UINT16: ("<H", 2),
    GGUFValueType.INT16: ("<h", 2),
    GGUFValueType.UINT32: ("<I", 4),
    GGUFValueType.INT32: ("<i", 4),
    GGUFValueType.FLOAT32: ("<f", 4),
    GGUFValueType.BOOL: ("<B", 1),
    GGUFValueType.UINT64: ("<Q", 8),
    GGUFValueType.INT64: ("<q", 8),
    GGUFValueType.FLOAT64: ("<d", 8),
}

_NP_DTYPE = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
    GGUFValueType.BOOL: np.uint8,
}


@dataclass
class TensorInfo:
    name: str
    ne: tuple[int, ...]  # ggml dim order: ne[0] innermost
    ggml_type: GGMLType
    offset: int  # relative to data section start
    data: np.ndarray | None = None  # raw bytes view (uint8) or typed view for f32/f16

    @property
    def shape(self) -> tuple[int, ...]:
        """numpy (C-order) shape."""
        return tuple(reversed(self.ne))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        tt = TYPE_TRAITS[self.ggml_type]
        # rows along ne[0]; each row is independently blocked
        return self.n_elements // self.ne[0] * row_nbytes(self.ggml_type, self.ne[0])


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise EOFError("truncated GGUF file")
        self.pos += n
        return bytes(b)

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return v

    def read_string(self) -> str:
        n = self.unpack("<Q")
        return self.read(n).decode("utf-8", errors="replace")

    def read_value(self, vtype: GGUFValueType) -> Any:
        if vtype == GGUFValueType.STRING:
            return self.read_string()
        if vtype == GGUFValueType.ARRAY:
            etype = GGUFValueType(self.unpack("<I"))
            count = self.unpack("<Q")
            if etype == GGUFValueType.STRING:
                return [self.read_string() for _ in range(count)]
            if etype == GGUFValueType.ARRAY:
                return [self.read_value(GGUFValueType.ARRAY) for _ in range(count)]
            dt = np.dtype(_NP_DTYPE[etype]).newbyteorder("<")
            nb = dt.itemsize * count
            arr = np.frombuffer(self.read(nb), dtype=dt)
            if etype == GGUFValueType.BOOL:
                arr = arr.astype(bool)
            return arr
        fmt, _ = _SCALAR_FMT[vtype]
        v = self.unpack(fmt)
        if vtype == GGUFValueType.BOOL:
            v = bool(v)
        return v


class GGUFReader:
    """One GGUF file, mmap'd. `tensors` maps name -> TensorInfo with raw views."""

    def __init__(self, path: str | os.PathLike, mmap_file: bool = True):
        self.path = os.fspath(path)
        self._file: BinaryIO = open(self.path, "rb")
        if mmap_file:
            self._mm: Any = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        else:
            self._mm = self._file.read()
        cur = _Cursor(self._mm)

        magic = cur.unpack("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: bad GGUF magic 0x{magic:08x}")
        self.version = cur.unpack("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{self.path}: unsupported GGUF version {self.version}")
        n_tensors = cur.unpack("<q")
        n_kv = cur.unpack("<q")

        self.metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = cur.read_string()
            vtype = GGUFValueType(cur.unpack("<I"))
            self.metadata[key] = cur.read_value(vtype)

        self.tensors: dict[str, TensorInfo] = {}
        order: list[TensorInfo] = []
        for _ in range(n_tensors):
            name = cur.read_string()
            n_dims = cur.unpack("<I")
            ne = tuple(cur.unpack("<Q") for _ in range(n_dims))
            ggml_type = GGMLType(cur.unpack("<I"))
            offset = cur.unpack("<Q")
            ti = TensorInfo(name=name, ne=ne, ggml_type=ggml_type, offset=offset)
            self.tensors[name] = ti
            order.append(ti)

        self.alignment = int(self.metadata.get(Keys.General.ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))
        data_start = cur.pos
        pad = (self.alignment - data_start % self.alignment) % self.alignment
        self.data_offset = data_start + pad

        base = np.frombuffer(self._mm, dtype=np.uint8)
        for ti in order:
            start = self.data_offset + ti.offset
            raw = base[start : start + ti.nbytes]
            ti.data = self._typed_view(ti, raw)

    @staticmethod
    def _typed_view(ti: TensorInfo, raw: np.ndarray) -> np.ndarray:
        t = ti.ggml_type
        if t == GGMLType.F32:
            return raw.view(np.float32).reshape(ti.shape)
        if t == GGMLType.F16:
            return raw.view(np.float16).reshape(ti.shape)
        if t == GGMLType.F64:
            return raw.view(np.float64).reshape(ti.shape)
        if t == GGMLType.BF16:
            return raw.view(np.uint16).reshape(ti.shape)  # caller widens
        if t == GGMLType.I8:
            return raw.view(np.int8).reshape(ti.shape)
        if t == GGMLType.I16:
            return raw.view(np.int16).reshape(ti.shape)
        if t == GGMLType.I32:
            return raw.view(np.int32).reshape(ti.shape)
        if t == GGMLType.I64:
            return raw.view(np.int64).reshape(ti.shape)
        # quantized: raw uint8, shape (n_rows, row_bytes)
        n_rows = ti.n_elements // ti.ne[0]
        return raw.reshape(n_rows, row_nbytes(t, ti.ne[0]))

    def get(self, key: str, default: Any = None) -> Any:
        return self.metadata.get(key, default)

    def arch_key(self, template: str) -> Any:
        arch = self.metadata[Keys.General.ARCHITECTURE]
        return self.metadata.get(template.format(arch=arch))

    def close(self) -> None:
        if isinstance(self._mm, mmap.mmap):
            try:
                self._mm.close()
            except BufferError:
                pass  # live numpy views still reference the map; GC will reap it
        self._file.close()

    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class GGUFModel:
    """A logical model: one GGUF file or a multi-file split set.

    Merges tensors and metadata (first shard wins for metadata, matching the
    reference loader llama_model_loader src/llama.cpp:4721).
    """

    def __init__(self, readers: list[GGUFReader]):
        if not readers:
            raise ValueError("no GGUF shards")
        self.readers = readers
        self.metadata = dict(readers[0].metadata)
        self.tensors: dict[str, TensorInfo] = {}
        for r in readers:
            for name, ti in r.tensors.items():
                if name in self.tensors:
                    raise ValueError(f"duplicate tensor {name} across shards")
                self.tensors[name] = ti

    @classmethod
    def open(cls, path: str | os.PathLike) -> "GGUFModel":
        path = os.fspath(path)
        first = GGUFReader(path)
        count = first.metadata.get(Keys.Split.COUNT, 0)
        if not count or count <= 1:
            return cls([first])
        # llama-gguf-split naming: <base>-00001-of-000NN.gguf
        m = re.match(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$", path)
        if not m:
            raise ValueError(f"{path}: split.count={count} but filename lacks split pattern")
        base, idx, total = m.group(1), int(m.group(2)), int(m.group(3))
        if idx != 1:
            # caller passed a later shard: restart from shard 00001 so the
            # tensor set is complete and nothing is registered twice
            first.close()
            first = GGUFReader(f"{base}-{1:05d}-of-{total:05d}.gguf")
        readers = [first]
        for i in range(2, total + 1):
            readers.append(GGUFReader(f"{base}-{i:05d}-of-{total:05d}.gguf"))
        return cls(readers)

    def get(self, key: str, default: Any = None) -> Any:
        return self.metadata.get(key, default)

    @property
    def arch(self) -> str:
        return self.metadata[Keys.General.ARCHITECTURE]

    def arch_key(self, template: str, default: Any = None) -> Any:
        v = self.metadata.get(template.format(arch=self.arch))
        return default if v is None else v

    def __iter__(self) -> Iterator[TensorInfo]:
        return iter(self.tensors.values())

    def close(self) -> None:
        for r in self.readers:
            r.close()
