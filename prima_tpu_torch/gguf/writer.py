"""GGUF container writer.

Produces GGUF v3 files readable by the reference parser
(ggml/src/ggml.c:22099 gguf_init_from_file) and by our reader. Used by the
quantizer tool, test-fixture generation, and gguf-split equivalents.
"""

from __future__ import annotations

import struct
from typing import Any, Sequence

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    Keys,
    row_nbytes,
)


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


_SCALAR_PACK = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<B",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def _infer_vtype(value: Any) -> GGUFValueType:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, int):
        if value < 0:
            return GGUFValueType.INT64 if value < -(2**31) else GGUFValueType.INT32
        return GGUFValueType.UINT64 if value >= 2**32 else GGUFValueType.UINT32
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(value)}")


_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
    np.dtype(np.bool_): GGUFValueType.BOOL,
}


def _pack_value(value: Any, vtype: GGUFValueType | None = None) -> bytes:
    if vtype is None:
        vtype = _infer_vtype(value)
    out = struct.pack("<I", int(vtype))
    return out + _pack_payload(value, vtype)


def _pack_payload(value: Any, vtype: GGUFValueType) -> bytes:
    if vtype == GGUFValueType.STRING:
        return _pack_string(value)
    if vtype == GGUFValueType.ARRAY:
        if isinstance(value, np.ndarray):
            etype = _NP_TO_VTYPE[value.dtype]
            body = value.astype(value.dtype.newbyteorder("<")).tobytes()
            return struct.pack("<IQ", int(etype), value.size) + body
        if len(value) == 0:
            return struct.pack("<IQ", int(GGUFValueType.INT32), 0)
        first = value[0]
        if isinstance(first, str):
            etype = GGUFValueType.STRING
            body = b"".join(_pack_string(v) for v in value)
        else:
            etype = _infer_vtype(first)
            # normalize mixed-int arrays: a non-negative first element infers
            # UINT32 which cannot hold later negatives, and large magnitudes
            # need 64 bits
            if etype in (GGUFValueType.UINT32, GGUFValueType.INT32):
                ints = [v for v in value if isinstance(v, int)]
                if any(v < 0 for v in ints):
                    etype = GGUFValueType.INT32
                if any(v >= 2**31 or v < -(2**31) for v in ints):
                    etype = GGUFValueType.INT64
            body = b"".join(struct.pack(_SCALAR_PACK[etype], v) for v in value)
        return struct.pack("<IQ", int(etype), len(value)) + body
    return struct.pack(_SCALAR_PACK[vtype], int(value) if vtype == GGUFValueType.BOOL else value)


class GGUFWriter:
    def __init__(self, path: str, arch: str | None = None, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = path
        self.alignment = alignment
        self._kv: list[tuple[str, Any, GGUFValueType | None]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, bytes]] = []
        if arch is not None:
            self.add_kv(Keys.General.ARCHITECTURE, arch)
        if alignment != GGUF_DEFAULT_ALIGNMENT:
            self.add_kv(Keys.General.ALIGNMENT, alignment)

    def add_kv(self, key: str, value: Any, vtype: GGUFValueType | None = None) -> None:
        self._kv.append((key, value, vtype))

    def add_tensor(
        self,
        name: str,
        data: np.ndarray | bytes,
        ne: Sequence[int] | None = None,
        ggml_type: GGMLType | None = None,
    ) -> None:
        """Add a tensor.

        For float tensors pass a numpy array (C-order; ne is reversed shape).
        For quantized tensors pass raw block bytes plus explicit ne + ggml_type.
        """
        if isinstance(data, np.ndarray) and ggml_type is None:
            if data.dtype == np.float32:
                ggml_type = GGMLType.F32
            elif data.dtype == np.float16:
                ggml_type = GGMLType.F16
            elif data.dtype == np.int32:
                ggml_type = GGMLType.I32
            else:
                raise TypeError(f"pass ggml_type explicitly for dtype {data.dtype}")
            ne = tuple(reversed(data.shape))
            raw = np.ascontiguousarray(data).tobytes()
        else:
            assert ne is not None and ggml_type is not None
            raw = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
            ne = tuple(int(d) for d in ne)
            expected = 1
            for d in ne:
                expected *= d
            expected = expected // ne[0] * row_nbytes(ggml_type, ne[0])
            if len(raw) != expected:
                raise ValueError(f"{name}: got {len(raw)} bytes, expected {expected}")
        self._tensors.append((name, tuple(ne), ggml_type, raw))

    def write(self) -> None:
        align = self.alignment
        header = struct.pack("<IIqq", GGUF_MAGIC, GGUF_VERSION, len(self._tensors), len(self._kv))
        kv_blob = b"".join(_pack_string(k) + _pack_value(v, t) for k, v, t in self._kv)

        infos = []
        offset = 0
        for name, ne, gt, raw in self._tensors:
            offset = (offset + align - 1) // align * align
            info = _pack_string(name)
            info += struct.pack("<I", len(ne))
            info += b"".join(struct.pack("<Q", d) for d in ne)
            info += struct.pack("<IQ", int(gt), offset)
            infos.append((info, offset, raw))
            offset += len(raw)

        info_blob = b"".join(i for i, _, _ in infos)
        data_start = len(header) + len(kv_blob) + len(info_blob)
        pad0 = (align - data_start % align) % align

        with open(self.path, "wb") as f:
            f.write(header)
            f.write(kv_blob)
            f.write(info_blob)
            f.write(b"\x00" * pad0)
            pos = 0
            for _, off, raw in infos:
                f.write(b"\x00" * (off - pos))
                f.write(raw)
                pos = off + len(raw)
