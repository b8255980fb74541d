"""Native (C++) GGUF block converter and tokenizer merge loops, loaded via
ctypes and compiled with g++ on first use.

The native runtime layer: GGUF block decode at memory bandwidth instead of
numpy speed (the role the reference's C quant code plays at model-load
time), and the SPM / BPE merge loops (tokenizer/native.py). The library
builds from `convert.cpp` and `tokenize.cpp` into `build/prima_tpu_torch/
native/` at the repository root, named by the hash of the sources and
flags, the first time a caller asks for it; never at import.

- PRIMA_NO_NATIVE=1 turns it off: the numpy route and the Python
  tokenizers take over, with the same outputs. `get_lib` reads it on every
  call, so each tensor a load converts sees it; a tokenizer asks once per
  vocabulary, at its first encode, and keeps the answer.
- PRIMA_TORCH_NATIVE_LIB=path loads a prebuilt build of these sources
  instead, such as a sanitizer build. The converter's symbols are
  `prima_torch_conv_*`, so the JAX package's library, whose `prima_conv_*`
  take another argument list, is refused rather than bound by mistake.
- Without g++ the numpy route runs, as in the JAX package. With g++, a
  compile error raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..utils.nvcc import BUILD_DIR as _KERNEL_BUILD_DIR
from ..utils.nvcc import LaunchCounter

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_DIR, "convert.cpp"), os.path.join(_DIR, "tokenize.cpp")]
BUILD_DIR = os.path.join(_KERNEL_BUILD_DIR, "native")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

# tensors converted by the native route (shows that a load took it)
CONVERTED = LaunchCounter("native_convert")

_lock = threading.Lock()
_lib = None  # the bound library, False when g++ is missing


def _target(sources: list[str], out_dir: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(out_dir, f"libprima_torch_native-{h.hexdigest()[:16]}.so")


def build(sources: list[str] = SOURCES, out_dir: str = BUILD_DIR) -> str | None:
    """Path of the shared library built from `sources`, compiling it if no
    build of these sources exists; None when g++ is missing. Processes that
    build at once take turns on a lock file, and the compiler writes to a
    temporary name that is renamed into place, so no process loads a
    half-written library."""
    out = _target(sources, out_dir)
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *sources],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(f"g++ failed for {' '.join(sources)}:\n{proc.stderr}")
            os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if not hasattr(lib, "prima_torch_conv_q4k"):
        raise RuntimeError(f"{lib._name} is not a build of {', '.join(SOURCES)}")
    i64, u8p, i8p, f32p, vp, ci = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.POINTER(ctypes.c_int8),
                                   ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
                                   ctypes.c_int)
    lib.prima_torch_conv_q4k.argtypes = [u8p, i64, i64, u8p, u8p, u8p, vp, f32p, ci]
    lib.prima_torch_conv_q4_0.argtypes = [u8p, i64, i64, u8p, f32p]
    lib.prima_torch_conv_q6k.argtypes = [u8p, i64, i64, i8p, i8p, f32p]
    lib.prima_torch_conv_q8_0.argtypes = [u8p, i64, i64, i8p, f32p]
    i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
    lib.prima_tok_new.argtypes = [u8p, i64p, i64, f32p, i8p, u8p, i64p, i64, i32p]
    lib.prima_tok_new.restype = ctypes.c_void_p
    lib.prima_tok_free.argtypes = [ctypes.c_void_p]
    lib.prima_spm_encode.argtypes = [ctypes.c_void_p, u8p, i64, i32p, i64]
    lib.prima_spm_encode.restype = i64
    lib.prima_bpe_encode_words.argtypes = [ctypes.c_void_p, u8p, i64p, i64,
                                           ctypes.c_int32, i32p, i64]
    lib.prima_bpe_encode_words.restype = i64
    return lib


def get_lib():
    """The loaded library, building it on first use; None under
    PRIMA_NO_NATIVE=1 or without g++ (the numpy and Python routes take
    over)."""
    global _lib
    if os.environ.get("PRIMA_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is None:
            path = os.environ.get("PRIMA_TORCH_NATIVE_LIB") or build()
            _lib = False if path is None else _bind(ctypes.CDLL(path))
        return _lib or None


def _ptr(a: np.ndarray, ct=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def native_convert(raw: np.ndarray, ggml_type, k: int, packed: bool = False):
    """raw (rows, row_bytes) -> (qs, scales, mins|None, d|None, dmin|None) in
    the port's natural-order layout (quant/qtensor.py); `packed` emits
    pack_scales_np's 4.5-bit Q4_K footprint. None when this type has no
    native path or the library is off."""
    from ..gguf.constants import GGMLType

    block = {GGMLType.Q4_K: (256, 144), GGMLType.Q4_0: (32, 18),
             GGMLType.Q6_K: (256, 210), GGMLType.Q8_0: (32, 34)}.get(ggml_type)
    if block is None:
        return None
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw)
    if raw.ndim == 1:
        raw = raw.reshape(1, -1)
    if raw.dtype != np.uint8 or k % block[0] or raw.shape[1] != k // block[0] * block[1]:
        raise ValueError(f"{GGMLType(ggml_type).name}: {raw.dtype} blocks of shape "
                         f"{raw.shape} do not hold rows of {k} columns")
    rows = raw.shape[0]
    src = _ptr(raw)
    mins = d = dmin = None
    if ggml_type == GGMLType.Q4_K:
        qs = np.empty((rows, k // 2), np.uint8)
        if packed:
            scales = np.empty((rows, k // 32), np.uint8)
            mins = np.empty((rows, k // 64), np.uint8)
            d = np.empty((rows, k // 256), np.int32)
        else:
            scales = np.empty((rows, k // 32), np.int8)
            mins = np.empty((rows, k // 32), np.int8)
            d = np.empty((rows, k // 256), np.float32)
            dmin = np.empty((rows, k // 256), np.float32)
        lib.prima_torch_conv_q4k(src, rows, k, _ptr(qs), _ptr(scales), _ptr(mins),
                           d.ctypes.data, None if dmin is None else _ptr(dmin, ctypes.c_float),
                           int(packed))
    elif ggml_type == GGMLType.Q4_0:
        qs = np.empty((rows, k // 2), np.uint8)
        scales = np.empty((rows, k // 32), np.float32)
        lib.prima_torch_conv_q4_0(src, rows, k, _ptr(qs), _ptr(scales, ctypes.c_float))
    elif ggml_type == GGMLType.Q6_K:
        qs = np.empty((rows, k), np.int8)
        scales = np.empty((rows, k // 16), np.int8)
        d = np.empty((rows, k // 256), np.float32)
        lib.prima_torch_conv_q6k(src, rows, k, _ptr(qs, ctypes.c_int8), _ptr(scales, ctypes.c_int8),
                           _ptr(d, ctypes.c_float))
    else:
        qs = np.empty((rows, k), np.int8)
        scales = np.empty((rows, k // 32), np.float32)
        lib.prima_torch_conv_q8_0(src, rows, k, _ptr(qs, ctypes.c_int8),
                            _ptr(scales, ctypes.c_float))
    with _lock:
        CONVERTED.count += 1
    return qs, scales, mins, d, dmin
