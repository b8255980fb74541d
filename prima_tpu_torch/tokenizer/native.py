"""ctypes bridge to the native (C++) tokenizer hot paths.

Wraps native/tokenize.cpp: the SPM bigram-merge and BPE rank-merge inner
loops run in C++ (~10-50x the pure-Python throughput on long prompts);
pre-tokenization, whitespace escaping and special-token handling stay in
the Python tokenizer. `get(vocab)` returns None when no compiler is
available or PRIMA_NO_NATIVE=1 — callers fall back to the Python
implementations, which are the behavior reference (tests/test_native.py
asserts identical ids on the reference vocab fixtures).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .vocab import Vocab


def _pack(strings: list[str]) -> tuple[np.ndarray, np.ndarray]:
    bs = [s.encode("utf-8") for s in strings]
    offs = np.zeros(len(bs) + 1, np.int64)
    np.cumsum([len(b) for b in bs], out=offs[1:])
    return np.frombuffer(b"".join(bs) + b"\0", np.uint8), offs


class NativeTok:
    def __init__(self, lib, v: Vocab):
        self._lib = lib
        blob, offs = _pack(v.tokens)
        mblob, moffs = _pack(v.merges)
        scores = np.asarray(v.scores, np.float32) if v.scores else \
            np.zeros(len(v.tokens), np.float32)
        types = np.asarray(v.token_types, np.int8) if v.token_types else \
            np.ones(len(v.tokens), np.int8)
        byte_tok = np.asarray([v.byte_token(b) for b in range(256)], np.int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._h = lib.prima_tok_new(
            blob.ctypes.data_as(u8p),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(v.tokens),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            types.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            mblob.ctypes.data_as(u8p),
            moffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(v.merges),
            byte_tok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.prima_tok_free(h)
            self._h = None

    def spm_encode(self, escaped: bytes) -> list[int]:
        """Encode an already whitespace-escaped utf-8 fragment."""
        if not escaped:
            return []
        out = np.empty(len(escaped) + 8, np.int32)
        n = self._lib.prima_spm_encode(
            self._h, np.frombuffer(escaped, np.uint8).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            len(escaped), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.size)
        assert n >= 0, "native spm out-buffer overflow"
        return out[:n].tolist()

    def bpe_encode_words(self, words: list[bytes],
                         ignore_merges: bool) -> list[int]:
        """Encode byte-to-unicode-mapped pre-tokens (utf-8 of the proxy
        characters), concatenated into one call."""
        if not words:
            return []
        offs = np.zeros(len(words) + 1, np.int64)
        np.cumsum([len(w) for w in words], out=offs[1:])
        blob = np.frombuffer(b"".join(words) + b"\0", np.uint8)
        out = np.empty(int(offs[-1]) + 8, np.int32)
        n = self._lib.prima_bpe_encode_words(
            self._h, blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(words), 1 if ignore_merges else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size)
        assert n >= 0, "native bpe out-buffer overflow"
        return out[:n].tolist()


def get(v: Vocab) -> NativeTok | None:
    """Per-vocab cached native tokenizer, or None (Python fallback)."""
    cached = getattr(v, "_native_tok", False)
    if cached is not False:
        return cached
    from ..native import get_lib

    lib = get_lib()
    nt = NativeTok(lib, v) if lib is not None else None
    object.__setattr__(v, "_native_tok", nt)
    return nt
