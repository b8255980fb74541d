"""Unigram (UGM) tokenizer — T5-family SentencePiece unigram vocabularies,
plus the RWKV greedy byte tokenizer.

Behavior-matched to the reference's llm_tokenizer_ugm_session
(src/llama-vocab.cpp:797-1115): normalization through the precompiled
charsmap (an XOR-compressed compact double array of prefix replacements),
whitespace escaping to U+2581, then SentencePiece's Viterbi search over a
token trie with double-precision score sums, user-defined tokens scored 0,
and an unknown-token penalty of 10 below the minimum normal score;
consecutive unknowns merge. RWKV (src/llama-vocab.cpp:1190-1260) is greedy
longest-match over byte strings unescaped from \\xNN / \\t\\n\\r forms.
"""

from __future__ import annotations

import struct

from .vocab import TokenType, Vocab

_UNK_PENALTY = 10.0


class _Trie:
    __slots__ = ("children", "value")

    def __init__(self):
        self.children: dict[int, _Trie] = {}
        self.value: int | None = None

    def insert(self, key: bytes, value: int) -> None:
        node = self
        for b in key:
            nxt = node.children.get(b)
            if nxt is None:
                nxt = node.children[b] = _Trie()
            node = nxt
        node.value = value

    def longest_prefix(self, data: bytes, start: int = 0) -> tuple[int | None, int]:
        """(value, length) of the longest key matching data[start:]."""
        node, best, blen = self, None, 0
        for i in range(start, len(data)):
            node = node.children.get(data[i])
            if node is None:
                break
            if node.value is not None:
                best, blen = node.value, i - start + 1
        return best, blen


class _XCDA:
    """Bit-packed XOR-compressed compact double array view
    (src/llama-vocab.cpp:1021-1060)."""

    def __init__(self, blob: bytes):
        import numpy as np

        self.arr = np.frombuffer(blob, dtype="<u4")

    def base(self, i: int) -> int:
        p = int(self.arr[i])
        return (p >> 10) << ((p & (1 << 9)) >> 6)

    def lcheck(self, i: int) -> int:
        p = int(self.arr[i])
        return p & ((1 << 31) | 0xFF)

    def leaf(self, i: int) -> bool:
        return bool((int(self.arr[i]) >> 8) & 1)

    def value(self, i: int) -> int:
        return int(self.arr[i]) & ((1 << 31) - 1)


def _utf8_len(b: int) -> int:
    if b < 0x80:
        return 1
    if b >> 5 == 0b110:
        return 2
    if b >> 4 == 0b1110:
        return 3
    if b >> 3 == 0b11110:
        return 4
    return 1


class UGM:
    def __init__(self, v: Vocab):
        self.v = v
        self.trie = _Trie()
        self.user_defined = _Trie()
        min_score = float("inf")
        for tid, text in enumerate(v.tokens):
            t = v.token_types[tid]
            b = text.encode("utf-8")
            if t == TokenType.NORMAL:
                min_score = min(min_score, v.scores[tid])
            if t in (TokenType.NORMAL, TokenType.USER_DEFINED, TokenType.UNUSED):
                self.trie.insert(b, tid)
            if t == TokenType.USER_DEFINED:
                self.user_defined.insert(b, tid)
        self.unknown_score = (min_score if min_score != float("inf") else 0.0) - _UNK_PENALTY

        self.xcda = None
        self.replacements = b""
        cm = v.precompiled_charsmap
        if cm:
            (blob_size,) = struct.unpack_from("<I", cm, 0)
            self.xcda = _XCDA(cm[4:4 + blob_size])
            self.replacements = cm[4 + blob_size:]

    # -- normalization (src/llama-vocab.cpp:976-1018, 1062-1112) ------------

    def _normalize_prefix(self, data: bytes, off: int) -> tuple[bytes, int]:
        """-> (normalized bytes, consumed input bytes)."""
        _, ulen = self.user_defined.longest_prefix(data, off)
        if ulen > 0:
            return data[off:off + ulen], ulen
        if self.xcda is not None and len(self.xcda.arr):
            best_len = 0
            best_off = 0
            node = self.xcda.base(0)
            for i in range(off, len(data)):
                c = data[i]
                if c == 0:
                    break
                node ^= c
                if node >= len(self.xcda.arr) or self.xcda.lcheck(node) != c:
                    break
                is_leaf = self.xcda.leaf(node)
                node ^= self.xcda.base(node)
                if is_leaf:
                    best_len = i - off + 1
                    best_off = self.xcda.value(node)
            if best_len > 0:
                end = self.replacements.index(b"\0", best_off)
                return self.replacements[best_off:end], best_len
        n = min(_utf8_len(data[off]), len(data) - off)
        return data[off:off + n], n

    def _normalize(self, text: str) -> bytes:
        data = text.encode("utf-8")
        space = "▁".encode("utf-8")
        prepend = self.v.add_space_prefix
        merge = self.v.remove_extra_whitespaces
        out = bytearray()
        space_prepended = False
        in_word = False
        off = 0
        while off < len(data):
            norm, consumed = self._normalize_prefix(data, off)
            for c in norm:
                if c != 0x20:
                    if not in_word:
                        in_word = True
                        if (prepend and not space_prepended) or merge:
                            out += space
                            space_prepended = True
                    out.append(c)
                else:
                    in_word = False
                    if not merge:
                        out += space
            off += consumed
        return bytes(out)

    # -- Viterbi (src/llama-vocab.cpp:880-975) -------------------------------

    def encode(self, text: str) -> list[int]:
        v = self.v
        data = self._normalize(text)
        n = len(data)
        if n == 0:
            return []
        NEG = float("-inf")
        # (token_id, input_offset, score_sum) per end position
        best = [(v.unk_id, 0, NEG)] * (n + 1)
        best[0] = (v.unk_id, 0, 0.0)
        for off in range(n):
            cur_score = best[off][2]
            if cur_score == NEG:
                continue
            cp_len = min(_utf8_len(data[off]), n - off)
            single_cp_found = False
            node = self.trie
            i = off
            while i < n:
                node = node.children.get(data[i])
                if node is None:
                    break
                i += 1
                if node.value is not None:
                    if i - off == cp_len:
                        single_cp_found = True
                    tid = node.value
                    score = (0.0 if v.token_types[tid] == TokenType.USER_DEFINED
                             else v.scores[tid])
                    cand = cur_score + score
                    if cand > best[i][2]:
                        best[i] = (tid, off, cand)
            if not single_cp_found:
                cand = cur_score + self.unknown_score
                end = off + cp_len
                if cand > best[end][2]:
                    best[end] = (v.unk_id, off, cand)
        # backtrack, merging consecutive unknowns
        out: list[int] = []
        pos = n
        prev_unk = False
        while True:
            tid, off, _ = best[pos]
            unk = tid == v.unk_id
            if not (prev_unk and unk):
                out.append(tid)
            if off == 0:
                break
            prev_unk = unk
            pos = off
        out.reverse()
        return out


def ugm_decode_token(v: Vocab, tid: int) -> bytes:
    text = v.tokens[tid]
    return text.replace("▁", " ").encode("utf-8")


# ---------------------------------------------------------------------------
# RWKV
# ---------------------------------------------------------------------------


def rwkv_unescape(escaped: str) -> bytes:
    """\\xNN / \\t / \\n / \\r / \\\\ unescaping (llama_unescape_rwkv_token)."""
    out = bytearray()
    i = 0
    n = len(escaped)
    while i < n:
        c = escaped[i]
        if c == "\\" and i + 1 < n:
            e = escaped[i + 1]
            if e == "t":
                out.append(9)
                i += 2
            elif e == "n":
                out.append(10)
                i += 2
            elif e == "r":
                out.append(13)
                i += 2
            elif e == "x" and i + 3 < n:
                out.append(int(escaped[i + 2:i + 4], 16))
                i += 4
            else:
                out.append(ord(e))
                i += 2
        else:
            out += c.encode("latin-1", errors="replace")
            i += 1
    return bytes(out)


class RWKV:
    """Greedy longest-match over unescaped byte strings
    (llm_tokenizer_rwkv_session)."""

    def __init__(self, v: Vocab):
        self.v = v
        self.trie = _Trie()
        self.token_bytes: list[bytes] = []
        for tid, text in enumerate(v.tokens):
            b = rwkv_unescape(text)
            self.token_bytes.append(b)
            if b:
                self.trie.insert(b, tid)

    def encode(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        out: list[int] = []
        pos = 0
        while pos < len(data):
            tid, ln = self.trie.longest_prefix(data, pos)
            if tid is None:
                out.append(self.v.unk_id)
                pos += 1
            else:
                out.append(tid)
                pos += ln
        return out

    def decode_token(self, tid: int) -> bytes:
        return self.token_bytes[tid]
