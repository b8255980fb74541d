"""SentencePiece (SPM) tokenizer — the "llama" vocab model.

Greedy highest-score bigram merging over UTF-8 characters with byte
fallback, behavior-matched to the reference's llm_tokenizer_spm
(src/llama-vocab.cpp): whitespace is escaped to U+2581, an optional dummy
space prefix is added, unknown characters fall back to <0xXX> byte tokens.
"""

from __future__ import annotations

import heapq

from .vocab import TokenType, Vocab

_WS = "▁"  # ▁


def _utf8_chars(text: str) -> list[str]:
    return list(text)


def spm_encode(v: Vocab, text: str, add_prefix_space: bool = True) -> list[int]:
    if not text:
        return []
    if add_prefix_space and v.add_space_prefix:
        text = " " + text
    text = text.replace(" ", _WS)

    syms = _utf8_chars(text)
    n = len(syms)
    if n == 0:
        return []
    # doubly-linked list over symbol slots
    prev = list(range(-1, n - 1))
    nxt = list(range(1, n + 1))
    alive = [True] * n

    heap: list[tuple[float, int, str]] = []

    def push(i: int):
        j = nxt[i]
        if j >= n:
            return
        merged = syms[i] + syms[j]
        tid = v.token_to_id.get(merged)
        if tid is not None and v.token_types[tid] == TokenType.NORMAL:
            # max-heap on score; ties broken by leftmost position
            heapq.heappush(heap, (-v.scores[tid], i, merged))

    for i in range(n - 1):
        push(i)

    while heap:
        _, i, merged = heapq.heappop(heap)
        if not alive[i]:
            continue
        j = nxt[i]
        if j >= n or not alive[j] or syms[i] + syms[j] != merged:
            continue  # stale entry
        syms[i] = merged
        alive[j] = False
        nxt[i] = nxt[j]
        if nxt[i] < n:
            prev[nxt[i]] = i
        push(i)
        if prev[i] >= 0:
            push(prev[i])

    out: list[int] = []
    i = 0
    while i < n:
        if alive[i]:
            s = syms[i]
            tid = v.token_to_id.get(s)
            if tid is not None and v.token_types[tid] != TokenType.UNUSED:
                out.append(tid)
            else:
                for b in s.encode("utf-8"):
                    out.append(v.byte_token(b))
        i = nxt[i] if alive[i] else i + 1
    return out


def spm_decode_token(v: Vocab, tid: int) -> bytes:
    t = v.token_types[tid]
    text = v.tokens[tid]
    if t == TokenType.BYTE:
        # "<0xXX>"
        return bytes([int(text[3:5], 16)])
    if t in (TokenType.CONTROL, TokenType.UNKNOWN):
        return b""
    if t == TokenType.USER_DEFINED:
        # copied verbatim, no whitespace unescape
        # (llama_token_to_piece_impl, src/llama-vocab.cpp:1792)
        return text.encode("utf-8")
    return text.replace(_WS, " ").encode("utf-8")
