"""Byte-level BPE tokenizer — the "gpt2" vocab model.

Pre-tokenizer regex variants follow the reference's per-model pre-type
dispatch (llm_tokenizer_bpe, src/llama-vocab.cpp; pre names assigned by
convert_hf_to_gguf.py). The regexes themselves are the public patterns from
the corresponding HuggingFace tokenizer.json files.
"""

from __future__ import annotations

import functools

import regex

from .vocab import TokenType, Vocab

# GPT-2 default
_GPT2 = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
# Llama-3
_LLAMA3 = r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
# Qwen-2 (single digits, case-insensitive contractions)
_QWEN2 = r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
# Falcon
_FALCON = [
    r"""[\p{P}\$\+<=>\^~\|`]+""",
    _GPT2,
    r"""[0-9][0-9][0-9]""",
]
# DeepSeek-LLM: "letters excluding CJK" (the HF pattern enumerates Latin/
# Greek/Cyrillic/... explicitly; a property set difference is equivalent for
# the golden vectors and far less error-prone)
_LETTERS_NO_CJK = r"""(?V1)\s?[[\p{L}]--[\p{Han}\p{Hangul}\p{Hiragana}\p{Katakana}]]+"""
_DEEPSEEK_LLM = [
    r"""[\r\n]""",
    _LETTERS_NO_CJK,
    r"""\s?[!-/:-~！-／：-～‘-‟　-。]+""",
    r"""\s+$""",
    r"""[一-龥ࠀ-一가-퟿]+""",
    r"""\p{N}+""",
]
# DeepSeek-Coder
_DEEPSEEK_CODER = [
    r"""[\r\n]""",
    r"""\s?\p{L}+""",
    r"""\s?\p{P}+""",
    r"""[一-龥ࠀ-一가-퟿]+""",
    r"""\p{N}""",
]

# starcoder family: isolate digits first, then the GPT-2 pattern
# (reference src/llama-vocab.cpp STARCODER/REFACT/COMMAND_R/SMOLLM/
# CODESHELL/EXAONE case)
_STARCODER = [r"""\p{N}""", _GPT2]
# poro/bloom/gpt3-finnish (reference PORO/BLOOM/GPT3_FINNISH case)
_BLOOM = [r""" ?[^(\s|.,!?…。，、।۔،)]+"""]

_PRE_REGEX: dict[str, list[str]] = {
    "default": [_GPT2],
    "gpt-2": [_GPT2],
    "gpt2": [_GPT2],
    "llama3": [_LLAMA3],
    "llama-v3": [_LLAMA3],
    "llama-bpe": [_LLAMA3],
    "smaug-bpe": [_LLAMA3],
    "dbrx": [_LLAMA3],
    "chatglm-bpe": [_LLAMA3],
    "qwen2": [_QWEN2],
    "deepseek-r1-qwen": [_QWEN2],
    "stablelm2": [_QWEN2],
    "falcon": _FALCON,
    "deepseek-llm": _DEEPSEEK_LLM,
    "deepseek-coder": _DEEPSEEK_CODER,
    "deepseek-v3": _DEEPSEEK_LLM,
    "mpt": [_GPT2],
    "olmo": [_GPT2],
    "jais": [_GPT2],
    "gpt-neox": [_GPT2],
    "starcoder": _STARCODER,
    "refact": _STARCODER,
    "command-r": _STARCODER,
    "smollm": _STARCODER,
    "codeshell": _STARCODER,
    "exaone": _STARCODER,
    # chameleon keeps the upstream sentinel/image-token splits even though
    # special-token partitioning would separate them anyway
    # (llama-vocab.cpp:467-479)
    "chameleon": [
        r"<sentinel:[0-9]+>",
        r"(IMGIMG)((A|B|C|D|E|F|G|H|I){1,4})Z",
        "([\\t\\n]|    |  )",
        r"\p{N}",
        r"[\p{P}!-/:-@\[-`{-~]",
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)""",
    ],
    "poro-chat": _BLOOM,
    "bloom": _BLOOM,
    "gpt3-finnish": _BLOOM,
    "viking": _BLOOM + [r"""\p{N}"""],
}


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


class BPE:
    def __init__(self, v: Vocab):
        self.v = v
        pats = _PRE_REGEX.get(v.pre)
        if pats is None:
            pats = [_GPT2]
        self.pats = [regex.compile(p) for p in pats]
        self.ranks: dict[tuple[str, str], int] = {}
        for rank, m in enumerate(v.merges):
            l, _, r = m.partition(" ")
            self.ranks[(l, r)] = rank

    def _pre_tokenize(self, text: str) -> list[str]:
        frags = [text]
        for pat in self.pats:
            out: list[str] = []
            for f in frags:
                pos = 0
                for m in pat.finditer(f):
                    if m.start() > pos:
                        out.append(f[pos : m.start()])
                    out.append(m.group())
                    pos = m.end()
                if pos < len(f):
                    out.append(f[pos:])
            frags = out
        return frags

    def _merge_word(self, word: str) -> list[str]:
        b2u = bytes_to_unicode()
        parts = [b2u[b] for b in word.encode("utf-8")]
        if len(parts) < 2:
            return parts
        while True:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                return parts
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]

    def encode(self, text: str) -> list[int]:
        v = self.v
        from . import native

        nt = native.get(v)
        if nt is not None:  # C++ hot path (identical ids; test_native.py)
            b2u = bytes_to_unicode()
            words = ["".join(b2u[b] for b in w.encode("utf-8")).encode("utf-8")
                     for w in self._pre_tokenize(text)]
            return nt.bpe_encode_words(words, v.ignore_merges)
        out: list[int] = []
        for word in self._pre_tokenize(text):
            if v.ignore_merges:
                b2u = bytes_to_unicode()
                whole = "".join(b2u[b] for b in word.encode("utf-8"))
                tid = v.token_to_id.get(whole)
                if tid is not None:
                    out.append(tid)
                    continue
            for piece in self._merge_word(word):
                tid = v.token_to_id.get(piece)
                if tid is None:
                    # unreachable for a complete byte-level vocab; emit byte ids
                    for ch in piece:
                        t = v.token_to_id.get(ch)
                        if t is not None:
                            out.append(t)
                else:
                    out.append(tid)
        return out


def bpe_decode_token(v: Vocab, tid: int) -> bytes:
    t = v.token_types[tid]
    if t == TokenType.CONTROL:
        return b""
    u2b = unicode_to_bytes()
    text = v.tokens[tid]
    if t == TokenType.USER_DEFINED:
        return text.encode("utf-8")
    return bytes(u2b.get(ch, ord("?")) for ch in text)
