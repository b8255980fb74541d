"""WordPiece (WPM) tokenizer — BERT-family vocabularies.

Behavior-matched to the reference's llm_tokenizer_wpm_session
(src/llama-vocab.cpp:684-790): NFD-normalize, lowercase, split on
whitespace / punctuation / CJK characters, then greedy longest-match
against the vocabulary with a prepended U+2581 phantom space; words with
any unmatched position collapse to a single [UNK].
"""

from __future__ import annotations

import unicodedata

from .vocab import Vocab

_ESCAPED_SPACE = "▁"


def _is_chinese_char(cpt: int) -> bool:
    # src/llama-vocab.cpp:772-785 (including the hf-rust 0x2B920 quirk)
    return (
        0x04E00 <= cpt <= 0x09FFF or 0x03400 <= cpt <= 0x04DBF
        or 0x20000 <= cpt <= 0x2A6DF or 0x2A700 <= cpt <= 0x2B73F
        or 0x2B740 <= cpt <= 0x2B81F or 0x2B920 <= cpt <= 0x2CEAF
        or 0x0F900 <= cpt <= 0x0FAFF or 0x2F800 <= cpt <= 0x2FA1F
    )


def wpm_preprocess(text: str) -> list[str]:
    """NFD + lowercase + split into words (llm_tokenizer_wpm preprocess)."""
    nfd = unicodedata.normalize("NFD", text)
    words: list[str] = [""]
    for ch in nfd:
        cpt = ord(ch)
        cat = unicodedata.category(ch)
        if ch.isspace():
            if words[-1]:
                words.append("")
            continue
        if cpt == 0 or cpt == 0xFFFD or cat.startswith("C"):
            continue
        s = ch.lower()
        if cat.startswith("P") or (cpt < 0x7F and cat.startswith("S")) \
                or _is_chinese_char(cpt):
            if words[-1]:
                words.append("")
            words[-1] = s
            words.append("")
        else:
            words[-1] += s
    if words and not words[-1]:
        words.pop()
    return words


def wpm_encode(v: Vocab, text: str) -> list[int]:
    token_map = v.token_to_id
    max_len = max((len(t) for t in v.tokens), default=1)
    output: list[int] = []
    for word in wpm_preprocess(text):
        if not word:
            continue
        word1 = _ESCAPED_SPACE + word
        n = len(word1)
        start = len(output)
        i = 0
        while i < n:
            match = False
            for j in range(min(n, i + max_len + 1), i, -1):
                tid = token_map.get(word1[i:j])
                if tid is not None:
                    output.append(tid)
                    match = True
                    i = j
                    break
            if not match:  # discard the whole word
                del output[start:]
                break
        if len(output) == start:
            output.append(v.unk_id)
    return output


def wpm_decode_token(v: Vocab, tid: int) -> bytes:
    text = v.tokens[tid]
    if text.startswith(_ESCAPED_SPACE):
        return (" " + text[1:]).encode("utf-8")
    return text.encode("utf-8")
