"""Tokenizer facade: SPM, byte-level BPE, WordPiece (BERT), Unigram (T5)
and RWKV vocabularies with special-token handling.

Mirrors the reference's llama_tokenize / llama_detokenize behavior
(src/llama-vocab.cpp): optional BOS/EOS (or CLS/SEP for WPM) insertion,
greedy special-token partitioning when parse_special is set, and
byte-exact detokenization.
"""

from __future__ import annotations

from .bpe import BPE, bpe_decode_token
from .spm import spm_decode_token, spm_encode
from .ugm import RWKV, UGM, ugm_decode_token
from .vocab import TokenType, Vocab
from .wpm import wpm_decode_token, wpm_encode

__all__ = ["Tokenizer", "Vocab", "TokenType"]


class Tokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self._bpe = BPE(vocab) if vocab.model == "gpt2" else None
        self._ugm = UGM(vocab) if vocab.model == "t5" else None
        self._rwkv = RWKV(vocab) if vocab.model == "rwkv" else None
        self._wpm = vocab.model == "bert"
        # USER_DEFINED tokens are always matched literally in raw text;
        # CONTROL tokens only when parse_special (reference
        # tokenizer_st_partition, src/llama-vocab.cpp)
        self._specials_all = vocab.special_tokens()
        self._specials_user = [
            (t, i) for t, i in self._specials_all
            if vocab.token_types[i] == TokenType.USER_DEFINED
        ]

    @classmethod
    def from_gguf(cls, m) -> "Tokenizer":
        return cls(Vocab.from_gguf(m))

    # -- encode -------------------------------------------------------------

    def _encode_fragment(self, text: str) -> list[int]:
        if not text:
            return []
        if self._bpe is not None:
            return self._bpe.encode(text)
        if self._wpm:
            return wpm_encode(self.vocab, text)
        if self._ugm is not None:
            return self._ugm.encode(text)
        if self._rwkv is not None:
            return self._rwkv.encode(text)
        return spm_encode(self.vocab, text, add_prefix_space=True)

    def _partition_specials(self, text: str, specials) -> list[tuple[str, int | None]]:
        """Split text into (fragment, None) and ("", token_id) pieces by
        greedy longest-match of special-token literals."""
        pieces: list[tuple[str, int | None]] = [(text, None)]
        for tok_text, tok_id in specials:
            nxt: list[tuple[str, int | None]] = []
            for frag, tid in pieces:
                if tid is not None or not frag:
                    nxt.append((frag, tid))
                    continue
                start = 0
                while True:
                    idx = frag.find(tok_text, start)
                    if idx < 0:
                        if start < len(frag):
                            nxt.append((frag[start:], None))
                        break
                    if idx > start:
                        nxt.append((frag[start:idx], None))
                    nxt.append(("", tok_id))
                    start = idx + len(tok_text)
            pieces = nxt
        return pieces

    def encode(self, text: str, add_special: bool = True, parse_special: bool = False) -> list[int]:
        v = self.vocab
        out: list[int] = []
        if self._wpm:
            # BERT sequences are [CLS] text [SEP] (llama_tokenize_internal);
            # special-token literals partition like every other vocab type
            if add_special and v.cls_id >= 0:
                out.append(v.cls_id)
            specials = self._specials_all if parse_special else self._specials_user
            if specials:
                for frag, tid in self._partition_specials(text, specials):
                    out.append(tid) if tid is not None else out.extend(
                        wpm_encode(v, frag))
            else:
                out.extend(wpm_encode(v, text))
            if add_special and v.sep_id >= 0:
                out.append(v.sep_id)
            return out
        if add_special and v.add_bos and v.bos_id >= 0:
            out.append(v.bos_id)
        specials = self._specials_all if parse_special else self._specials_user
        if specials:
            for frag, tid in self._partition_specials(text, specials):
                if tid is not None:
                    out.append(tid)
                else:
                    out.extend(self._encode_fragment(frag))
        else:
            out.extend(self._encode_fragment(text))
        if add_special and v.add_eos and v.eos_id >= 0:
            out.append(v.eos_id)
        return out

    # -- decode -------------------------------------------------------------

    def decode_token_bytes(self, tid: int, render_special: bool = False) -> bytes:
        v = self.vocab
        if render_special and v.is_special(tid):
            return v.tokens[tid].encode("utf-8")
        if self._bpe is not None:
            return bpe_decode_token(v, tid)
        if self._wpm:
            return wpm_decode_token(v, tid)
        if self._ugm is not None:
            return ugm_decode_token(v, tid)
        if self._rwkv is not None:
            return self._rwkv.decode_token(tid)
        return spm_decode_token(v, tid)

    def decode(self, ids, render_special: bool = False) -> str:
        v = self.vocab
        data = b"".join(self.decode_token_bytes(int(t), render_special) for t in ids)
        text = data.decode("utf-8", errors="replace")
        if self._wpm or self._rwkv is not None:
            return text
        if self._ugm is not None:
            return text[1:] if v.add_space_prefix and text.startswith(" ") else text
        # SPM: drop the dummy leading space added at encode time
        if self._bpe is None and v.add_space_prefix and text.startswith(" "):
            ids = list(ids)
            if not (ids and ids[0] == v.bos_id):
                text = text[1:]
            elif len(ids) > 1:
                text = text[1:]
        return text
