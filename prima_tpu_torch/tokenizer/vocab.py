"""Vocabulary loaded from GGUF metadata.

The analogue of llama_vocab / llm_load_vocab (reference src/llama-vocab.cpp,
src/llama.cpp:6593): token table with scores/types, special-token ids and
flags, tokenizer model ("llama" = SentencePiece, "gpt2" = byte-level BPE)
and the pre-tokenizer variant name.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..gguf.reader import GGUFModel


class TokenType(IntEnum):
    # mirrors llama_token_type (reference include/llama.h)
    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


@dataclass
class Vocab:
    model: str  # "llama" (SPM) | "gpt2" (BPE) | "bert" (WPM) | "t5" (UGM) | "rwkv" | "no_vocab"
    pre: str  # pre-tokenizer variant ("default", "llama3", "qwen2", ...)
    tokens: list[str]
    scores: list[float]
    token_types: list[int]
    merges: list[str] = field(default_factory=list)
    bos_id: int = -1
    eos_id: int = -1
    eot_id: int = -1
    eom_id: int = -1
    unk_id: int = -1
    pad_id: int = -1
    sep_id: int = -1  # BERT/WPM [SEP]
    cls_id: int = -1  # BERT/WPM [CLS] (used as bos)
    add_bos: bool = False
    add_eos: bool = False
    # FIM/infill specials (llama_token_prefix/suffix/middle): codellama
    # GGUFs carry these as explicit KVs
    fim_pre_id: int = -1
    fim_suf_id: int = -1
    fim_mid_id: int = -1
    add_space_prefix: bool = True
    ignore_merges: bool = False
    remove_extra_whitespaces: bool = False  # UGM normalization option
    precompiled_charsmap: bytes = b""  # UGM XCDA normalization table

    token_to_id: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.token_to_id:
            self.token_to_id = {t: i for i, t in enumerate(self.tokens)}

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def is_special(self, tid: int) -> bool:
        return self.token_types[tid] in (TokenType.CONTROL, TokenType.USER_DEFINED)

    def is_eog(self, tid: int) -> bool:
        """End-of-generation (eos / eot / eom)."""
        return tid >= 0 and tid in (self.eos_id, self.eot_id, self.eom_id)

    def special_tokens(self) -> list[tuple[str, int]]:
        """CONTROL/USER_DEFINED tokens, longest first (for greedy matching)."""
        out = [(t, i) for i, t in enumerate(self.tokens) if self.is_special(i)]
        out.sort(key=lambda p: -len(p[0]))
        return out

    @classmethod
    def from_gguf(cls, m: "GGUFModel") -> "Vocab":
        def arr(key, fallback):
            val = m.get(key)
            return fallback if val is None or len(val) == 0 else list(val)

        g = m.get
        model = str(g("tokenizer.ggml.model", "llama"))
        tokens = [str(t) for t in arr("tokenizer.ggml.tokens", [])]
        n = len(tokens)
        scores = arr("tokenizer.ggml.scores", [0.0] * n)
        types = arr("tokenizer.ggml.token_type", [int(TokenType.NORMAL)] * n)
        merges = [str(x) for x in arr("tokenizer.ggml.merges", [])]

        spm = model == "llama"
        v = cls(
            model=model,
            pre=str(g("tokenizer.ggml.pre", "default")),
            tokens=tokens,
            scores=[float(s) for s in scores],
            token_types=[int(t) for t in types],
            merges=merges,
            bos_id=int(g("tokenizer.ggml.bos_token_id", 1 if spm else 11)),
            eos_id=int(g("tokenizer.ggml.eos_token_id", 2 if spm else 11)),
            unk_id=int(g("tokenizer.ggml.unknown_token_id", 0 if spm else -1)),
            pad_id=int(g("tokenizer.ggml.padding_token_id", -1)),
            sep_id=int(g("tokenizer.ggml.seperator_token_id", -1)),
            cls_id=int(g("tokenizer.ggml.cls_token_id", -1)),
            add_bos=bool(g("tokenizer.ggml.add_bos_token", spm)),
            add_eos=bool(g("tokenizer.ggml.add_eos_token", False)),
            fim_pre_id=int(g("tokenizer.ggml.prefix_token_id", -1)),
            fim_suf_id=int(g("tokenizer.ggml.suffix_token_id", -1)),
            fim_mid_id=int(g("tokenizer.ggml.middle_token_id", -1)),
            add_space_prefix=bool(g("tokenizer.ggml.add_space_prefix", spm)),
            ignore_merges=False,
            remove_extra_whitespaces=bool(
                g("tokenizer.ggml.remove_extra_whitespaces", False)),
            precompiled_charsmap=bytes(
                bytearray(g("tokenizer.ggml.precompiled_charsmap", b"") or b"")),
        )
        # llama3-style end-of-turn markers double as end-of-generation
        for name in ("<|eot_id|>", "<|im_end|>", "<|end|>", "<end_of_turn>"):
            tid = v.token_to_id.get(name, -1)
            if tid >= 0 and v.eot_id < 0:
                v.eot_id = tid
        if v.token_to_id.get("<|eom_id|>", -1) >= 0:
            v.eom_id = v.token_to_id["<|eom_id|>"]
        # LLAMA_VOCAB_PRE_TYPE_LLAMA3 pre-type aliases (reference
        # src/llama-vocab.cpp llama3/llama-v3/llama-bpe/smaug-bpe mapping,
        # llama.cpp:6746-6751): whole-word vocab lookup before BPE merges,
        # and BOS always prepended.
        if v.pre in ("llama3", "llama-v3", "llama-bpe", "smaug-bpe"):
            v.ignore_merges = True
            v.add_bos = True
        return v

    def byte_token(self, b: int) -> int:
        """Token id for raw byte b (SPM byte-fallback <0xXX>)."""
        tid = self.token_to_id.get(f"<0x{b:02X}>", -1)
        if tid < 0:
            # fall back to the raw character if present
            tid = self.token_to_id.get(chr(b), self.unk_id)
        return tid
