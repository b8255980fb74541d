"""GGUF / GGML format constants.

Format-compatibility layer with the GGUF container and GGML quantized tensor
types, as produced by llama.cpp-family tooling. Semantics match the reference
(prima.cpp) declarations:

- type enum:      ggml/include/ggml.h (enum ggml_type)
- block structs:  ggml/src/ggml-common.h:144-411
- GGUF container: ggml/src/ggml.c:21970-22440 (gguf_header / gguf_context)

This module carries only *facts about the wire format* (enum values, block
sizes, bytes per block) — all code is original.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

QK_K = 256  # super-block size for K-quants / IQ-quants
K_SCALE_SIZE = 12


class GGMLType(enum.IntEnum):
    """Tensor data types (enum ggml_type, ggml/include/ggml.h:388-427)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5: removed (q4_2 / q4_3)
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35


@dataclass(frozen=True)
class TypeTraits:
    """Block geometry of one ggml tensor type."""

    block_size: int  # elements per block
    type_size: int  # bytes per block
    is_quantized: bool

    @property
    def bits_per_weight(self) -> float:
        return 8.0 * self.type_size / self.block_size


# Geometry facts from ggml-common.h static_asserts.
TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4, False),
    GGMLType.F16: TypeTraits(1, 2, False),
    GGMLType.F64: TypeTraits(1, 8, False),
    GGMLType.BF16: TypeTraits(1, 2, False),
    GGMLType.I8: TypeTraits(1, 1, False),
    GGMLType.I16: TypeTraits(1, 2, False),
    GGMLType.I32: TypeTraits(1, 4, False),
    GGMLType.I64: TypeTraits(1, 8, False),
    GGMLType.Q4_0: TypeTraits(32, 18, True),
    GGMLType.Q4_1: TypeTraits(32, 20, True),
    GGMLType.Q5_0: TypeTraits(32, 22, True),
    GGMLType.Q5_1: TypeTraits(32, 24, True),
    GGMLType.Q8_0: TypeTraits(32, 34, True),
    GGMLType.Q8_1: TypeTraits(32, 36, True),
    GGMLType.Q2_K: TypeTraits(QK_K, 84, True),
    GGMLType.Q3_K: TypeTraits(QK_K, 110, True),
    GGMLType.Q4_K: TypeTraits(QK_K, 144, True),
    GGMLType.Q5_K: TypeTraits(QK_K, 176, True),
    GGMLType.Q6_K: TypeTraits(QK_K, 210, True),
    GGMLType.Q8_K: TypeTraits(QK_K, 292, True),
    GGMLType.IQ2_XXS: TypeTraits(QK_K, 66, True),
    GGMLType.IQ2_XS: TypeTraits(QK_K, 74, True),
    GGMLType.IQ2_S: TypeTraits(QK_K, 82, True),
    GGMLType.IQ3_XXS: TypeTraits(QK_K, 98, True),
    GGMLType.IQ3_S: TypeTraits(QK_K, 110, True),
    GGMLType.IQ1_S: TypeTraits(QK_K, 50, True),
    GGMLType.IQ1_M: TypeTraits(QK_K, 56, True),
    GGMLType.IQ4_NL: TypeTraits(32, 18, True),
    GGMLType.IQ4_XS: TypeTraits(QK_K, 136, True),
    GGMLType.TQ1_0: TypeTraits(QK_K, 2 + QK_K // 64 + (QK_K - 4 * QK_K // 64) // 5, True),
    GGMLType.TQ2_0: TypeTraits(QK_K, 2 + QK_K // 4, True),
}


def row_nbytes(ggml_type: GGMLType, n_elems: int) -> int:
    """Bytes needed for n_elems elements of ggml_type (must divide block size)."""
    tt = TYPE_TRAITS[ggml_type]
    if n_elems % tt.block_size != 0:
        raise ValueError(
            f"{ggml_type.name}: {n_elems} elements not divisible by block size {tt.block_size}"
        )
    return n_elems // tt.block_size * tt.type_size


class GGUFValueType(enum.IntEnum):
    """Metadata KV value kinds (enum gguf_type, ggml/include/ggml.h:2358)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class LlamaFtype(enum.IntEnum):
    """Model-level file types (enum llama_ftype, include/llama.h:109-150)."""

    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q8_0 = 7
    MOSTLY_Q5_0 = 8
    MOSTLY_Q5_1 = 9
    MOSTLY_Q2_K = 10
    MOSTLY_Q3_K_S = 11
    MOSTLY_Q3_K_M = 12
    MOSTLY_Q3_K_L = 13
    MOSTLY_Q4_K_S = 14
    MOSTLY_Q4_K_M = 15
    MOSTLY_Q5_K_S = 16
    MOSTLY_Q5_K_M = 17
    MOSTLY_Q6_K = 18
    MOSTLY_IQ2_XXS = 19
    MOSTLY_IQ2_XS = 20
    MOSTLY_Q2_K_S = 21
    MOSTLY_IQ3_XS = 22
    MOSTLY_IQ3_XXS = 23
    MOSTLY_IQ1_S = 24
    MOSTLY_IQ4_NL = 25
    MOSTLY_IQ3_S = 26
    MOSTLY_IQ3_M = 27
    MOSTLY_IQ2_S = 28
    MOSTLY_IQ2_M = 29
    MOSTLY_IQ4_XS = 30
    MOSTLY_IQ1_M = 31
    MOSTLY_BF16 = 32
    GUESSED = 1024


# Standard GGUF metadata keys used by llama.cpp-family models.
class Keys:
    class General:
        ARCHITECTURE = "general.architecture"
        NAME = "general.name"
        ALIGNMENT = "general.alignment"
        FILE_TYPE = "general.file_type"
        QUANTIZATION_VERSION = "general.quantization_version"

    class Split:
        NO = "split.no"
        COUNT = "split.count"
        TENSORS_COUNT = "split.tensors.count"

    # per-arch keys take the arch name as prefix, e.g. "llama.block_count"
    CONTEXT_LENGTH = "{arch}.context_length"
    EMBEDDING_LENGTH = "{arch}.embedding_length"
    BLOCK_COUNT = "{arch}.block_count"
    FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
    HEAD_COUNT = "{arch}.attention.head_count"
    HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
    LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
    ROPE_FREQ_BASE = "{arch}.rope.freq_base"
    ROPE_DIMENSION_COUNT = "{arch}.rope.dimension_count"
    ROPE_SCALING_TYPE = "{arch}.rope.scaling.type"
    ROPE_SCALING_FACTOR = "{arch}.rope.scaling.factor"
    ROPE_SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
    KEY_LENGTH = "{arch}.attention.key_length"
    VALUE_LENGTH = "{arch}.attention.value_length"
    EXPERT_COUNT = "{arch}.expert_count"
    EXPERT_USED_COUNT = "{arch}.expert_used_count"
    VOCAB_SIZE = "{arch}.vocab_size"

    class Tokenizer:
        MODEL = "tokenizer.ggml.model"  # "llama" (SPM) | "gpt2" (BPE) | ...
        PRE = "tokenizer.ggml.pre"
        TOKENS = "tokenizer.ggml.tokens"
        SCORES = "tokenizer.ggml.scores"
        TOKEN_TYPES = "tokenizer.ggml.token_type"
        MERGES = "tokenizer.ggml.merges"
        BOS_ID = "tokenizer.ggml.bos_token_id"
        EOS_ID = "tokenizer.ggml.eos_token_id"
        UNK_ID = "tokenizer.ggml.unknown_token_id"
        PAD_ID = "tokenizer.ggml.padding_token_id"
        ADD_BOS = "tokenizer.ggml.add_bos_token"
        ADD_EOS = "tokenizer.ggml.add_eos_token"
        ADD_SPACE_PREFIX = "tokenizer.ggml.add_space_prefix"
        CHAT_TEMPLATE = "tokenizer.chat_template"


class TokenType(enum.IntEnum):
    """llama_token_type / gguf token_type array values."""

    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6
