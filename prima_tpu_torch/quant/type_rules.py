"""Per-tensor quantization type selection — the llama_tensor_get_type port.

The port's copy of prima_tpu/quant/type_rules.py.

Faithful to llama.cpp's src/llama.cpp:19271-19556 (llama_tensor_get_type)
plus the ftype->default switch of llama_model_quantize_internal (@19614):
given an ftype like Q4_K_M, each tensor's final type depends on its role
(attn_v / ffn_down / output / ...), its layer index, GQA ratio, expert
count, imatrix availability, and K-quant row-size compatibility, with the
same stateful counters (i_attention_wv, i_ffn_down, ...) the reference
threads through the tensor stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..gguf.constants import GGMLType

QK_K = 256

# llama_model_quantize_internal's ftype -> default-type switch
FTYPE_DEFAULT: dict[str, GGMLType] = {
    "Q4_0": GGMLType.Q4_0, "Q4_1": GGMLType.Q4_1,
    "Q5_0": GGMLType.Q5_0, "Q5_1": GGMLType.Q5_1,
    "Q8_0": GGMLType.Q8_0,
    "F16": GGMLType.F16, "BF16": GGMLType.BF16, "F32": GGMLType.F32,
    "Q2_K": GGMLType.Q2_K, "Q2_K_S": GGMLType.Q2_K,
    "Q3_K_S": GGMLType.Q3_K, "Q3_K_M": GGMLType.Q3_K,
    "Q3_K_L": GGMLType.Q3_K, "Q3_K": GGMLType.Q3_K,
    "Q4_K_S": GGMLType.Q4_K, "Q4_K_M": GGMLType.Q4_K,
    "Q4_K": GGMLType.Q4_K,
    "Q5_K_S": GGMLType.Q5_K, "Q5_K_M": GGMLType.Q5_K,
    "Q5_K": GGMLType.Q5_K,
    "Q6_K": GGMLType.Q6_K,
    "TQ1_0": GGMLType.TQ1_0, "TQ2_0": GGMLType.TQ2_0,
    "IQ2_XXS": GGMLType.IQ2_XXS, "IQ2_XS": GGMLType.IQ2_XS,
    "IQ2_S": GGMLType.IQ2_XS, "IQ2_M": GGMLType.IQ2_S,
    "IQ3_XXS": GGMLType.IQ3_XXS, "IQ3_XS": GGMLType.IQ3_S,
    "IQ3_S": GGMLType.IQ3_S, "IQ3_M": GGMLType.IQ3_S,
    "IQ1_S": GGMLType.IQ1_S, "IQ1_M": GGMLType.IQ1_M,
    "IQ4_NL": GGMLType.IQ4_NL, "IQ4_XS": GGMLType.IQ4_XS,
}

# aliases accepted by the CLI (reference's quantize tool accepts both)
FTYPE_ALIASES = {"Q4_K": "Q4_K_M", "Q5_K": "Q5_K_M", "Q3_K": "Q3_K_M"}

_IQ_LOW = {"IQ2_XXS", "IQ2_XS", "IQ1_S", "IQ2_S", "IQ2_M", "IQ1_M"}

_K_QUANTS = {GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K,
             GGMLType.Q6_K, GGMLType.IQ4_XS, GGMLType.IQ2_XS,
             GGMLType.IQ2_XXS, GGMLType.IQ2_S, GGMLType.IQ3_XXS,
             GGMLType.IQ1_S, GGMLType.IQ3_S, GGMLType.IQ1_M}

# fallbacks when a row isn't divisible by QK_K (@19532-19549)
_INCOMPATIBLE_FALLBACK = {
    GGMLType.TQ1_0: GGMLType.Q4_0, GGMLType.TQ2_0: GGMLType.Q4_0,
    GGMLType.IQ2_XXS: GGMLType.IQ4_NL, GGMLType.IQ2_XS: GGMLType.IQ4_NL,
    GGMLType.IQ2_S: GGMLType.IQ4_NL, GGMLType.IQ3_XXS: GGMLType.IQ4_NL,
    GGMLType.IQ3_S: GGMLType.IQ4_NL, GGMLType.IQ1_S: GGMLType.IQ4_NL,
    GGMLType.IQ1_M: GGMLType.IQ4_NL, GGMLType.Q2_K: GGMLType.IQ4_NL,
    GGMLType.Q3_K: GGMLType.IQ4_NL, GGMLType.IQ4_XS: GGMLType.IQ4_NL,
    GGMLType.Q4_K: GGMLType.Q5_0, GGMLType.Q5_K: GGMLType.Q5_1,
    GGMLType.Q6_K: GGMLType.Q8_0,
}

_BLOCK_SIZES = {GGMLType.Q4_0: 32, GGMLType.Q4_1: 32, GGMLType.Q5_0: 32,
                GGMLType.Q5_1: 32, GGMLType.Q8_0: 32, GGMLType.IQ4_NL: 32}


def use_more_bits(i_layer: int, n_layers: int) -> bool:
    """@19278: first/last n/8 layers and every 3rd in between."""
    return (i_layer < n_layers // 8 or i_layer >= 7 * n_layers // 8
            or (i_layer - n_layers // 8) % 3 == 2)


@dataclass
class QuantPlanner:
    """quantize_state_internal + llama_tensor_get_type."""

    ftype: str
    n_layer: int
    n_gqa: int = 1
    n_expert: int = 0
    arch: str = "llama"
    has_imatrix: bool = False
    has_output: bool = True  # a separate output.weight tensor exists
    model_70b: bool = False
    output_tensor_type: GGMLType | None = None  # --output-tensor-type
    token_embedding_type: GGMLType | None = None  # --token-embedding-type
    n_attention_wv: int = 0  # set from the tensor stream before planning
    n_ffn_down: int = 0
    i_attention_wv: int = field(default=0, init=False)
    i_ffn_down: int = field(default=0, init=False)
    i_ffn_gate: int = field(default=0, init=False)
    i_ffn_up: int = field(default=0, init=False)
    n_fallback: int = field(default=0, init=False)

    def __post_init__(self):
        self.ftype = self.ftype.upper()
        if self.ftype not in FTYPE_DEFAULT:
            raise ValueError(f"unknown ftype {self.ftype}")
        # like quantize_state_internal, these default to the layer count;
        # quantize_gguf overrides them with actual tensor-stream counts
        if not self.n_attention_wv:
            self.n_attention_wv = self.n_layer
        if not self.n_ffn_down:
            self.n_ffn_down = self.n_layer

    # -- the port ----------------------------------------------------------

    def get_type(self, name: str, shape: tuple[int, ...]) -> GGMLType:
        """shape follows numpy row-major (rows, ne0): shape[-1] is the GGUF
        ne[0] (row length) the divisibility rules key on."""
        ft = self.ftype
        new_type = FTYPE_DEFAULT[ft]
        nx = shape[-1]
        n_expert = max(1, self.n_expert)

        def layer_of(default_i: int) -> int:
            if n_expert > 1:
                # experts are not consecutive (@19283-19291): parse blk.N.
                try:
                    return int(name.split("blk.")[1].split(".")[0])
                except (IndexError, ValueError):
                    raise ValueError(
                        f"failed to determine layer for tensor {name}")
            return default_i

        is_output = name == "output.weight" or (
            not self.has_output and name == "token_embd.weight")

        if is_output:
            if self.output_tensor_type is not None:
                new_type = self.output_tensor_type
            elif self.arch == "falcon" or nx % QK_K != 0:
                new_type = GGMLType.Q8_0
            elif ft in ("IQ2_XXS", "IQ2_XS", "IQ3_XXS", "IQ1_S", "IQ2_S",
                        "IQ2_M", "IQ1_M"):
                new_type = GGMLType.Q5_K
            elif new_type != GGMLType.Q8_0:
                new_type = GGMLType.Q6_K
        elif name == "token_embd.weight":
            if self.token_embedding_type is not None:
                new_type = self.token_embedding_type
            elif ft in ("IQ2_XXS", "IQ2_XS", "IQ1_S", "IQ1_M"):
                new_type = GGMLType.Q2_K
            elif ft in ("IQ2_S", "IQ2_M", "IQ3_XXS"):
                new_type = GGMLType.IQ3_S
            elif ft in ("TQ1_0", "TQ2_0"):
                new_type = GGMLType.Q4_K
        elif ft in _IQ_LOW:
            if "attn_v.weight" in name:
                if self.n_gqa >= 4 or self.n_expert >= 4:
                    new_type = GGMLType.Q4_K
                else:
                    new_type = GGMLType.IQ3_S if ft in ("IQ2_S", "IQ2_M") \
                        else GGMLType.Q2_K
                self.i_attention_wv += 1
            elif self.n_expert == 8 and "attn_k.weight" in name:
                new_type = GGMLType.Q4_K
            elif "ffn_down" in name:
                if self.i_ffn_down < self.n_ffn_down // 8:
                    new_type = GGMLType.IQ3_S if ft in ("IQ2_S", "IQ2_M") \
                        else GGMLType.Q2_K
                self.i_ffn_down += 1
            elif "attn_output.weight" in name:
                if self.n_expert == 8:
                    new_type = GGMLType.Q5_K
                elif ft in ("IQ1_S", "IQ1_M"):
                    new_type = GGMLType.IQ2_XXS
                elif ft in ("IQ2_S", "IQ2_M"):
                    new_type = GGMLType.IQ3_S
        elif "attn_v.weight" in name:
            if ft == "Q2_K":
                new_type = GGMLType.Q4_K if self.n_gqa >= 4 else GGMLType.Q3_K
            elif ft == "Q2_K_S" and self.n_gqa >= 4:
                new_type = GGMLType.Q4_K
            elif ft == "IQ3_XXS":
                new_type = (GGMLType.Q4_K if self.n_gqa >= 4 else
                            (GGMLType.IQ3_XXS if self.has_imatrix
                             else GGMLType.IQ3_S))
            elif ft in ("IQ3_XS", "IQ3_S") and self.n_gqa >= 4:
                new_type = GGMLType.Q4_K
            elif ft == "IQ3_M":
                new_type = GGMLType.Q4_K
            elif ft == "Q3_K_M":
                new_type = GGMLType.Q5_K if self.i_attention_wv < 2 \
                    else GGMLType.Q4_K
            elif ft == "Q3_K_L":
                new_type = GGMLType.Q5_K
            elif ft in ("IQ4_NL", "IQ4_XS") and self.n_gqa >= 4:
                new_type = GGMLType.Q5_K
            elif ft in ("Q4_K_M", "Q5_K_M") and use_more_bits(
                    self.i_attention_wv, self.n_attention_wv):
                new_type = GGMLType.Q6_K
            elif ft == "Q4_K_S" and self.i_attention_wv < 4:
                new_type = GGMLType.Q5_K
            if self.model_70b and new_type in (GGMLType.Q3_K, GGMLType.Q4_K):
                # 8-way GQA: attn_v is 8x smaller than attn_q (@19385-19391)
                new_type = GGMLType.Q5_K
            if self.n_expert == 8:
                new_type = GGMLType.Q8_0
            self.i_attention_wv += 1
        elif "attn_k.weight" in name:
            if self.n_expert == 8:
                new_type = GGMLType.Q8_0
            elif ft == "IQ3_XS":
                new_type = GGMLType.IQ3_XXS
            elif ft == "IQ3_XXS":
                new_type = GGMLType.IQ2_S
        elif "attn_q.weight" in name:
            if ft == "IQ3_XS":
                new_type = GGMLType.IQ3_XXS
            elif ft == "IQ3_XXS":
                new_type = GGMLType.IQ2_S
        elif "ffn_down" in name:
            i_layer, n_layer = layer_of(self.i_ffn_down), self.n_ffn_down
            if ft == "Q2_K":
                new_type = GGMLType.Q3_K
            elif ft == "Q2_K_S":
                if i_layer < n_layer // 8:
                    new_type = GGMLType.Q4_K
            elif ft == "IQ3_XXS" and not self.has_imatrix:
                new_type = GGMLType.Q4_K if i_layer < n_layer // 8 \
                    else GGMLType.Q3_K
            elif ft == "Q3_K_M":
                if i_layer < n_layer // 16:
                    new_type = GGMLType.Q5_K
                elif self.arch != "falcon" or use_more_bits(i_layer, n_layer):
                    new_type = GGMLType.Q4_K
                else:
                    new_type = GGMLType.Q3_K
            elif ft == "IQ3_M" and (i_layer < n_layer // 8 or (
                    self.n_expert == 8 and use_more_bits(i_layer, n_layer))):
                new_type = GGMLType.Q4_K
            elif ft == "Q3_K_L":
                new_type = GGMLType.Q4_K if self.arch == "falcon" \
                    else GGMLType.Q5_K
            elif ft == "Q4_K_M":
                if self.arch == "falcon":
                    new_type = (GGMLType.Q6_K if i_layer < n_layer // 16 else
                                GGMLType.Q5_K if use_more_bits(i_layer, n_layer)
                                else GGMLType.Q4_K)
                elif use_more_bits(i_layer, n_layer):
                    new_type = GGMLType.Q6_K
            elif (i_layer < n_layer // 8 and ft in ("IQ4_NL", "IQ4_XS")
                  and not self.has_imatrix):
                new_type = GGMLType.Q5_K
            elif ft == "Q5_K_M" and use_more_bits(i_layer, n_layer):
                new_type = GGMLType.Q6_K
            elif (ft == "Q4_K_S" and self.arch != "falcon"
                  and i_layer < n_layer // 8):
                new_type = GGMLType.Q5_K
            elif (ft in ("Q4_0", "Q5_0") and self.has_imatrix
                  and i_layer < n_layer // 8):
                new_type = GGMLType.Q4_1 if ft == "Q4_0" else GGMLType.Q5_1
            self.i_ffn_down += 1
        elif "attn_output.weight" in name:
            if self.arch != "falcon":
                if self.n_expert == 8:
                    if ft in ("Q2_K", "IQ3_XS", "IQ3_XXS", "Q3_K_S", "Q3_K_M",
                              "IQ4_NL", "Q4_K_S", "Q4_K_M", "IQ3_S", "IQ3_M",
                              "IQ4_XS"):
                        new_type = GGMLType.Q5_K
                elif ft == "Q2_K":
                    new_type = GGMLType.Q3_K
                elif ft == "IQ3_XXS":
                    new_type = GGMLType.IQ3_S
                elif ft == "Q3_K_M":
                    new_type = GGMLType.Q4_K
                elif ft == "Q3_K_L":
                    new_type = GGMLType.Q5_K
                elif ft == "IQ3_M":
                    new_type = GGMLType.Q4_K
            elif ft == "Q3_K_L":
                new_type = GGMLType.Q4_K
        elif "attn_qkv.weight" in name:
            if ft in ("Q3_K_M", "Q3_K_L", "IQ3_M"):
                new_type = GGMLType.Q4_K
            elif ft == "Q4_K_M":
                new_type = GGMLType.Q5_K
            elif ft == "Q5_K_M":
                new_type = GGMLType.Q6_K
        elif "ffn_gate" in name:
            i_layer = layer_of(self.i_ffn_gate)
            n_layer = self.n_layer
            if ft == "IQ3_XS" and n_layer // 8 <= i_layer < 7 * n_layer // 8:
                new_type = GGMLType.IQ3_XXS
            self.i_ffn_gate += 1
        elif "ffn_up" in name:
            i_layer = layer_of(self.i_ffn_up)
            n_layer = self.n_layer
            if ft == "IQ3_XS" and n_layer // 8 <= i_layer < 7 * n_layer // 8:
                new_type = GGMLType.IQ3_XXS
            self.i_ffn_up += 1

        # K-quant row-size compatibility fallback (@19520-19552)
        if new_type in _K_QUANTS and nx % QK_K != 0:
            new_type = _INCOMPATIBLE_FALLBACK[new_type]
            if nx % _BLOCK_SIZES.get(new_type, 1) != 0:
                new_type = GGMLType.F16
            self.n_fallback += 1

        return new_type
