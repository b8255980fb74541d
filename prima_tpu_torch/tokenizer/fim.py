"""Fill-in-the-middle (FIM/infill) token detection and prompt assembly.

The analogue of llama_token_prefix/suffix/middle (reference
src/llama.cpp llama_token_* accessors) plus the prompt construction shared
by examples/infill/infill.cpp:204-221 and server.cpp's /infill handler:

  [FIM_PRE] prefix [FIM_SUF] suffix [FIM_MID]        (PSM, default)
  [FIM_SUF] suffix [FIM_PRE] prefix [FIM_MID]        (SPM, --spm-infill)

Token names are probed against the known FIM families (starcoder, qwen,
deepseek, codellama) since GGUFs carry them as ordinary vocab entries.
"""

from __future__ import annotations

FIM_FAMILIES = [
    ("<|fim_prefix|>", "<|fim_suffix|>", "<|fim_middle|>"),  # qwen/starcoder2
    ("<fim_prefix>", "<fim_suffix>", "<fim_middle>"),        # starcoder
    ("<|fim▁begin|>", "<|fim▁hole|>", "<|fim▁end|>"),        # deepseek
    ("<PRE>", "<SUF>", "<MID>"),                             # codellama
    ("▁<PRE>", "▁<SUF>", "▁<MID>"),                          # codellama SPM pieces
]


def detect_fim_tokens(vocab) -> tuple[int, int, int] | None:
    """-> (prefix_id, suffix_id, middle_id) or None if the model has no
    FIM tokens. Prefers the explicit GGUF KVs (tokenizer.ggml.prefix/
    suffix/middle_token_id — what llama_token_prefix reads); falls back
    to probing the known FIM token-name families."""
    ids = (getattr(vocab, "fim_pre_id", -1), getattr(vocab, "fim_suf_id", -1),
           getattr(vocab, "fim_mid_id", -1))
    if all(i >= 0 for i in ids):
        return ids
    for names in FIM_FAMILIES:
        if all(n in vocab.token_to_id for n in names):
            return tuple(vocab.token_to_id[n] for n in names)
    return None


def build_infill_prompt(tokenizer, prefix: str, suffix: str,
                        spm_infill: bool = False) -> list[int]:
    """Assemble the infill prompt tokens; raises ValueError when the model
    has no FIM tokens (the GGML_ASSERT at infill.cpp:208-209)."""
    v = tokenizer.vocab
    fim = detect_fim_tokens(v)
    if fim is None:
        raise ValueError("model has no FIM (infill) special tokens")
    pre_id, suf_id, mid_id = fim
    inp_pfx = [pre_id] + tokenizer.encode(prefix, add_special=False)
    inp_sfx = [suf_id] + tokenizer.encode(suffix, add_special=False)
    first, second = (inp_sfx, inp_pfx) if spm_infill else (inp_pfx, inp_sfx)
    # BOS leads the infill prompt like any other (infill.cpp:210-216)
    bos = [v.bos_id] if getattr(v, "add_bos", False) and v.bos_id >= 0 else []
    return bos + first + second + [mid_id]
