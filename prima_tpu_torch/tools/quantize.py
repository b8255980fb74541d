"""prima-quantize — GGUF -> GGUF re-quantization.

Counterpart of prima_tpu/tools/quantize.py: a host tool (numpy over GGUF
files, no device), the same output from the same inputs.

The analogue of examples/quantize + llama_model_quantize_internal
(src/llama.cpp:19614): every 2-D weight tensor is (de)quantized to the
target ftype; 1-D tensors (norms, biases) stay f32; the token embedding and
output head get the ftype's designated types (Q4_K_M keeps output at Q6_K,
mirroring the reference's per-tensor rules).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFModel
from ..gguf.writer import GGUFWriter
from ..quant.dequant_np import dequantize_tensor
from ..quant.quantize_np import quantize

# ftype name -> (default weight type, output/embd type)
FTYPES: dict[str, tuple[GGMLType, GGMLType]] = {
    "Q4_0": (GGMLType.Q4_0, GGMLType.Q6_K),
    "Q4_1": (GGMLType.Q4_1, GGMLType.Q6_K),
    "Q5_0": (GGMLType.Q5_0, GGMLType.Q6_K),
    "Q5_1": (GGMLType.Q5_1, GGMLType.Q6_K),
    "Q8_0": (GGMLType.Q8_0, GGMLType.Q8_0),
    "Q2_K": (GGMLType.Q2_K, GGMLType.Q6_K),
    "Q3_K": (GGMLType.Q3_K, GGMLType.Q6_K),
    "Q4_K": (GGMLType.Q4_K, GGMLType.Q6_K),
    "Q4_K_M": (GGMLType.Q4_K, GGMLType.Q6_K),
    "Q5_K": (GGMLType.Q5_K, GGMLType.Q6_K),
    "Q5_K_M": (GGMLType.Q5_K, GGMLType.Q6_K),
    "Q6_K": (GGMLType.Q6_K, GGMLType.Q6_K),
    "IQ4_NL": (GGMLType.IQ4_NL, GGMLType.Q6_K),
    "IQ4_XS": (GGMLType.IQ4_XS, GGMLType.Q6_K),
    "IQ2_XXS": (GGMLType.IQ2_XXS, GGMLType.Q5_K),
    "IQ2_XS": (GGMLType.IQ2_XS, GGMLType.Q5_K),
    "IQ2_S": (GGMLType.IQ2_S, GGMLType.Q5_K),
    "IQ3_XXS": (GGMLType.IQ3_XXS, GGMLType.Q5_K),
    "IQ3_S": (GGMLType.IQ3_S, GGMLType.Q5_K),
    "IQ1_S": (GGMLType.IQ1_S, GGMLType.Q5_K),
    "IQ1_M": (GGMLType.IQ1_M, GGMLType.Q5_K),
    # ternary (BitNet b1.58); token-embd/output fall back to Q4_K
    # (llama_model_quantize_internal @19331-19333)
    "TQ1_0": (GGMLType.TQ1_0, GGMLType.Q4_K),
    "TQ2_0": (GGMLType.TQ2_0, GGMLType.Q4_K),
    "F16": (GGMLType.F16, GGMLType.F16),
    "BF16": (GGMLType.BF16, GGMLType.BF16),
    "F32": (GGMLType.F32, GGMLType.F32),
    # ARM-repack ftype names (compat): the reference removed them from GGUF
    # files — "use Q4_0 and runtime repack" (include/llama.h:187-189,
    # ggml/include/ggml.h:388-390). We accept the names and emit plain
    # Q4_0; the repack role (load-time interleaved relayout) lives in
    # quant/device_format.py, applied when tensors reach the chip.
    "Q4_0_4_4": (GGMLType.Q4_0, GGMLType.Q6_K),
    "Q4_0_4_8": (GGMLType.Q4_0, GGMLType.Q6_K),
    "Q4_0_8_8": (GGMLType.Q4_0, GGMLType.Q6_K),
}


def build_planner(src: GGUFModel, ftype: str, has_imatrix: bool):
    """Derive quantize_state_internal fields from the GGUF metadata +
    tensor stream (llama_model_quantize_internal @19660-19690)."""
    from ..quant.type_rules import QuantPlanner

    md = src.metadata
    arch = md.get("general.architecture", "llama")

    def kv(suffix, default=0):
        return int(md.get(f"{arch}.{suffix}", default))

    n_layer = kv("block_count", 1)
    n_head = kv("attention.head_count", 1)
    n_head_kv = kv("attention.head_count_kv", n_head) or n_head
    n_expert = kv("expert_count", 0)
    n_wv = sum(1 for n in src.tensors if "attn_v.weight" in n)
    n_down = sum(1 for n in src.tensors if "ffn_down" in n)
    has_output = "output.weight" in src.tensors
    # MODEL_70B heuristic: 80 layers + 8-way GQA (llm_load_hparams)
    model_70b = n_layer == 80 and n_head_kv and n_head // n_head_kv == 8
    return QuantPlanner(
        ftype=ftype, n_layer=n_layer,
        n_gqa=n_head // n_head_kv if n_head_kv else 1,
        n_expert=n_expert, arch=arch, has_imatrix=has_imatrix,
        has_output=has_output, model_70b=model_70b,
        n_attention_wv=n_wv or n_layer, n_ffn_down=n_down or n_layer)


def _target_type_simple(name: str, ne, default: GGMLType,
                        out_type: GGMLType) -> GGMLType:
    """Stateless per-tensor rule for the HF converter's direct-quantized
    outputs (convert_hf_to_gguf.py supports F32/F16/BF16/Q8_0, where the
    full planner's layer-aware mixes don't apply)."""
    if len([d for d in ne if d > 1]) < 2:
        return GGMLType.F32  # norms / biases stay f32
    if name in ("output.weight", "token_embd.weight"):
        return out_type
    return default


def _target_type(planner, name: str, ne) -> GGMLType:
    # the reference quantizes only 2-D ".weight" tensors (@19753-19783);
    # norms/biases/1-D stay f32
    if len([d for d in ne if d > 1]) < 2 or not name.endswith(".weight"):
        return GGMLType.F32
    # numpy row-major shape: (rows, ne0) — get_type keys on ne[0]
    return planner.get_type(name, (int(ne[-1]), int(ne[0])))


def _encode(x: np.ndarray, t: GGMLType,
            qw: np.ndarray | None = None) -> tuple[np.ndarray | bytes, GGMLType]:
    if t == GGMLType.F32:
        return x.astype(np.float32), t
    if t == GGMLType.F16:
        return x.astype(np.float16), t
    try:
        if qw is not None:
            from ..quant.quantize_imatrix import quantize_weighted

            return quantize_weighted(x, t, qw), t
        return quantize(x, t), t
    except (NotImplementedError, ValueError):
        # row size incompatible with the block format: keep f16
        return x.astype(np.float16), GGMLType.F16


def quantize_gguf(src_path: str, dst_path: str, ftype: str,
                  imatrix: dict | None = None, logfile=sys.stderr) -> dict:
    """imatrix: name -> per-column importance (from quantize_imatrix.
    load_imatrix) — enables activation-weighted encoding for K-quants, the
    analogue of llama-quantize --imatrix."""
    from ..quant.type_rules import FTYPE_DEFAULT

    ftype = ftype.upper()
    if ftype.startswith("Q4_0_"):
        print(f"{ftype}: ARM-repack types were removed from GGUF files "
              "(reference llama.h:187-189) — emitting Q4_0; the "
              "interleaved relayout happens at load time "
              "(quant/device_format.py)", file=logfile)
        ftype = "Q4_0"
    default_t = FTYPE_DEFAULT.get(ftype, FTYPES[ftype][0])
    src = GGUFModel.open(src_path)
    planner = build_planner(src, ftype, has_imatrix=imatrix is not None)
    w = GGUFWriter(dst_path)
    for key, val in src.metadata.items():
        if key == "general.file_type":
            continue
        w.add_kv(key, val)
    w.add_kv("general.file_type", int(default_t))

    stats = {"n_tensors": 0, "in_bytes": 0, "out_bytes": 0}
    t0 = time.time()
    for name, ti in src.tensors.items():
        x = dequantize_tensor(ti).astype(np.float32)
        t = _target_type(planner, name, ti.ne)
        qw = imatrix.get(name) if imatrix else None
        if qw is not None and len(qw) != ti.ne[0]:
            qw = None  # shape mismatch (e.g. different model): ignore
        data, t = _encode(x, t, qw)
        if isinstance(data, np.ndarray) and t in (GGMLType.F32, GGMLType.F16):
            w.add_tensor(name, data)
        else:
            w.add_tensor(name, data, ne=ti.ne, ggml_type=t)
        stats["n_tensors"] += 1
        stats["in_bytes"] += ti.nbytes
        stats["out_bytes"] += len(data) if isinstance(data, bytes) else data.nbytes
        print(f"[{stats['n_tensors']:4d}] {name:40s} {ti.ggml_type.name:8s}"
              f" -> {t.name:8s}", file=logfile)
    w.write()
    stats["seconds"] = time.time() - t0
    src.close()
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-quantize", description=__doc__)
    ap.add_argument("src")
    ap.add_argument("dst")
    from ..quant.type_rules import FTYPE_DEFAULT

    ap.add_argument("ftype", choices=sorted(set(FTYPES) | set(FTYPE_DEFAULT)),
                    help="target ftype (incl. _S/_M/_L size mixes)")
    ap.add_argument("--imatrix", help="importance matrix file (prima-imatrix)")
    args = ap.parse_args(argv)
    imatrix = None
    if args.imatrix:
        from ..quant.quantize_imatrix import load_imatrix

        imatrix = load_imatrix(args.imatrix)
        print(f"loaded {len(imatrix)} imatrix entries from {args.imatrix}",
              file=sys.stderr)
    stats = quantize_gguf(args.src, args.dst, args.ftype, imatrix=imatrix)
    print(f"quantized {stats['n_tensors']} tensors: "
          f"{stats['in_bytes'] / 2**20:.1f} MiB -> {stats['out_bytes'] / 2**20:.1f} MiB "
          f"in {stats['seconds']:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
