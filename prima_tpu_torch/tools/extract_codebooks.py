"""Extract IQ-quant codebook constant tables into .npy artifacts.

The IQ formats (IQ1_S/IQ1_M/IQ2_XXS/...) decode through fixed codebook grids
that are part of the wire format (declared in the reference's
ggml/src/ggml-common.h as GGML_TABLE_BEGIN blocks). These tables are pure
interoperability data — like a Unicode table — and cannot be "redesigned".
This script parses the numeric constants out of a ggml-common.h and writes
them as .npy files consumed by prima_tpu_torch.quant.dequant_np.

Usage: python -m prima_tpu_torch.tools.extract_codebooks path/to/ggml-common.h
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

TABLES = {
    "iq2xxs_grid": np.uint64,
    "iq2xs_grid": np.uint64,
    "iq2s_grid": np.uint64,
    "iq3xxs_grid": np.uint32,
    "iq3s_grid": np.uint32,
    "iq1s_grid": np.uint64,
    "ksigns_iq2xs": np.uint8,
    "kmask_iq2xs": np.uint8,
    "ksigns64": np.uint64,
}

# kvalues_iq4nl lives in ggml-quants.c as a small static array; its 16 values
# are documented in the GGUF spec. We materialize them directly.
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.int8,
)


def extract(header_path: str, out_dir: str) -> None:
    text = open(header_path, "r", errors="replace").read()
    os.makedirs(out_dir, exist_ok=True)
    found = 0
    for m in re.finditer(
        r"GGML_TABLE_BEGIN\((\w+),\s*(\w+),\s*([\w/]+)\)(.*?)GGML_TABLE_END\(\)",
        text,
        re.S,
    ):
        _ctype, name, _count, body = m.groups()
        if name not in TABLES:
            continue
        values = [int(v, 0) for v in re.findall(r"0[xX][0-9a-fA-F]+|\d+", body)]
        arr = np.array(values, dtype=TABLES[name])
        np.save(os.path.join(out_dir, f"{name}.npy"), arr)
        print(f"extracted {name}: {arr.size} x {arr.dtype}")
        found += 1
    np.save(os.path.join(out_dir, "kvalues_iq4nl.npy"), KVALUES_IQ4NL)
    print(f"wrote kvalues_iq4nl: 16 x int8; {found} tables from header")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m prima_tpu_torch.tools.extract_codebooks "
                 "path/to/ggml-common.h")
    header = sys.argv[1]
    out = os.path.join(os.path.dirname(__file__), "..", "quant", "codebooks")
    extract(header, os.path.abspath(out))
