"""prima-gguf-hash — hash each tensor (and the whole model) of a GGUF.

Counterpart of prima_tpu/tools/gguf_hash.py: a host tool (numpy over GGUF
files, no device), the same output from the same inputs.

The llama-gguf-hash analogue (reference examples/gguf-hash): per-tensor and
overall digests for build verification and model provenance. sha256 and
sha1 come from hashlib; the xxh64 column of the reference is replaced by
crc32 (stdlib) since xxhash is not vendored.

Usage: python -m prima_tpu_torch.tools.gguf_hash model.gguf [--sha1|--sha256|--crc32|--all]
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import zlib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-gguf-hash", description=__doc__)
    ap.add_argument("model")
    ap.add_argument("--sha1", action="store_true")
    ap.add_argument("--sha256", action="store_true")
    ap.add_argument("--crc32", action="store_true")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    algos = []
    if args.sha1 or args.all:
        algos.append("sha1")
    if args.crc32 or args.all:
        algos.append("crc32")
    if args.sha256 or args.all or not algos:
        algos.append("sha256")

    from ..gguf.reader import GGUFReader

    r = GGUFReader(args.model)
    overall = {a: hashlib.new(a) for a in algos if a != "crc32"}
    overall_crc = 0
    for name, ti in r.tensors.items():
        raw = ti.data.tobytes()
        for a in algos:
            if a == "crc32":
                print(f"crc32    {zlib.crc32(raw):08x}  {args.model}:{name}")
                overall_crc = zlib.crc32(raw, overall_crc)
            else:
                h = hashlib.new(a, raw)
                print(f"{a:<8} {h.hexdigest()}  {args.model}:{name}")
                overall[a].update(raw)
    for a in algos:
        if a == "crc32":
            print(f"crc32    {overall_crc:08x}  {args.model}")
        else:
            print(f"{a:<8} {overall[a].hexdigest()}  {args.model}")
    r.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
