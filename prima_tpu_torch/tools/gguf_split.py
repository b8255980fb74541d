"""prima-gguf-split — split a GGUF into shards / merge shards back.

Counterpart of prima_tpu/tools/gguf_split.py: a host tool (numpy over GGUF
files, no device), the same output from the same inputs.

The analogue of examples/gguf-split: shards named
<base>-00001-of-000NN.gguf carrying split.no / split.count /
split.tensors.count metadata (common/common.h:569-571); the reader
(GGUFModel.open) already consumes such sets transparently.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..gguf.reader import GGUFModel
from ..gguf.writer import GGUFWriter

KEY_SPLIT_NO = "split.no"
KEY_SPLIT_COUNT = "split.count"
KEY_SPLIT_TENSORS_COUNT = "split.tensors.count"


def split_gguf(src_path: str, out_base: str, max_tensors: int = 128) -> list[str]:
    src = GGUFModel.open(src_path)
    names = list(src.tensors)
    groups = [names[i : i + max_tensors] for i in range(0, len(names), max_tensors)]
    n = len(groups)
    paths = []
    for i, group in enumerate(groups):
        path = f"{out_base}-{i + 1:05d}-of-{n:05d}.gguf"
        w = GGUFWriter(path)
        if i == 0:  # all model metadata rides the first shard
            for key, val in src.metadata.items():
                if not key.startswith("split."):
                    w.add_kv(key, val)
        else:
            w.add_kv("general.architecture", src.arch)
        w.add_kv(KEY_SPLIT_NO, i, None)
        w.add_kv(KEY_SPLIT_COUNT, n, None)
        w.add_kv(KEY_SPLIT_TENSORS_COUNT, len(names), None)
        for name in group:
            ti = src.tensors[name]
            w.add_tensor(name, ti.data, ne=ti.ne, ggml_type=ti.ggml_type)
        w.write()
        paths.append(path)
    src.close()
    return paths


def merge_gguf(first_shard: str, dst_path: str) -> int:
    src = GGUFModel.open(first_shard)  # opens the whole split set
    w = GGUFWriter(dst_path)
    for key, val in src.metadata.items():
        if not key.startswith("split."):
            w.add_kv(key, val)
    for name, ti in src.tensors.items():
        w.add_tensor(name, ti.data, ne=ti.ne, ggml_type=ti.ggml_type)
    w.write()
    n = len(src.tensors)
    src.close()
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-gguf-split", description=__doc__)
    ap.add_argument("mode", choices=["split", "merge"])
    ap.add_argument("src", help="source gguf (split: whole file; merge: first shard)")
    ap.add_argument("dst", help="output base (split) or output file (merge)")
    ap.add_argument("--split-max-tensors", type=int, default=128)
    args = ap.parse_args(argv)
    if args.mode == "split":
        paths = split_gguf(args.src, args.dst, args.split_max_tensors)
        print("\n".join(paths))
    else:
        n = merge_gguf(args.src, args.dst)
        print(f"merged {n} tensors -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
