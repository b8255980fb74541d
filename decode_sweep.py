#!/usr/bin/env python3
"""flash_decode's time over the visible length, by cache kind and by the
number of blocks its T split aims at (one NVIDIA GPU, from the repository
root):

    python3 decode_sweep.py                  # the port's DECODE_BLOCKS
    python3 decode_sweep.py --blocks 256,512 # each of these instead, in turn

At the Llama-3-8B attention shape (32 / 8 heads of 128, T = 8192, bf16
queries) it times the kernel over dense, q8_0 and q4_0 caches at positions 0
to 8100 with 4 slots, with one slot and with S = 4, as chip_smoke.py times
its cases (CUDA events, operands rotated past the L2), and fits the 4-slot
times from position 2000 on as a fixed part plus bytes at a rate. It checks
no result: chip_smoke.py and tests/test_torch_cuda.py hold the kernel
against its plain version. Output: one line per case, and the whole as JSON
in chiprun_out/decode_sweep.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

from chip_smoke import ROOT, attn_bound, card_line, copies_for, log, time_ms

CASES = [("4 slots", 4, 1, p) for p in (0, 500, 1000, 2000, 4000, 6000, 8100)] \
    + [("1 slot", 1, 1, 500), ("1 slot", 1, 1, 4000), ("1 slot", 1, 1, 8100),
       ("4 slots, S=4", 4, 4, 4000)]


def sweep(dev, blocks: int | None) -> dict:
    import torch

    from prima_tpu_torch.ops import attention as attn
    from prima_tpu_torch.ops import kvquant as kvq

    if blocks is not None:
        attn.DECODE_BLOCKS = blocks
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    bf16 = torch.bfloat16
    h, kvh, d, t = 32, 8, 128, 8192
    classes = {"q8_0": kvq.KVQ8, "q4_0": kvq.KVQ4}
    out = {}
    for kind in ("dense", "q8_0", "q4_0"):
        cell_bytes = {"dense": 2 * d, "q8_0": d + 4, "q4_0": d // 2 + 4}[kind]
        kvs = []
        for _ in range(copies_for(2 * 4 * t * kvh * cell_bytes)):
            xs = [torch.randn((4, t, kvh, d), generator=gen, device=dev).to(bf16)
                  for _ in range(2)]
            kvs.append(tuple(x if kind == "dense" else classes[kind](*classes[kind].quantize(x))
                             for x in xs))
        rows = []
        for label, b, s, p0 in CASES:
            q = torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16)
            pos = torch.full((b, s), p0, dtype=torch.int32, device=dev) \
                + torch.arange(s, dtype=torch.int32, device=dev)
            ms = time_ms(attn.flash_decode, [(q, k[:b], v[:b], pos, d ** -0.5) for k, v in kvs])
            bound = attn_bound(q.shape, kvh, t, [p0] * b, 2, cell_bytes=cell_bytes)
            rows.append({"case": label, "pos0": p0, "ms": ms, "bytes": bound["bytes"],
                         "bound_ms": bound["bound_ms"],
                         "split": attn.decode_split(b, s, h, kvh, t, bf16)})
            log(f"blocks {attn.DECODE_BLOCKS} {kind:5s} {label:12s} pos {p0:4d}: ms {ms:.4f} "
                f"bound {bound['bound_ms']:.4f} ({bound['bytes'] / 1e6:.1f} MB)")
        fit = [r for r in rows if r["case"] == "4 slots" and r["pos0"] >= 2000]
        xs, ys = [r["bytes"] for r in fit], [r["ms"] for r in fit]
        mx, my = statistics.fmean(xs), statistics.fmean(ys)
        slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
                 / sum((x - mx) ** 2 for x in xs))
        out[kind] = {"cases": rows, "fit_from_pos_2000": {"fixed_ms": my - slope * mx,
                                                          "stream_gbs": 1e-6 / slope}}
        log(f"blocks {attn.DECODE_BLOCKS} {kind}: {my - slope * mx:.4f} ms + bytes at "
            f"{1e-6 / slope:.0f} GB/s (least squares over positions 2000-8100)")
        del kvs
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", default="",
                    help="comma-separated block counts to try in place of DECODE_BLOCKS")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log("card:", card)
    settings = [int(x) for x in args.blocks.split(",") if x] or [None]
    result = {"card": card, "flash_decode": {}}
    for blocks in settings:
        r = sweep(dev, blocks)
        from prima_tpu_torch.ops import attention as attn
        result["flash_decode"][str(attn.DECODE_BLOCKS)] = r
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "decode_sweep.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
