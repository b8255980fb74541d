#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (prima_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, from the repository root

Phases, each of which fails the run on any error or mismatch:
  1. build   — compile every CUDA kernel of the port with nvcc (in parallel).
  2. kernels — each kernel against its plain PyTorch version on the card at
               the main path's shapes, timed with CUDA events (median of 20
               windows after warm-up, operands rotated past the 50 MB L2), beside
               its bound and the library call that computes the same
               function, where there is one: the GEMV at B = 1, 4, 8, 31 and
               at the narrow split-K shapes (N = 1024, N = 256); the
               expert-indexed GEMV at Mixtral-8x7B's expert shapes (2 to 30
               pairs on 2 to 8 distinct experts, Q4_K, Q6_K and Q8_0) and at
               Qwen1.5-MoE-A2.7B's gate/up (60 experts, top-4), with equal
               bits over four runs and for a pair alone; the KV
               write at the shapes of the server's slot restore (int8 codes
               and f32 scales into a one-slot view) and at 8B rows (exact
               bits); the fused KV store of a layer over dense, q8_0 and
               q4_0 caches (exact bits); flash decode over dense, q8_0 and
               q4_0 caches, NaN past each visible prefix, four runs with
               equal bits; flash prefill in bf16 and f32 at 256 rows
               at positions 0, 3840 and 7936 of 8192, 129 rows, 9 rows and
               the tiny pair's head of 64, the cells past each prefix filled
               with NaN; the device-memory read probe over 1 GiB (exact),
               with its rate beside the nominal 3.35 TB/s.
  3. server  — python -m prima_tpu_torch.server on the trained tiny model:
               concurrent /completion requests and one chat request, once
               with the defaults and once with -ctk q8_0 -gan 2 -gaw 64
               --slot-save-path (then slot 0 saved and restored into slot
               1); then the Engine's greedy streams on the card (every
               kernel) against the CPU (plain path), in f32: the default
               path, flash attention, flash attention over a q8_0 and
               over a q4_0 cache, and flash attention under Self-Extend;
               and the same for a tiny gemma2 (softcap, sliding window,
               post norms, GeGLU) and a tiny qwen2moe (the indexed GEMV,
               a shared expert).
  4. full    — the Llama-3-8B shape with Q4_K weights generated on the card:
               Engine(n_slots=4, max_seq=2048) serves 8 requests through
               submit + step_fused(max_chunk=8); the kernels' launch counts
               of this run; one decode step's logits, kernels vs plain.
  5. long    — the same weights, Engine(n_slots=4, max_seq=8192,
               attn_impl="kernel") serves 4 requests of ~4000 prompt tokens
               and 32 greedy tokens; the launch counts of the model kernels
               in this run; a prefill chunk at position 3840 and a decode
               chunk profiled, the latter with flash and with plain
               attention; then a second engine with a q8_0 cache
               (kv_dtype="q8_0") serves 4 such requests of 16 greedy tokens,
               with its launch counts and a profiled decode chunk in which
               no quantized cache may be materialized; one decode step near
               position 4000 over f32 caches and over seeded q8_0 caches,
               every kernel against every plain version.
  6. moe     — Mixtral-8x7B at full width and depth (8 experts, top-2),
               centred Q4_K weights generated on the card after the 8B
               weights are freed: Engine(n_slots=4, max_seq=4096,
               attn_impl="kernel") serves 4 requests of 480-512 prompt
               tokens and 32 greedy tokens; the launch counts of every
               kernel in that run (the indexed GEMV's are the kernels
               line's) and the distinct experts its indexed launches read;
               a decode chunk profiled, beside the bound of its indexed
               launches at those ids; one decode step's logits, every
               kernel vs plain. The served decode and the logits check
               must each reach more than 2 distinct experts a launch.
The decoder writes K and V through the fused KV store; the byte-generic KV
write runs where a saved slot is restored, so its launches are the server's
(phase 3). The device-memory probe is on no serving path: its launches are
those of its own entry point, hbm_probe.measure, run with its count set to 0
before.

Output: one line per case and phase, then a {"kernels": [...]} JSON line,
the card's name and power limit from nvidia-smi, and last
{"ok": true, "device": {...}}. Without a GPU, or outside the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import http.client
import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
L2_BYTES = 50 * 2 ** 20
ROOT = os.path.dirname(os.path.abspath(__file__))
LLAMA3_8B = dict(n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=8, head_dim=128,
                 n_ff=14336, n_vocab=128256, n_ctx_train=8192, rope_base=500000.0,
                 rope_dim=128)  # bench.py model_shape("8b")
# Mixtral-8x7B-v0.1's config.json: 8 experts, top-2, RoPE base 1e6
MIXTRAL = dict(n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=8, head_dim=128,
               n_ff=14336, n_vocab=32000, n_ctx_train=32768, rope_base=1e6, rope_dim=128,
               rms_eps=1e-5, n_expert=8, n_expert_used=2)
# max |kernel - plain| / max |plain|, f32: sums in another order; for nib4
# weights on the tensor cores also x taken as two bf16 parts, a residual of
# <= 2^-17 |x| per term (measured ~3e-6 of max |plain|)
GEMV_TOL = 1e-4
LOGITS_TOL = 1e-3  # the same over 32 layers of kernels vs plain
# flash attention against its plain version: f32 max|err| <= 2e-5 *
# max(1, max|plain|) (sums in another order, the tolerance the JAX package
# holds its kernel to); bf16 outputs within 1e-2 * max|plain| (one bf16
# rounding of the output apart; the tensor-core prefill kernel also rounds
# each probability to bf16 before P.V, <= 2^-9 relative per term, which
# lies inside the same bound)
ATTN_F32_TOL = 2e-5
ATTN_BF16_TOL = 1e-2


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, args_list: list, reps: int = 20, per_rep: int = 8,
            warmup: int = 3) -> float:
    """Median device ms per call of fn(*args) over `reps` CUDA-event
    windows of `per_rep` calls each, cycling through args_list so each call
    finds its operands outside the L2 cache. A device-side sleep before
    each window lets the host queue the window's calls first, so the
    window times the device, not the Python wrapper."""
    import torch

    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    times = []
    j = 0
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        a.record()
        for _ in range(per_rep):
            fn(*args_list[j % len(args_list)])
            j += 1
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_rep)
    return statistics.median(times)


def copies_for(nbytes: int) -> int:
    return max(1, min(64, -(-2 * L2_BYTES // max(nbytes, 1))))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def gemv_cases():
    """(format, shape label, N, K, B list) at the main path's shapes."""
    from prima_tpu_torch.gguf.constants import GGMLType as T

    e, f, v, kv = 4096, 14336, 128256, 1024
    big = [("wq/wo", e, e), ("wk/wv", kv, e), ("gate/up", f, e), ("down", e, f),
           ("head", v, e)]
    cases = [(t, lab, n, k, (1, 4, 8, 31)) for t in (T.Q4_K, T.Q6_K, T.Q8_0, T.Q4_0, T.Q5_K)
             for lab, n, k in big]
    # the narrowest split-K shape: two row blocks, 16 slices of K each
    cases += [(t, "N=256 (split K)", 256, e, (1, 4, 8)) for t in (T.Q4_K, T.Q8_0)]
    # tiny models: the trained pair (Q8_0, width 256 / 128, head 259) and the
    # make_tiny_gguf widths (Q4_K grouped at 256, packed at 512)
    cases += [(T.Q8_0, "tiny-pair qkvo", 256, 256, (1, 4, 8)),
              (T.Q8_0, "tiny-pair down", 256, 704, (1, 4)),
              (T.Q8_0, "tiny-pair head", 259, 256, (1, 4)),
              (T.Q8_0, "tiny-draft gate", 352, 128, (1, 4)),
              (T.Q4_K, "tiny-256 (grouped)", 512, 256, (1, 4, 16)),
              (T.Q4_K, "tiny-512 (packed)", 1024, 512, (1, 4))]
    return cases


def gemv_bytes(qt, b: int) -> int:
    return qt.nbytes + b * qt.n_cols * 4 + b * qt.n_rows * 4


def gemv_bound_ms(qt, b: int) -> tuple[float, str]:
    t_bytes = gemv_bytes(qt, b) / HBM_BYTES_PER_S
    t_ops = 2.0 * b * qt.n_rows * qt.n_cols / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev, report: dict) -> None:
    import torch

    from prima_tpu_torch.models.llama import synth_qtensor_device
    from prima_tpu_torch.ops import kv_write as kvw
    from prima_tpu_torch.quant import qmatmul as qm

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    gcases, worst = [], (0.0, 0.0)
    for t, label, n, k, bs in gemv_cases():
        qts = [synth_qtensor_device(gen, n, k, t, dev)]
        qts += [synth_qtensor_device(gen, n, k, t, dev)
                for _ in range(copies_for(qts[0].nbytes) - 1)]
        qt = qts[0]
        for b in bs:
            x = torch.randn((b, k), generator=gen, device=dev)
            y = qm.qgemv(x, qt)
            ref = qm.qmatmul_plain(x, qt)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = err <= GEMV_TOL * scale
            worst = max(worst, (err, err / scale))
            ms = time_ms(qm.qgemv, [(x, q) for q in qts])
            plain = time_ms(qm.qmatmul_plain, [(x, q) for q in qts[:4]], per_rep=2)
            bound, by = gemv_bound_ms(qt, b)
            ksplit, ksb = qm.gemv_split(n, qt.qs.shape[1], b, qt.layout)
            case = {"format": t.name, "shape": label, "N": n, "K": k, "B": b,
                    "layout": qt.layout, "scales": qm.scale_mode(qt),
                    "ksplit": ksplit, "slice_bytes": ksb,
                    "max_abs_err": err, "max_abs_ref": scale, "ms": ms,
                    "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                    "bytes": gemv_bytes(qt, b)}
            gcases.append(case)
            log(f"qgemv {t.name:5s} {label:18s} B={b:<2d} {qm.scale_mode(qt):7s} "
                f"ksplit {ksplit:<2d} err {err:.2e}/{scale:.2e} ms {ms:.4f} "
                f"plain {plain:.4f} bound {bound:.4f} ({by})")
            if not ok:
                raise AssertionError(f"qgemv {t.name} {label} B={b}: max |err| {err} "
                                     f"> {GEMV_TOL} * {scale}")
        del qts
        torch.cuda.empty_cache()
    report["qgemv"]["cases"] = gcases
    report["qgemv"]["max_abs_err"] = worst[0]
    report["qgemv"]["max_rel_err"] = worst[1]
    report["qgemv"]["tolerance"] = f"max|err| <= {GEMV_TOL} * max|plain| (f32)"

    # (label, slots of the cache, B, S, T, a cell's shape, dtype, pos); the
    # first two are the launches of the main path: a slot of 59 saved cells
    # restored into slot 1 of the tiny pair's q8_0 cache (4 KV heads of 64,
    # 512 cells, 4 slots), int8 codes and f32 scales written at cell 0 of a
    # one-slot view. The 8B shapes are the decoder's of earlier versions.
    kcases = []
    for label, slots, b, s, t_, cell, dt, pos in [
            ("tiny-pair q8_0 slot restore, codes (main path)", 4, 1, 59, 512, (4, 64),
             torch.int8, [0]),
            ("tiny-pair q8_0 slot restore, scales (main path)", 4, 1, 59, 512, (4, 1),
             torch.float32, [0]),
            ("8B decode", 4, 4, 1, 2048, (1024,), torch.bfloat16, [5, 700, 2047, 1300]),
            ("8B prefill (slot row)", 1, 1, 128, 2048, (1024,), torch.bfloat16, [256]),
            ("8B prefill 256 (slot row)", 1, 1, 256, 2048, (1024,), torch.bfloat16, [0]),
            ("clamp at T-S", 4, 4, 8, 2048, (1024,), torch.bfloat16, [2045, 0, 3000, 17]),
            ("tiny-pair decode f32", 4, 4, 1, 512, (256,), torch.float32, [0, 1, 2, 511]),
            ("draft decode P=128", 4, 4, 1, 512, (128,), torch.bfloat16, [3, 9, 27, 81])]:

        def rand(*shape):
            if dt == torch.int8:
                return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=dt)
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        new = rand(b, s, *cell)
        nbytes = 2 * new.numel() * new.element_size()
        # a one-slot view (slot 1) where the cache has more slots than rows written
        view = (lambda c: c[1:1 + b]) if slots > b else (lambda c: c)
        caches = [rand(slots, t_, *cell) for _ in range(copies_for(nbytes))]
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        want, got = caches[0].clone(), caches[0].clone()
        kvw.kv_write_plain(view(want), new, pos_t)
        kvw.kv_write(view(got), new, pos_t)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rows = (kvw.write_starts(pos_t, t_, s)[:, None]
                + torch.arange(s, device=dev)
                + torch.arange(b, device=dev)[:, None] * t_).reshape(-1)
        flat_new = new.reshape(b * s, -1)
        ms = time_ms(kvw.kv_write, [(view(c), new, pos_t) for c in caches])
        plain = time_ms(kvw.kv_write_plain, [(view(c), new, pos_t) for c in caches])
        lib = time_ms(lambda c: view(c).view(b * t_, -1).index_copy_(0, rows, flat_new),
                      [(c,) for c in caches])
        case = {"shape": label, "slots": slots, "B": b, "S": s, "T": t_, "cell": list(cell),
                "dtype": str(dt), "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "library_ms": lib, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "bytes": nbytes}
        kcases.append(case)
        log(f"kv_write {label:48s} err {err} ms {ms:.4f} plain {plain:.4f} "
            f"index_copy_ {lib:.4f} bound {case['bound_ms']:.6f}")
        if err != 0.0:
            raise AssertionError(f"kv_write {label}: max |err| {err} (must be exact)")
    report["kv_write"]["cases"] = kcases
    report["kv_write"]["max_abs_err"] = max(c["max_abs_err"] for c in kcases)
    report["kv_write"]["tolerance"] = "exact"
    # headline numbers: the larger launch of the main path, the codes of a
    # restored slot (each restore writes codes and scales, K and V, per layer)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        report["kv_write"][key] = kcases[0][key]
    report["kv_write"]["headline"] = kcases[0]["shape"]
    phase_kv_store(dev, report, gen)
    step = [c for c in gcases if c["format"] == "Q4_K" and c["B"] == 4
            and c["N"] >= 1024 and c["K"] >= 4096]
    per_step = {"wq/wo": 64, "wk/wv": 64, "gate/up": 64, "down": 32, "head": 1}
    for key in ("ms", "plain_ms", "bound_ms"):  # one 8B decode step at B = 4
        report["qgemv"][key] = sum(per_step[c["shape"]] * c[key] for c in step)
    report["qgemv"]["bound_by"] = "bytes"
    report["qgemv"]["library_ms"] = None
    report["qgemv"]["headline"] = ("sum over the 225 GEMV launches of one 8B Q4_K "
                                   "decode step at B = 4")
    # the same sum at B = 1 and B = 8, and what a launch costs whatever its
    # size: least squares of ms = fixed + bytes / rate over the five shapes
    report["qgemv"]["step_ms_by_batch"] = {
        b: sum(per_step[c["shape"]] * c["ms"] for c in gcases
               if c["format"] == "Q4_K" and c["B"] == b and c["shape"] in per_step)
        for b in (1, 4, 8)}
    xs, ys = [c["bytes"] for c in step], [c["ms"] for c in step]
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    report["qgemv"]["launch_fit"] = {"fixed_ms": my - slope * mx,
                                     "stream_gbs": 1e-6 / slope}
    log(f"qgemv 8B Q4_K step: {json.dumps(report['qgemv']['step_ms_by_batch'])} ms by B; "
        f"a launch at B = 4 costs {my - slope * mx:.4f} ms + bytes at "
        f"{1e-6 / slope:.0f} GB/s (least squares over the five shapes)")
    phase_indexed_gemv(dev, report, gen)
    phase_attention(dev, report)
    phase_probe(dev, report)


def indexed_cases():
    """(format, label, N, K, experts, ids, per_expert) at Mixtral-8x7B's
    expert shapes (8 experts) unless labelled otherwise: top-2 of one row
    (B = 1) and of four rows (B = 4, 8 pairs, repeated and out-of-order
    ids); four rows all on experts {0, 1} (8 pairs, 2 distinct) beside 2
    pairs on those two; 8 rows of top-2, once at random and once with every
    row on one expert (two passes of 4 columns); 15 rows of top-2 with 10
    or more pairs on one expert (three passes or four); Qwen1.5-MoE-A2.7B's
    gate/up (60 experts, top-4, B = 4: most slots empty); Q6_K and Q8_0 on
    the CUDA cores. `per_expert` is what moe_ffn passes: the row count."""
    import random

    from prima_tpu_torch.gguf.constants import GGMLType as T

    rng = random.Random(6)
    b1, b4 = [5, 2], [3, 1, 1, 6, 7, 3, 0, 2]
    two = [0, 1, 1, 0, 0, 1, 1, 0]
    rows8 = [e for _ in range(8) for e in rng.sample(range(8), 2)]
    heavy8 = [e for _ in range(8) for e in (3, rng.choice([0, 1, 2, 4, 5, 6, 7]))]
    rows15 = [e for r in range(15) for e in (
        [3, rng.choice([0, 1, 2, 4, 5, 6, 7])] if r < 10 else rng.sample(range(8), 2))]
    qwen = [e for _ in range(4) for e in rng.sample(range(60), 4)]
    f, e = MIXTRAL["n_ff"], MIXTRAL["n_embd"]
    return [(T.Q4_K, "gate/up", f, e, 8, b1, 1), (T.Q4_K, "gate/up", f, e, 8, b4, 4),
            (T.Q4_K, "down", e, f, 8, b1, 1), (T.Q4_K, "down", e, f, 8, b4, 4),
            (T.Q6_K, "down", e, f, 8, b4, 4), (T.Q4_K, "gate/up", f, e, 8, [0, 1], 1),
            (T.Q4_K, "gate/up", f, e, 8, two, 4), (T.Q4_K, "gate/up", f, e, 8, rows8, 8),
            (T.Q4_K, "gate/up", f, e, 8, heavy8, 8),
            (T.Q4_K, "gate/up", f, e, 8, rows15, 15),
            (T.Q4_K, "qwen1.5-moe gate/up", 1408, 2048, 60, qwen, 4),
            (T.Q6_K, "down", e, f, 8, two, 4), (T.Q8_0, "gate/up", f, e, 8, b4, 4)]


def phase_indexed_gemv(dev, report: dict, gen) -> None:
    """The expert-indexed GEMV against its plain version (qmatmul_plain of
    each expert's slice for its pairs) on stacked experts. Each case also
    gives equal bits over four runs, leaves every arrival counter at 0, and
    gives a pair that shares its expert the bits it gets alone under the
    same K cut (alone, an int8 pair takes the 1-column template: a column's
    sums are its own). Its bound reads each distinct expert's bytes once, as
    the kernel does."""
    import torch

    from prima_tpu_torch.models.llama import synth_qtensor_device
    from prima_tpu_torch.quant import qmatmul as qm

    out_cases = []
    for t, label, n, k, n_exp, ids, per_expert in indexed_cases():
        qts = [synth_qtensor_device(gen, n_exp * n, k, t, dev)]
        slice_bytes = qts[0].nbytes // n_exp
        qts += [synth_qtensor_device(gen, n_exp * n, k, t, dev)
                for _ in range(copies_for(len(set(ids)) * slice_bytes) - 1)]
        qt, p = qts[0], len(ids)
        idt = torch.tensor(ids, dtype=torch.int32, device=dev)
        x = torch.randn((p, k), generator=gen, device=dev)

        def run(x_, q, i_):
            return qm.qgemv_indexed(x_, q, i_, n, per_expert=per_expert)

        y = run(x, qt, idt)
        again = [run(x, qt, idt) for _ in range(3)]
        ref = qm.qgemv_indexed_plain(x, qt, idt, n)
        slots, cols, passes, ksplit, ksb = qm.indexed_launch(
            n, qt.qs.shape[1], p, n_exp, per_expert, qt.layout)
        # a pair whose expert others share, alone under the same K cut
        shared = next((i for i, e in enumerate(ids) if ids.count(e) > 1), 0)
        alone = qm.qgemv_indexed(x[shared:shared + 1], qt, idt[shared:shared + 1], n,
                                 ksplit=ksplit)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        scale = ref.abs().max().item()
        same_bits = all(torch.equal(y, a) for a in again)
        alone_bits = torch.equal(alone[0], y[shared])
        counters_zero = all(int(c.count_nonzero()) == 0 for c in qm._done.values())
        ms = time_ms(run, [(x, q, idt) for q in qts])
        plain = time_ms(qm.qgemv_indexed_plain, [(x, q, idt, n) for q in qts[:2]],
                        reps=5, per_rep=2)
        nbytes = len(set(ids)) * slice_bytes + p * k * 4 + p * n * 4
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 2.0 * p * n * k / F32_FLOPS
        case = {"format": t.name, "shape": label, "N": n, "K": k, "P": p, "ids": ids,
                "experts": n_exp, "distinct": len(set(ids)), "per_expert": per_expert,
                "scales": qm.scale_mode(qt), "slots": slots, "cols": cols, "passes": passes,
                "ksplit": ksplit, "slice_bytes": ksb, "max_abs_err": err,
                "max_abs_ref": scale, "equal_bits_4_runs": same_bits,
                "alone_equal_bits": alone_bits, "counters_zero": counters_zero,
                "ms": ms, "plain_ms": plain, "library_ms": None,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
                "pair_bytes": p * slice_bytes}
        out_cases.append(case)
        log(f"qgemv_indexed {t.name:5s} {label:19s} P={p:<2d} {len(set(ids))} experts "
            f"cols {cols} passes {passes} ksplit {ksplit} err {err:.2e}/{scale:.2e} "
            f"ms {ms:.4f} plain {plain:.4f} bound {case['bound_ms']:.4f} "
            f"({nbytes / 1e6:.1f} MB)")
        if not err <= GEMV_TOL * scale:
            raise AssertionError(f"qgemv_indexed {t.name} {label} P={p}: max |err| {err} "
                                 f"> {GEMV_TOL} * {scale}")
        if not (same_bits and alone_bits and counters_zero):
            raise AssertionError(f"qgemv_indexed {t.name} {label} P={p}: equal bits over "
                                 f"4 runs {same_bits}, alone {alone_bits}, counters at 0 "
                                 f"{counters_zero}")
        del qts
        torch.cuda.empty_cache()
    r = report["qgemv_indexed"]
    r["cases"] = out_cases
    r["max_abs_err"] = max(c["max_abs_err"] for c in out_cases)
    r["tolerance"] = f"max|err| <= {GEMV_TOL} * max|plain| (f32)"
    # one Mixtral decode step at B = 4 (8 pairs a launch): gate and up, then
    # down, in each of 32 layers
    mix = [c for c in out_cases if c["format"] == "Q4_K" and c["experts"] == 8]
    step = {c["shape"]: c for c in mix if c["ids"] == [3, 1, 1, 6, 7, 3, 0, 2]}
    for key in ("ms", "plain_ms", "bound_ms"):
        r[key] = MIXTRAL["n_layers"] * (2 * step["gate/up"][key] + step["down"][key])
    r["bound_by"] = "bytes"
    r["library_ms"] = None
    r["headline"] = ("sum over the 96 indexed launches of one Mixtral-8x7B Q4_K decode "
                     "step at B = 4 (8 pairs each, ids " + str(step["down"]["ids"]) + ")")
    # each chosen expert read once: 8 pairs on 2 experts against 2 pairs on them
    by_ids = {str(c["ids"]): c["ms"] for c in mix if c["shape"] == "gate/up"}
    r["read_once_ratio"] = by_ids[str([0, 1, 1, 0, 0, 1, 1, 0])] / by_ids[str([0, 1])]
    log(f"qgemv_indexed Mixtral B = 4 step {r['ms']:.3f} ms (bound {r['bound_ms']:.3f}); "
        f"8 pairs on 2 experts / 2 pairs on them: {r['read_once_ratio']:.3f}")


def phase_kv_store(dev, report: dict, gen) -> None:
    """The fused KV store of one layer against its plain version (update_kv
    for K and for V), exact bits for dense values, codes and scales; its
    time beside the two launches it replaces (two kv_write for a dense
    cache, two update_kv for a quantized one) and two index_copy_."""
    import torch

    from prima_tpu_torch.ops import kv_write as kvw
    from prima_tpu_torch.ops import kvquant as kvq

    bf16, f32 = torch.bfloat16, torch.float32
    h, d = 8, 128
    scases = []
    for label, b, s, t_, kind, dt, pos in [
            ("8B decode, bf16 cache (main path)", 4, 1, 8192, "dense", bf16,
             [4000, 4031, 9000, 4060]),
            ("8B decode, q8_0 cache (main path)", 4, 1, 8192, "q8_0", bf16,
             [4000, 4031, 9000, 4060]),
            ("8B decode, q4_0 cache", 4, 1, 8192, "q4_0", bf16, [4000, 4031, 9000, 4060]),
            ("8B decode, f32 cache", 4, 1, 8192, "dense", f32, [4000, 4031, 9000, 4060]),
            ("8B prefill 256 (slot row), bf16 cache", 1, 256, 8192, "dense", bf16, [3840]),
            ("8B prefill 256 (slot row), q8_0 cache", 1, 256, 8192, "q8_0", bf16, [8000]),
            ("8B prefill 256 (slot row), q4_0 cache", 1, 256, 8192, "q4_0", bf16, [3840]),
            ("8B prefill 256 (slot row), f32 cache", 1, 256, 8192, "dense", f32, [8000])]:
        shape = (b, t_, h, d)

        def make():
            if kind == "dense":
                return tuple(torch.randn(shape, generator=gen, device=dev).to(dt)
                             for _ in range(2))
            cls = kvq.KVQ8 if kind == "q8_0" else kvq.KVQ4
            return cls.zeros(shape, dev), cls.zeros(shape, dev)

        parts = lambda c: (c.qs, c.scale) if kvq.is_quantized(c) else (c,)
        k_new, v_new = (torch.randn((b, s, h, d), generator=gen, device=dev).to(dt)
                        for _ in range(2))
        k_new[0, 0, 0] = 0  # a zero vector: scale 0
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        n_new = 2 * k_new.numel()
        cell_bytes = {"dense": k_new.element_size(), "q8_0": 1 + 4 / d, "q4_0": 0.5 + 4 / d}
        nbytes = int(n_new * (k_new.element_size() + cell_bytes[kind]))
        caches = [make() for _ in range(copies_for(nbytes))]
        got, want = caches[0], make()
        if kind == "dense":
            for g, w in zip(got, want):
                w.copy_(g)
        kvw.kv_store(*got, k_new, v_new, pos_t)
        kvw.kv_store_plain(*want, k_new, v_new, pos_t)
        torch.cuda.synchronize()
        exact = all(torch.equal(x, y) for g, w in zip(got, want)
                    for x, y in zip(parts(g), parts(w)))
        err = max((x.float() - y.float()).abs().max().item() for g, w in zip(got, want)
                  for x, y in zip(parts(g), parts(w)))
        ms = time_ms(kvw.kv_store, [(*c, k_new, v_new, pos_t) for c in caches])
        plain = time_ms(kvw.kv_store_plain, [(*c, k_new, v_new, pos_t) for c in caches],
                        reps=10)

        def two_launches(kc, vc):  # what the decoder launched before the fused store
            kvq.update_kv(kc, k_new, pos_t)
            kvq.update_kv(vc, v_new, pos_t)

        two = time_ms(two_launches, caches, reps=10)
        lib = None
        if kind == "dense":
            rows = (kvw.write_starts(pos_t, t_, s)[:, None] + torch.arange(s, device=dev)
                    + torch.arange(b, device=dev)[:, None] * t_).reshape(-1)
            flat = [x.reshape(b * s, h * d) for x in (k_new, v_new)]

            def two_index_copies(kc, vc):
                kc.view(b * t_, h * d).index_copy_(0, rows, flat[0])
                vc.view(b * t_, h * d).index_copy_(0, rows, flat[1])

            lib = time_ms(two_index_copies, caches)
        case = {"shape": label, "B": b, "S": s, "T": t_, "H": h, "D": d, "cache": kind,
                "dtype": str(dt), "exact": exact, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "two_launches_ms": two, "library_ms": lib,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "bytes": nbytes}
        scases.append(case)
        log(f"kv_store {label:40s} exact {exact} ms {ms:.4f} plain {plain:.4f} "
            f"two launches {two:.4f} 2 x index_copy_ "
            f"{'none' if lib is None else format(lib, '.4f')} bound {case['bound_ms']:.6f}")
        if not exact:
            raise AssertionError(f"kv_store {label}: differs from its plain version "
                                 f"(max |err| {err}; must be exact)")
        del caches, got, want
        torch.cuda.empty_cache()
    r = report["kv_store"]
    r["cases"] = scases
    r["max_abs_err"] = max(c["max_abs_err"] for c in scases)
    r["tolerance"] = "exact bits: dense values, codes and scales"
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "two_launches_ms"):
        r[key] = scases[0][key]
    r["headline"] = scases[0]["shape"] + "; library_ms is two index_copy_ calls"


def phase_probe(dev, report: dict) -> None:
    """The device-memory read probe against its plain version (exact), its
    rate beside the nominal 3.35 TB/s; then its own entry point, whose
    launches are the ones the kernels line reports."""
    import torch

    from prima_tpu_torch.utils import hbm_probe

    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    nbytes = 1 << 30
    xs = [torch.randint(-2 ** 31, 2 ** 31 - 1, (nbytes // 4,), dtype=torch.int32,
                        device=dev, generator=gen) for _ in range(2)]
    got, want = hbm_probe.read_sum(xs[0]), hbm_probe.read_sum_plain(xs[0])
    torch.cuda.synchronize()
    err = abs(int(got) - int(want))
    ms = time_ms(hbm_probe.read_sum, [(x,) for x in xs], reps=10, per_rep=4)
    plain = time_ms(hbm_probe.read_sum_plain, [(x,) for x in xs], reps=10, per_rep=4)
    del xs
    torch.cuda.empty_cache()
    hbm_probe.launches.count = 0
    run = hbm_probe.measure(dev, nbytes=nbytes, reps=10)
    launches = hbm_probe.launches.count
    if err or not run["exact"] or not launches:
        raise AssertionError(f"hbm_probe: |kernel - plain| {err}, entry point {run}, "
                             f"{launches} launches")
    report["hbm_probe"].update(
        max_abs_err=float(err), tolerance="exact (int64 sum of the int32 words)",
        ms=ms, plain_ms=plain, library_ms=plain, bytes=nbytes,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        achieved_gbs=nbytes / ms / 1e6, nominal_gbs=HBM_BYTES_PER_S / 1e9,
        entry_point=run, entry_point_launches=launches,
        headline="1 GiB read once; library_ms is x.view(int32).sum(), the plain version")
    log(f"hbm_probe 1 GiB: exact, ms {ms:.4f} = {nbytes / ms / 1e6:.1f} GB/s of "
        f"{HBM_BYTES_PER_S / 1e9:.0f} nominal ({nbytes / ms / 1e6 / (HBM_BYTES_PER_S / 1e9):.1%}); "
        f"torch sum {plain:.4f} ms; entry point median {run['median_gbs']:.1f} GB/s, "
        f"{launches} launches")


def attn_visible(pos0: list, s: int, t: int) -> tuple[int, int]:
    """(query-cell pairs the causal mask lets through per head, cells per
    KV head read) for contiguous positions pos0[b] + [0, s)."""
    pairs = sum(min(t, p + i + 1) for p in pos0 for i in range(s))
    cells = sum(min(t, p + s) for p in pos0)
    return pairs, cells


def attn_bound(q_shape, kvh: int, t: int, pos0: list, esz: int, n_split: int = 1,
               cell_bytes: float | None = None) -> dict:
    """The least time for this data: the bytes of q, the output and the
    visible K/V cells once over 3.35 TB/s (cell_bytes a (cell, head) vector
    of K or V: D * esz for a dense cache, codes plus the f32 scale for a
    quantized one; and, where the prefill kernel splits the KV axis, its
    f32 scratch written and read once), against the operations
    the visible pairs need (4 * D a pair: q.k and p.v) over the peak of the
    inputs' type (bf16 tensor cores; f32 outside them). The f32 CUDA-core
    figure is kept beside it, since that is what the f32 kernels run on."""
    b, s, h, d = q_shape
    pairs, cells = attn_visible(pos0, s, t)
    if cell_bytes is None:
        cell_bytes = d * esz
    nbytes = int(2 * b * s * h * d * esz + 2 * cells * kvh * cell_bytes)
    if n_split > 1:
        nbytes += 2 * n_split * b * s * h * (d + 2) * 4
    flops = 4 * d * h * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOPS if esz == 2 else F32_FLOPS)
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "f32_core_bound_ms": max(t_bytes, flops / F32_FLOPS) * 1e3}


def sdpa_call(q, k, v, pos0: list, scale: float):
    """torch's scaled_dot_product_attention on the same inputs with an
    explicit boolean mask (timed as the yardstick, never used by the port)."""
    import torch
    import torch.nn.functional as F

    s, t = q.shape[1], k.shape[1]
    qpos = (torch.tensor(pos0, device=q.device)[:, None]
            + torch.arange(s, device=q.device))
    mask = (torch.arange(t, device=q.device)[None, None, :] <= qpos[:, :, None])[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale,
                                                  enable_gqa=True)


def attn_report(r: dict, out_cases: list) -> None:
    r["cases"] = out_cases
    r["max_abs_err"] = max(c["max_abs_err"] for c in out_cases)
    r["tolerance"] = (f"f32: max|err| <= {ATTN_F32_TOL} * max(1, max|plain|); bf16: "
                      f"max|err| <= {ATTN_BF16_TOL} * max|plain|")
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "f32_core_bound_ms", "bytes", "flops"):
        r[key] = out_cases[0][key]
    r["headline"] = out_cases[0]["shape"]


def phase_decode_attention(dev, report: dict, gen) -> None:
    """flash_decode against flash_decode_plain on cache.to(dtype), over
    dense, q8_0 and q4_0 caches quantized from the same seeded values. The
    kernel's caches hold NaN (NaN scales, for codes) in every cell past a
    row's last query position, which it must not read; the plain version,
    which reads all of T, gets zeros there. Each case runs four times and
    the outputs must have equal bits."""
    import torch

    from prima_tpu_torch.ops import attention as attn
    from prima_tpu_torch.ops import kvquant as kvq

    bf16, f32 = torch.bfloat16, torch.float32
    long_pos = [4000, 4031, 3990, 4060]
    # (label, B, S, H, KVH, D, T, dtype of q, cache kind, pos0 per batch row);
    # the first case is the long phase's main path
    cases = [
        ("8B long decode (main path)", 4, 1, 32, 8, 128, 8192, bf16, "dense", long_pos),
        ("8B long decode, q8_0 (main path)", 4, 1, 32, 8, 128, 8192, bf16, "q8_0", long_pos),
        ("8B long decode, q4_0", 4, 1, 32, 8, 128, 8192, bf16, "q4_0", long_pos),
        ("8B decode T=8192", 4, 1, 32, 8, 128, 8192, bf16, "dense", [5, 1000, 4095, 8191]),
        ("8B decode S=4", 4, 4, 32, 8, 128, 8192, bf16, "dense", [5, 1000, 4092, 8188]),
        ("8B decode S=4, q8_0", 4, 4, 32, 8, 128, 8192, bf16, "q8_0", [5, 1000, 4092, 8188]),
        ("8B decode S=8, q4_0", 4, 8, 32, 8, 128, 8192, bf16, "q4_0", [5, 1000, 4092, 8184]),
        ("8B decode T=2000", 4, 1, 32, 8, 128, 2000, bf16, "dense", [5, 700, 1999, 1300]),
        ("tiny-pair decode f32", 4, 1, 4, 4, 64, 256, f32, "dense", [0, 1, 100, 255]),
        ("tiny-pair decode f32, q8_0", 4, 1, 4, 4, 64, 256, f32, "q8_0", [0, 1, 100, 255]),
        ("tiny-pair decode f32, q4_0", 4, 1, 4, 4, 64, 256, f32, "q4_0", [0, 1, 100, 255]),
        ("tiny-pair decode bf16, q4_0", 4, 1, 4, 4, 64, 256, bf16, "q4_0", [0, 1, 100, 255])]
    classes = {"q8_0": kvq.KVQ8, "q4_0": kvq.KVQ4}
    out_cases = []
    for label, b, s, h, kvh, d, t, dt, kind, pos0 in cases:
        scale = 1.0 / d ** 0.5
        esz = 2 if dt == bf16 else 4
        cell_bytes = {"dense": d * esz, "q8_0": d + 4, "q4_0": d // 2 + 4}[kind]
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dt)
        pos = (torch.tensor(pos0, dtype=torch.int32, device=dev)[:, None]
               + torch.arange(s, dtype=torch.int32, device=dev))

        def cache_pair(fill):
            """K and V of this case's kind from fresh seeded values, `fill`
            in the cells no row may see."""
            pair = []
            for _ in range(2):
                x = torch.randn((b, t, kvh, d), generator=gen, device=dev).to(dt)
                c = x if kind == "dense" else classes[kind](*classes[kind].quantize(x))
                hide = c if kind == "dense" else c.scale
                for i, p0 in enumerate(pos0):
                    hide[i, p0 + s:] = fill
                pair.append(c)
            return tuple(pair)

        state = gen.get_state()
        kn, vn = cache_pair(float("nan"))
        gen.set_state(state)  # the same values again, zeros where NaN was
        k, v = cache_pair(0.0)
        runs = [attn.flash_decode(q, kn, vn, pos, scale) for _ in range(4)]
        want = attn.flash_decode_plain(q, k, v, pos, scale)
        torch.cuda.synchronize()
        got = runs[0]
        same_bits = all(torch.equal(got, r) for r in runs[1:])
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        tol = ATTN_F32_TOL * max(1.0, ref) if dt == f32 else ATTN_BF16_TOL * ref
        del kn, vn, runs
        kvs = [(k, v)] + [cache_pair(0.0)
                          for _ in range(copies_for(2 * b * t * kvh * cell_bytes) - 1)]
        ms = time_ms(attn.flash_decode, [(q, k_, v_, pos, scale) for k_, v_ in kvs])
        plain = time_ms(attn.flash_decode_plain, [(q, k_, v_, pos, scale) for k_, v_ in kvs[:2]],
                        reps=5, per_rep=2)
        # the library call on the same values: for a quantized cache, on the
        # copy materialized outside the timed window
        dense = [(k_.to(dt), v_.to(dt)) for k_, v_ in kvs[:4]]
        lib = time_ms(lambda f: f(), [(sdpa_call(q, k_, v_, pos0, scale),) for k_, v_ in dense],
                      reps=10, per_rep=4)
        del dense
        n_split, split_len = attn.decode_split(b, s, h, kvh, t, dt)
        case = {"shape": label, "B": b, "S": s, "H": h, "KVH": kvh, "D": d, "T": t,
                "dtype": str(dt), "cache": kind, "pos0": pos0, "max_abs_err": err,
                "max_abs_ref": ref, "tolerance": tol, "same_bits_in_4_runs": same_bits,
                "ms": ms, "plain_ms": plain, "library_ms": lib, "n_split": n_split,
                "split_len": split_len,
                **attn_bound(q.shape, kvh, t, pos0, esz, cell_bytes=cell_bytes)}
        out_cases.append(case)
        log(f"flash_decode {label:34s} err {err:.2e}/{ref:.2e} ms {ms:.4f} plain {plain:.4f} "
            f"sdpa {lib:.4f} bound {case['bound_ms']:.4f} ({case['bound_by']}, "
            f"{case['bytes'] / 1e6:.1f} MB)")
        if not err <= tol:
            raise AssertionError(f"flash_decode {label}: max |err| {err} > {tol}")
        if not same_bits:
            raise AssertionError(f"flash_decode {label}: four runs gave different bits")
        del kvs, k, v
        torch.cuda.empty_cache()
    attn_report(report["flash_decode"], out_cases)


def phase_attention(dev, report: dict) -> None:
    """flash_decode and flash_prefill against their plain versions."""
    import torch

    from prima_tpu_torch.ops import attention as attn

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    phase_decode_attention(dev, report, gen)
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, KVH, D, T, dtype, pos0 per batch row); the first
    # case is the long phase's main path
    rows = [
        ("8B prefill 256 at 3840 (main path)", 1, 256, 32, 8, 128, 8192, bf16, [3840]),
        ("8B prefill 256 at 0", 1, 256, 32, 8, 128, 8192, bf16, [0]),
        ("8B prefill 256 at 7936", 1, 256, 32, 8, 128, 8192, bf16, [7936]),
        ("8B prefill 129 (ragged)", 1, 129, 32, 8, 128, 8192, bf16, [3968]),
        ("8B prefill S=9", 2, 9, 32, 8, 128, 8192, bf16, [100, 5000]),
        ("tiny-pair prefill bf16", 1, 64, 4, 4, 64, 256, bf16, [64]),
        ("8B prefill 256 at 3840 f32", 1, 256, 32, 8, 128, 8192, f32, [3840]),
        ("8B prefill 256 at 0 f32", 1, 256, 32, 8, 128, 8192, f32, [0]),
        ("8B prefill 129 (ragged) f32", 1, 129, 32, 8, 128, 8192, f32, [3968]),
        ("8B prefill S=9 f32", 2, 9, 32, 8, 128, 8192, f32, [100, 5000]),
        ("tiny-pair prefill f32", 1, 64, 4, 4, 64, 256, f32, [64])]
    name, fn, plain_fn = "flash_prefill", attn.flash_prefill, attn.flash_prefill_plain
    out_cases = []
    for label, b, s, h, kvh, d, t, dt, pos0 in rows:
        scale = 1.0 / d ** 0.5
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dt)
        kv_bytes = 2 * b * t * kvh * d * (2 if dt == bf16 else 4)
        kvs = [tuple(torch.randn((b, t, kvh, d), generator=gen, device=dev).to(dt)
                     for _ in range(2)) for _ in range(copies_for(kv_bytes))]
        pos = (torch.tensor(pos0, dtype=torch.int32, device=dev)[:, None]
               + torch.arange(s, dtype=torch.int32, device=dev))
        k, v = kvs[0]
        # cells past each row's last query position hold NaN for the
        # kernel (it must not read them); the plain version, which
        # reads all of T, gets zeros there
        n_split = attn.prefill_n_split(b, s, h, kvh, t, attn.prefill_tile(dt))
        kn, vn = k.clone(), v.clone()
        for i, p0 in enumerate(pos0):
            kn[i, p0 + s:] = float("nan")
            vn[i, p0 + s:] = float("nan")
            k[i, p0 + s:] = 0
            v[i, p0 + s:] = 0
        got = fn(q, kn, vn, pos, scale)
        del kn, vn
        want = plain_fn(q, k, v, pos, scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        tol = ATTN_F32_TOL * max(1.0, ref) if dt == f32 else ATTN_BF16_TOL * ref
        ms = time_ms(fn, [(q, k_, v_, pos, scale) for k_, v_ in kvs])
        plain = time_ms(plain_fn, [(q, k_, v_, pos, scale) for k_, v_ in kvs[:2]],
                        reps=5, per_rep=2)
        lib = time_ms(lambda f: f(), [(sdpa_call(q, k_, v_, pos0, scale),)
                                      for k_, v_ in kvs[:4]], reps=10, per_rep=4)
        case = {"shape": label, "B": b, "S": s, "H": h, "KVH": kvh, "D": d, "T": t,
                "dtype": str(dt), "pos0": pos0, "max_abs_err": err, "max_abs_ref": ref,
                "tolerance": tol, "ms": ms, "plain_ms": plain, "library_ms": lib,
                "n_split": n_split,
                **attn_bound(q.shape, kvh, t, pos0, q.element_size(), n_split)}
        out_cases.append(case)
        log(f"{name} {label:36s} err {err:.2e}/{ref:.2e} ms {ms:.4f} plain {plain:.4f} "
            f"sdpa {lib:.4f} bound {case['bound_ms']:.4f} ({case['bound_by']}; "
            f"f32 cores {case['f32_core_bound_ms']:.4f})")
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max |err| {err} > {tol}")
        del kvs, k, v
        torch.cuda.empty_cache()
    attn_report(report[name], out_cases)


# ---------------------------------------------------------------------------
# phase 3: the HTTP server on the trained tiny model
# ---------------------------------------------------------------------------

TINY = os.path.join("models_tiny_pair", "target.gguf")
PROMPTS = ["The quick brown fox", "Once upon a time", "def main():",
           "In the beginning was"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, path: str, body: dict, timeout: float = 300) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"{path}: HTTP {resp.status} {data[:200]!r}")
    return json.loads(data)


def _get(port: int, path: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return json.loads(resp.read())
    finally:
        conn.close()


def _server(extra: list[str], report: dict, key: str, slots: bool = False) -> None:
    """Start the server on the tiny model with `extra` flags, answer the
    concurrent requests (and save slot 0 and restore it into slot 1 when
    `slots`), check that the default path's kernels ran, stop it."""
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "prima_tpu_torch.server", "-m", TINY,
                             "--device", "cuda", "--port", str(port), *extra], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out: list[str] = []
    reader = threading.Thread(target=lambda: out.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        t0 = time.time()
        while True:
            if proc.poll() is not None:
                raise AssertionError("server exited:\n" + "".join(out))
            try:
                if _get(port, "/health").get("status") == "ok":
                    break
            except OSError:
                pass
            if time.time() - t0 > 240:
                raise AssertionError("server did not come up:\n" + "".join(out))
            time.sleep(0.5)
        log(f"server {' '.join(extra) or '(defaults)'} up in {time.time() - t0:.1f} s")
        results: dict = {}

        def one(i, path, body):
            results[i] = _post(port, path, body)

        body = {"n_predict": 32, "temperature": 0}
        threads = [threading.Thread(target=one, args=(i, "/completion",
                                                      dict(body, prompt=p)))
                   for i, p in enumerate(PROMPTS)]
        threads.append(threading.Thread(target=one, args=(
            "chat", "/v1/chat/completions",
            dict(body, max_tokens=32, messages=[{"role": "user", "content": "Hello"}]))))
        t0 = time.time()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.time() - t0
        if len(results) != len(threads):
            raise AssertionError(f"only {len(results)} of {len(threads)} requests answered")
        for i in range(len(PROMPTS)):
            ch = results[i]["choices"][0]
            if results[i]["usage"]["completion_tokens"] <= 0:
                raise AssertionError(f"/completion {i} generated nothing")
            log(f"completion {i}: {ch['text']!r} ({ch['finish_reason']})")
        msg = results["chat"]["choices"][0]["message"]["content"]
        log(f"chat: {msg!r}")
        launches = _get(port, "/props")["kernel_launches"]
        log("server kernel launches", json.dumps(launches))
        # the server's default path runs the GEMV and the fused KV store;
        # flash attention is opt-in (ForwardOptions.attn_impl), as in the JAX
        # package
        if not (launches["qgemv"] > 0 and launches["kv_store"] > 0):
            raise AssertionError(f"server ran without a kernel: {launches}")
        report[key] = {"flags": extra, "requests": len(threads), "wall_s": wall,
                       "launches": launches}
        if slots:
            saved = _post(port, "/slots/0?action=save", {"filename": "slot0.bin"})
            restored = _post(port, "/slots/1?action=restore", {"filename": "slot0.bin"})
            log(f"slot 0 saved ({saved['n_saved']} tokens) and restored into slot 1 "
                f"({restored['n_restored']})")
            if not 0 < saved["n_saved"] == restored["n_restored"]:
                raise AssertionError(f"slot save/restore: {saved} {restored}")
            report[key]["slot_tokens"] = saved["n_saved"]
            # the restore writes the saved cells through the KV write kernel
            launches = _get(port, "/props")["kernel_launches"]
            log("server kernel launches after the restore", json.dumps(launches))
            if not launches["kv_write"] > 0:
                raise AssertionError(f"slot restore ran without kv_write: {launches}")
            report[key]["launches"] = launches
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def phase_server(report: dict) -> None:
    _server([], report, "server")
    slot_dir = os.path.join(ROOT, "build", "chip_smoke_slots")
    os.makedirs(slot_dir, exist_ok=True)
    _server(["-ctk", "q8_0", "-gan", "2", "-gaw", "64", "--slot-save-path", slot_dir],
            report, "server_long_context", slots=True)


# the tiny-parity variants: (name, ForwardOptions.attn_impl on the card,
# Engine keyword arguments, prompt repeats); the CPU runs the same with
# attn_impl "plain" and matmul_impl "plain"
PARITY = [("default", "plain", {}, 1),
          ("flash attention", "kernel", {}, 1),
          ("flash attention, q8_0 cache", "kernel", {"kv_dtype": "q8_0"}, 1),
          ("flash attention, q4_0 cache", "kernel", {"kv_dtype": "q4_0"}, 1),
          # ~150-token prompts cross the ga boundaries at 64 and 96
          ("flash attention, Self-Extend 2/64", "kernel",
           {"grp_attn_n": 2, "grp_attn_w": 64}, 8)]


def greedy_streams(device: str, impl: str, attn_impl: str = "plain", repeat: int = 1,
                   **engine_kw) -> list[list[int]]:
    """Greedy tokens for PROMPTS on the tiny model, f32 activations and KV,
    through Engine.submit + step_fused with slot reuse (2 slots, 4 asks)."""
    import torch

    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.models.loader import load_model
    from prima_tpu_torch.runtime.engine import Engine

    m = load_model(TINY, device=device)
    engine_kw.setdefault("kv_dtype", torch.float32)
    eng = Engine(m.cfg, m.params, n_slots=2, max_seq=256, n_batch=64, device=device,
                 opts=ForwardOptions(matmul_impl=impl, attn_impl=attn_impl,
                                     dtype=torch.float32),
                 eog_ids=m.eog_ids, **engine_kw)
    return engine_streams(eng, [m.tokenizer.encode(p * repeat, add_special=True)
                                for p in PROMPTS])


def engine_streams(eng, prompts: list, n_predict: int = 32) -> list[list[int]]:
    """The tokens `eng` generates for each prompt through submit +
    step_fused, more prompts than slots (slot reuse)."""
    from prima_tpu_torch.runtime.engine import SlotState

    out, slots, queue = {}, {}, list(enumerate(prompts))
    while queue or slots:
        while queue and eng.find_idle_slot() is not None:
            i, p = queue.pop(0)
            slots[i] = eng.submit(p, n_predict=n_predict)
        eng.step_fused(max_chunk=8)
        for i, s in list(slots.items()):
            if s.state == SlotState.IDLE:
                out[i] = list(s.generated)
                del slots[i]
    return [out[i] for i in range(len(prompts))]


def tiny_arch(name: str):
    """(cfg, params) of a tiny gemma2 (GeGLU, embedding scale, attention
    and final softcaps, a sliding window of 16 on even layers, post norms,
    tied head) or qwen2moe (4 experts, raw top-2 weights, q/k/v biases, a
    shared expert under a sigmoid gate), quantized weights and f32 norms
    and routers made on the CPU from a seed."""
    import torch

    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.config import RopeType, tiny_config
    from prima_tpu_torch.models.llama import synth_qtensor_device

    e, h, kvh, hd, f, v = 256, 4, 2, 64, 512, 512
    common = dict(n_embd=e, n_heads=h, n_kv_heads=kvh, head_dim=hd, rope_dim=hd, n_ff=f,
                  n_vocab=v, n_layers=2)
    if name == "gemma2":
        cfg = tiny_config(arch="gemma2", act="gelu", embd_scale=e ** 0.5,
                          attn_logit_softcap=5.0, final_logit_softcap=3.0, post_norms=True,
                          swa_window=16, attn_scale=1.0 / hd ** 0.5, tie_embeddings=True,
                          rope_type=RopeType.NEOX, **common)
    else:
        cfg = tiny_config(arch="qwen2moe", n_expert=4, n_expert_used=2, moe_norm_w=False,
                          qkv_bias=True, rope_type=RopeType.NEOX, **common)
    gen = torch.Generator()
    gen.manual_seed(17)
    # symmetric formats (zero-mean weights: Q4_K's mins would give every
    # row of the tied head a bias that decides the argmax alone): Q4_0 on
    # the tensor-core kernel, Q8_0 for the down projections on the other
    q = lambda rows, k, t=GGMLType.Q4_0: synth_qtensor_device(gen, rows, k, t, "cpu")
    q8 = lambda rows, k: q(rows, k, GGMLType.Q8_0)
    norm = lambda n: 3 * (1 + 0.1 * torch.randn(n, generator=gen))
    params = {"tok_embd": q(v, e), "output_norm": norm(e),
              "output": None if cfg.tie_embeddings else q(v, e), "layers": []}
    for _ in range(cfg.n_layers):
        layer = {"attn_norm": norm(e), "wq": q(h * hd, e), "wk": q(kvh * hd, e),
                 "wv": q(kvh * hd, e), "wo": q(e, h * hd), "ffn_norm": norm(e)}
        if name == "gemma2":
            layer.update(w_gate=q(f, e), w_up=q(f, e), w_down=q8(e, f),
                         attn_post_norm=norm(e), ffn_post_norm=norm(e))
        else:
            layer.update(bq=0.02 * torch.randn(h * hd, generator=gen),
                         bk=0.02 * torch.randn(kvh * hd, generator=gen),
                         bv=0.02 * torch.randn(kvh * hd, generator=gen),
                         ffn_gate_inp=torch.randn((4, e), generator=gen),
                         ffn_gate_exps=q(4 * f, e), ffn_up_exps=q(4 * f, e),
                         ffn_down_exps=q8(4 * e, f),
                         ffn_gate_inp_shexp=torch.randn((1, e), generator=gen) * 0.1,
                         ffn_gate_shexp=q(f, e), ffn_up_shexp=q(f, e), ffn_down_shexp=q8(e, f))
        params["layers"].append(layer)
    return cfg, params


def params_to(tree, device):
    """A params tree with every tensor (and every QTensor's) on `device`."""
    import torch

    from prima_tpu_torch.quant.qtensor import QTensor

    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, **{f: None if a is None else a.to(device)
                                           for f, a in zip(("qs", "scales", "mins", "d", "dmin"),
                                                           tree.tensors())})
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def arch_streams(cfg, params, device: str, impl: str) -> list[list[int]]:
    """Greedy tokens of 4 seeded prompts of 40-60 tokens, 32 each, f32
    activations and KV, through Engine.submit + step_fused (2 slots)."""
    import numpy as np
    import torch

    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.runtime.engine import Engine

    eng = Engine(cfg, params_to(params, device), n_slots=2, max_seq=128, n_batch=64,
                 device=device, kv_dtype=torch.float32,
                 opts=ForwardOptions(matmul_impl=impl, attn_impl=impl, dtype=torch.float32))
    rng = np.random.default_rng(5)
    return engine_streams(eng, [rng.integers(0, cfg.n_vocab, int(n)).tolist()
                                for n in (40, 47, 53, 60)])


def phase_tiny_parity(report: dict) -> None:
    from prima_tpu_torch.ops import attention as attn
    from prima_tpu_torch.quant import qmatmul as qm

    report["tiny_parity"] = {}
    # the decoder's arch branches: the card with every kernel (the flash
    # route falls back to plain attention for softcap and sliding windows,
    # as in the JAX package) against the CPU's plain path
    for name in ("gemma2", "qwen2moe"):
        cfg, params = tiny_arch(name)
        before = qm.indexed_launches.count
        card = arch_streams(cfg, params, "cuda", "kernel")
        indexed = qm.indexed_launches.count - before
        cpu = arch_streams(cfg, params, "cpu", "plain")
        log(f"tiny {name} greedy (card, kernels; {indexed} indexed GEMV launches):", card)
        if card != cpu:
            raise AssertionError(f"tiny {name} streams differ: card {card} cpu {cpu}")
        if (name == "qwen2moe") != (indexed > 0):
            raise AssertionError(f"tiny {name}: {indexed} indexed GEMV launches")
        report["tiny_parity"][name] = {"prompts": 4, "tokens": sum(map(len, card)),
                                       "indexed_launches": indexed, "identical": True}
    for name, attn_impl, kw, repeat in PARITY:
        before = attn.decode_launches.count + attn.prefill_launches.count
        card = greedy_streams("cuda", "kernel", attn_impl, repeat, **kw)
        flash = attn.decode_launches.count + attn.prefill_launches.count - before
        cpu = greedy_streams("cpu", "plain", "plain", repeat, **kw)
        log(f"tiny greedy, {name} (card, kernels; {flash} flash launches):", card)
        if card != cpu:
            raise AssertionError(f"greedy streams differ ({name}): card {card} cpu {cpu}")
        if (attn_impl == "kernel") != (flash > 0):
            raise AssertionError(f"{name}: {flash} flash attention launches")
        report["tiny_parity"][name] = {"prompts": len(PROMPTS),
                                       "tokens": sum(map(len, card)),
                                       "flash_launches": flash, "identical": True}


# ---------------------------------------------------------------------------
# phase 4: the 8B shape at full width
# ---------------------------------------------------------------------------


# a kernel's time goes to the first entry whose names it matches
KERNEL_NAMES = {"qgemv_indexed": ("qgemv_mma_indexed", "qgemv_fma_indexed"),
                "qgemv": ("qgemv_mma", "qgemv_fma"), "kv_write": ("kv_write_kernel",),
                "kv_store": ("kv_store_dense", "kv_store_quant"),
                "flash_decode": ("decode_mma", "decode_f32"),
                "flash_prefill": ("prefill_mma", "prefill_f32", "prefill_combine")}


def device_ms(prof) -> tuple[dict, list]:
    """Device ms of a torch.profiler run: by the port's kernels (and
    "other"), and the 8 largest kernels by name."""
    from torch.autograd import DeviceType

    by_name: Counter = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    by = dict.fromkeys(KERNEL_NAMES, 0.0)
    by["other"] = 0.0
    for n, t in by_name.items():
        key = next((k for k, ms in KERNEL_NAMES.items() if any(m in n for m in ms)), "other")
        by[key] += t
    if not sum(by.values()):
        raise AssertionError("the profiler saw no device time")
    return by, [(n[:80], t) for n, t in by_name.most_common(8)]


def profile_prefill(eng, cfg, rng) -> dict:
    """Where a prefill chunk's time goes: one request of 17 chunks of 256
    seeded tokens; the chunk at position 3584 is timed on the host
    unprofiled, the next, at 3840, runs under torch.profiler (CUDA
    activity only). The request is cancelled before it decodes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prompt = rng.integers(0, cfg.n_vocab, 17 * 256 + 1).tolist()
    eng.submit(prompt, n_predict=1, request_id="profile_prefill", reuse_prefix=False)
    for _ in range(14):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    eng.cancel("profile_prefill")
    by, top = device_ms(prof)
    busy = sum(by.values())
    return {"chunk_tokens": 256, "position": 3840, "wall_ms": wall * 1e3,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / (wall * 1e3),
            "device_ms": by, "top_kernels_ms": top}


def profile_decode(eng, prompts) -> dict:
    """Where a decode step's time goes, with all 4 slots decoding: the host
    wall time of one unprofiled step_fused chunk (8 steps), then the device
    time by kernel over the next chunk from torch.profiler (CUPTI, CUDA
    activity only). The idle share sets the second chunk's device time
    against the first chunk's wall time, so the profiler's own host
    overhead does not count as idle. Also counts the dense copies made of
    a quantized cache (KVQ8.to / KVQ4.to) over the two chunks."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from prima_tpu_torch.ops.kvquant import KVQ8

    for p in prompts[:4]:
        eng.submit(p, n_predict=24)
    eng.step()  # prefill all four, one host-sampled step
    torch.cuda.synchronize()
    dense_copies = KVQ8.materialized
    t0 = time.perf_counter()
    events = eng.step_fused(max_chunk=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = max(Counter(e.slot_id for e in events).values(), default=0)
    if steps != 8:
        raise AssertionError(f"the timed chunk ran {steps} decode steps, not 8")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        events = eng.step_fused(max_chunk=8)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    if max(Counter(e.slot_id for e in events).values(), default=0) != steps:
        raise AssertionError("the profiled chunk ran another number of steps")
    by, top = device_ms(prof)
    dense_copies = KVQ8.materialized - dense_copies
    while any(s.state.name != "IDLE" for s in eng.slots):
        eng.step_fused(max_chunk=8)
    busy = sum(by.values())
    return {"steps": steps, "wall_ms": wall * 1e3, "profiled_wall_ms": prof_wall * 1e3,
            "quantized_cache_materializations": dense_copies,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / (wall * 1e3),
            "device_ms": by, "top_kernels_ms": top}


def weights_8b(dev):
    """The Llama-3-8B shape with Q4_K weights generated on the card."""
    import torch

    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.config import tiny_config
    from prima_tpu_torch.models.llama import synth_params_device

    cfg = tiny_config(**LLAMA3_8B)
    t0 = time.time()
    params = synth_params_device(cfg, GGMLType.Q4_K, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"8B-shape Q4_K weights ({cfg.n_layers} layers) generated on the card in "
        f"{time.time() - t0:.1f} s")
    return cfg, params


def check_logits(report: dict, logits: dict, what: str) -> None:
    """Kernels against plain over one decode step's f32 logits."""
    err = (logits["kernel"] - logits["plain"]).abs().max().item()
    scale = logits["plain"].abs().max().item()
    same_argmax = bool((logits["kernel"].argmax(-1) == logits["plain"].argmax(-1)).all())
    report.update(logits_max_abs_err=err, logits_max_abs=scale,
                  logits_argmax_equal=same_argmax,
                  logits_tolerance=f"max|err| <= {LOGITS_TOL} * max|plain| (f32)")
    log(f"{what} logits kernels vs plain: max |err| {err:.3e} of max |logit| {scale:.3e}, "
        f"argmax equal {same_argmax}")
    if not (err <= LOGITS_TOL * scale and same_argmax):
        raise AssertionError(f"{what} logits: kernels disagree with the plain path")


def phase_full(dev, report: dict, cfg, params) -> dict:
    import numpy as np
    import torch

    from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
    from prima_tpu_torch.ops import kv_write as kvw
    from prima_tpu_torch.quant import qmatmul as qm
    from prima_tpu_torch.runtime.engine import Engine, SlotState

    eng = Engine(cfg, params, n_slots=4, max_seq=2048, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.n_vocab, 128).tolist() for _ in range(8)]
    # warm-up request (allocator, cuBLAS handles), not counted
    eng.run_to_completion(prompts[0][:16], n_predict=2)
    eng.perf = {k: 0 * v for k, v in eng.perf.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    qm.launches.count = 0
    kvw.store_launches.count = 0
    queue, live, done = list(prompts), [], []
    t0 = time.time()
    while queue or live:  # the loop EngineWorker._loop runs
        while queue and eng.find_idle_slot() is not None:
            live.append(eng.submit(queue.pop(0), n_predict=64))
        eng.step_fused(max_chunk=8)
        for s in [s for s in live if s.state == SlotState.IDLE]:
            done.append(list(s.generated))
            live.remove(s)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"qgemv": qm.launches.count, "kv_store": kvw.store_launches.count}
    if len(done) != 8 or any(len(g) != 64 for g in done):
        raise AssertionError(f"8B engine finished {len(done)} requests, lengths "
                             f"{[len(g) for g in done]}")
    if not all(launches.values()):
        raise AssertionError(f"8B main path ran without a kernel: {launches}")
    p = eng.perf
    full = {"layers": cfg.n_layers, "requests": 8, "prompt_tokens": 128, "gen_tokens": 64,
            "prefill_tok_s": p["n_prompt"] / p["t_prompt_s"],
            "decode_tok_s": p["n_decode"] / p["t_decode_s"], "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "launches": launches}
    log("8B engine", json.dumps(full))

    full["profile"] = profile_decode(eng, prompts)
    log("8B decode chunk profile", json.dumps(full["profile"]))

    # one decode step's logits, kernels vs plain, f32 on the same weights
    toks = torch.as_tensor(rng.integers(0, cfg.n_vocab, (4, 1)), device=dev)
    logits = {}
    for impl in ("kernel", "plain"):
        kv = init_kv_caches(cfg, 4, 64, torch.float32, dev)
        with torch.no_grad():
            logits[impl], _ = forward(
                params, cfg, toks, torch.zeros((4, 1), dtype=torch.int32, device=dev), kv,
                torch.zeros(4, dtype=torch.int32, device=dev),
                ForwardOptions(matmul_impl=impl, dtype=torch.float32))
    check_logits(full, logits, "8B")
    report["full"] = full
    return launches


def serve_long(eng, prompts, n_predict: int, counters: dict, dev, on_start=None) -> dict:
    """4 long prompts through submit + step_fused (the loop
    EngineWorker._loop runs), the kernels' counts set to 0 just before and
    read just after (`on_start` runs there too). Every forward call
    launches one KV store and one flash kernel a layer."""
    import torch

    from prima_tpu_torch.runtime.engine import SlotState

    eng.run_to_completion(prompts[0][:16], n_predict=2)  # warm-up, not counted
    eng.perf = {k: 0 * v for k, v in eng.perf.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.count = 0
    if on_start is not None:
        on_start()
    live, done = [eng.submit(p, n_predict=n_predict) for p in prompts], []
    t0 = time.time()
    while live:
        eng.step_fused(max_chunk=8)
        for s in [s for s in live if s.state == SlotState.IDLE]:
            done.append(list(s.generated))
            live.remove(s)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: c.count for k, c in counters.items()}
    if len(done) != 4 or any(len(g) != n_predict for g in done):
        raise AssertionError(f"long engine finished {len(done)} requests, lengths "
                             f"{[len(g) for g in done]}")
    if not all(launches.values()):
        raise AssertionError(f"long-context path ran without a kernel: {launches}")
    layers = eng.cfg.n_layers
    if launches["kv_store"] % layers or \
            launches["kv_store"] != launches["flash_decode"] + launches["flash_prefill"]:
        raise AssertionError(f"not one KV store a layer and forward call: {launches}")
    p = eng.perf
    return {"layers": layers, "requests": 4, "max_seq": eng.max_seq,
            "prompt_tokens": [len(x) for x in prompts], "gen_tokens": n_predict,
            "prefill_tok_s": p["n_prompt"] / p["t_prompt_s"],
            "decode_tok_s": p["n_decode"] / p["t_decode_s"], "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "launches": launches, "forward_calls": launches["kv_store"] // layers}


def phase_long(dev, report: dict, cfg, params) -> dict:
    """Long-context serving at full width through flash attention: over a
    bf16 cache, then over a q8_0 cache."""
    import numpy as np
    import torch

    from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
    from prima_tpu_torch.ops import attention as attn
    from prima_tpu_torch.ops import kv_write as kvw
    from prima_tpu_torch.ops.kvquant import KVQ8
    from prima_tpu_torch.quant import qmatmul as qm
    from prima_tpu_torch.runtime.engine import Engine

    counters = {"qgemv": qm.launches, "kv_store": kvw.store_launches,
                "flash_decode": attn.decode_launches, "flash_prefill": attn.prefill_launches}
    eng = Engine(cfg, params, n_slots=4, max_seq=8192, device=dev,
                 opts=ForwardOptions(attn_impl="kernel"))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.n_vocab, int(n)).tolist()
               for n in rng.integers(3900, 4100, 4)]
    long = serve_long(eng, prompts, 32, counters, dev)
    launches = long["launches"]
    log("8B long-context engine", json.dumps(long))
    # the same prompts again reuse their cached prefixes: a decode chunk
    # near position 4000 without a second prefill
    long["profile"] = profile_decode(eng, prompts)
    log("8B long decode chunk profile", json.dumps(long["profile"]))
    # the same chunk with the plain attention, for what the flash path
    # saves end to end
    eng.opts = dataclasses.replace(eng.opts, attn_impl="plain")
    long["profile_plain_attention"] = profile_decode(eng, prompts)
    log("8B long decode chunk profile, plain attention",
        json.dumps(long["profile_plain_attention"]))
    # last, since its request takes over a slot and that slot's cached prefix
    eng.opts = dataclasses.replace(eng.opts, attn_impl="kernel")
    long["profile_prefill"] = profile_prefill(eng, cfg, rng)
    log("8B long prefill chunk profile", json.dumps(long["profile_prefill"]))
    del eng
    gc.collect()  # the engine sits in a reference cycle with its generator
    torch.cuda.empty_cache()

    # the same weights and prompts over a q8_0 cache: the store quantizes in
    # its kernel and the decode kernel reads the codes, so no decode step may
    # make a dense copy of a cache
    eng = Engine(cfg, params, n_slots=4, max_seq=8192, device=dev, kv_dtype="q8_0",
                 opts=ForwardOptions(attn_impl="kernel"))
    q8 = serve_long(eng, prompts, 16, counters, dev)
    log("8B long-context engine, q8_0 cache", json.dumps(q8))
    q8["profile"] = profile_decode(eng, prompts)
    log("8B long decode chunk profile, q8_0 cache", json.dumps(q8["profile"]))
    if q8["profile"]["quantized_cache_materializations"]:
        raise AssertionError("a decode step over the q8_0 cache made a dense copy of it")
    if not (q8["profile"]["device_ms"]["flash_decode"] > 0
            and q8["profile"]["device_ms"]["kv_store"] > 0):
        raise AssertionError("the q8_0 decode chunk ran without flash_decode or kv_store")
    long["q8_0"] = q8
    del eng
    gc.collect()  # the engine sits in a reference cycle with its generator
    torch.cuda.empty_cache()

    # one decode step near position 4000 over caches of seeded values, f32
    # and then q8_0, every kernel against every plain version
    pos0 = [4000, 4031, 3990, 4060]
    toks = torch.as_tensor(rng.integers(0, cfg.n_vocab, (4, 1)), device=dev)
    pos = torch.tensor(pos0, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    for kind, into in ((torch.float32, long), ("q8_0", q8)):
        kv = init_kv_caches(cfg, 4, 4096, kind, dev)
        for pair in kv:
            for c in pair:
                x = torch.randn(c.shape, generator=gen, device=dev)
                if kind == "q8_0":
                    codes, scale = KVQ8.quantize(x)
                    c.qs.copy_(codes)
                    c.scale.copy_(scale)
                else:
                    c.copy_(x)
        logits = {}
        for impl in ("kernel", "plain"):
            with torch.no_grad():
                logits[impl], _ = forward(
                    params, cfg, toks, pos[:, None], kv, pos,
                    ForwardOptions(matmul_impl=impl, attn_impl=impl, dtype=torch.float32))
        check_logits(into, logits, f"8B long-context step, {kind} cache")
        del kv, logits
        torch.cuda.empty_cache()
    report["long"] = long
    return launches


def weights_mixtral(dev):
    """Mixtral-8x7B at full width and depth, Q4_K weights generated on the
    card: the stacked experts of each layer as one QTensor of 8 * N rows a
    projection (the layout the loader gives), the router in f32. The
    weights are centred: with the synth's default mean every hidden state
    shares one direction, and the random router sent every row to the same
    2 experts at every layer."""
    import torch

    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.config import tiny_config
    from prima_tpu_torch.models.llama import synth_qtensor_device

    cfg = tiny_config(**MIXTRAL)
    e, h, kvh, hd, f, n_exp = (cfg.n_embd, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                               cfg.n_ff, cfg.n_expert)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    t0 = time.time()
    q = lambda rows, k: synth_qtensor_device(gen, rows, k, GGMLType.Q4_K, dev,
                                             zero_mean=True)
    ones = lambda: torch.ones(e, dtype=torch.float32, device=dev)
    params = {"tok_embd": q(cfg.n_vocab, e), "output": q(cfg.n_vocab, e),
              "output_norm": ones(), "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": ones(), "wq": q(h * hd, e), "wk": q(kvh * hd, e),
            "wv": q(kvh * hd, e), "wo": q(e, h * hd), "ffn_norm": ones(),
            "ffn_gate_inp": torch.randn((n_exp, e), generator=gen, device=dev) * 0.02,
            "ffn_gate_exps": q(n_exp * f, e), "ffn_up_exps": q(n_exp * f, e),
            "ffn_down_exps": q(n_exp * e, f)})
    torch.cuda.synchronize()
    log(f"Mixtral-8x7B-shape Q4_K weights ({cfg.n_layers} layers, "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.1f} GiB on the card) generated in "
        f"{time.time() - t0:.1f} s")
    return cfg, params


def expert_use(seen: list, params: dict, cfg) -> dict:
    """Distinct experts a layer's indexed launches read in a run, by pair
    count (8 = the 4-slot decode), and what one decode step's 3 x layers
    launches would take at 3.35 TB/s reading each distinct expert once."""
    import torch

    layer = params["layers"][0]
    slice_bytes = sum(layer[k].nbytes for k in ("ffn_gate_exps", "ffn_up_exps",
                                                "ffn_down_exps")) / cfg.n_expert
    by: dict = {}
    for ids in seen:
        by.setdefault(ids.numel(), []).append(torch.unique(ids).numel())
    out = {"layer_launches": len(seen), "by_pairs": {}}
    for p, d in sorted(by.items()):
        mean = statistics.fmean(d)
        out["by_pairs"][str(p)] = {
            "layer_launches": len(d), "mean_distinct": mean,
            "bound_ms_per_step": cfg.n_layers * mean * slice_bytes / HBM_BYTES_PER_S * 1e3}
    return out


def phase_moe(dev, report: dict) -> dict:
    """Mixtral-8x7B at full width: Engine(n_slots=4, max_seq=4096,
    attn_impl="kernel") serves 4 requests of 480-512 seeded prompt tokens
    and 32 greedy tokens; the launch counts of every kernel in that run; a
    decode chunk profiled; one decode step's logits near position 400 over
    seeded f32 caches, every kernel against every plain version. Both the
    served decode and the logits check must reach more than 2 distinct
    experts a launch of 8 pairs on average."""
    import numpy as np
    import torch

    from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
    from prima_tpu_torch.ops import attention as attn
    from prima_tpu_torch.ops import kv_write as kvw
    from prima_tpu_torch.quant import qmatmul as qm
    from prima_tpu_torch.runtime.engine import Engine

    cfg, params = weights_mixtral(dev)
    counters = {"qgemv": qm.launches, "qgemv_indexed": qm.indexed_launches,
                "kv_store": kvw.store_launches, "flash_decode": attn.decode_launches,
                "flash_prefill": attn.prefill_launches}
    eng = Engine(cfg, params, n_slots=4, max_seq=4096, device=dev,
                 opts=ForwardOptions(attn_impl="kernel"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.n_vocab, int(n)).tolist()
               for n in rng.integers(480, 513, 4)]
    # the ids of every indexed launch of the serving run and of the logits
    # check (gate, up and down of a layer share one tensor), kept without a
    # copy and read afterwards
    seen, real = [], qm.qgemv_indexed

    def spy(x, qt, ids, n, **kw):
        if not seen or seen[-1] is not ids:
            seen.append(ids)
        return real(x, qt, ids, n, **kw)

    qm.qgemv_indexed = spy
    try:
        moe = serve_long(eng, prompts, 32, counters, dev, on_start=seen.clear)
    finally:
        qm.qgemv_indexed = real
    moe["indexed_ids"] = expert_use(seen, params, cfg)
    log("Mixtral-8x7B engine", json.dumps(moe))
    if not moe["launches"]["qgemv_indexed"]:
        raise AssertionError("the Mixtral decode ran without the indexed GEMV")
    moe["profile"] = profile_decode(eng, prompts)
    use = moe["indexed_ids"]["by_pairs"].get("8")
    if use:  # the chunk's 8 steps at B = 4, each distinct expert read once a launch
        moe["profile"]["indexed_bound_ms"] = 8 * use["bound_ms_per_step"]
    log("Mixtral decode chunk profile", json.dumps(moe["profile"]))
    if not moe["profile"]["device_ms"]["qgemv_indexed"] > 0:
        raise AssertionError("the profiled Mixtral decode chunk shows no indexed GEMV time")
    del eng
    gc.collect()  # the engine sits in a reference cycle with its generator
    torch.cuda.empty_cache()

    # one decode step of 4 rows near position 400 over seeded f32 caches
    pos0 = [400, 431, 390, 460]
    toks = torch.as_tensor(rng.integers(0, cfg.n_vocab, (4, 1)), device=dev)
    pos = torch.tensor(pos0, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    kv = init_kv_caches(cfg, 4, 512, torch.float32, dev)
    for pair in kv:
        for c in pair:
            c.copy_(torch.randn(c.shape, generator=gen, device=dev))
    logits = {}
    seen.clear()
    qm.qgemv_indexed = spy
    try:
        for impl in ("kernel", "plain"):
            with torch.no_grad():
                logits[impl], _ = forward(
                    params, cfg, toks, pos[:, None], kv, pos,
                    ForwardOptions(matmul_impl=impl, attn_impl=impl, dtype=torch.float32))
    finally:
        qm.qgemv_indexed = real
    moe["logits_ids"] = expert_use(seen, params, cfg)
    log("Mixtral logits check's indexed launches", json.dumps(moe["logits_ids"]))
    check_logits(moe, logits, "Mixtral decode step")
    for key, what in (("indexed_ids", "served decode"), ("logits_ids", "logits check")):
        mean = moe[key]["by_pairs"].get("8", {}).get("mean_distinct", 0.0)
        if not mean > 2:  # then every launch ran groups of 4 on 2 experts
            raise AssertionError(f"the Mixtral {what} reached {mean} distinct experts a "
                                 "launch of 8 pairs, not more than 2")
    del kv, logits, params
    gc.collect()
    torch.cuda.empty_cache()
    report["moe"] = moe
    return moe["launches"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="build,kernels,server,full,long,moe",
                    help="comma-separated subset of build,kernels,server,full,long,moe")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from prima_tpu_torch.ops import attention as attn
        from prima_tpu_torch.ops import kv_write as kvw
        from prima_tpu_torch.quant import qmatmul as qm
        from prima_tpu_torch.utils import hbm_probe, nvcc
    except ImportError as e:
        print(f"chip_smoke: run it from the repository root ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log("card:", card, "|", torch.cuda.get_device_name(0), "| torch", torch.__version__,
        "cuda", torch.version.cuda)
    report = {
        "qgemv": {"name": "qgemv", "route": "cuda", "source": "prima_tpu_torch/" + qm.SOURCE,
                  "replaces": "prima_tpu/quant/pallas/qmatmul.py:196 _qmm_kernel"},
        "qgemv_indexed": {"name": "qgemv_indexed", "route": "cuda",
                          "source": "prima_tpu_torch/" + qm.SOURCE,
                          "replaces": "prima_tpu/quant/pallas/qmatmul.py:196 _qmm_kernel "
                                      "(under prima_tpu/models/llama.py:1080-1086 moe_ffn's "
                                      "dynamic slice of the stacked experts)"},
        "kv_write": {"name": "kv_write", "route": "cuda",
                     "source": "prima_tpu_torch/" + kvw.SOURCE,
                     "replaces": "prima_tpu/ops/kv_pallas.py:33 _kv_write_kernel"},
        "kv_store": {"name": "kv_store", "route": "cuda",
                     "source": "prima_tpu_torch/" + kvw.SOURCE,
                     "replaces": "prima_tpu/ops/kv_pallas.py:33 _kv_write_kernel (twice a "
                                 "layer, with prima_tpu/ops/kvquant.py:82 quantize_kv)"},
        "flash_decode": {"name": "flash_decode", "route": "cuda",
                         "source": "prima_tpu_torch/" + attn.DECODE_SOURCE,
                         "replaces": "prima_tpu/ops/attention_pallas.py:148 _decode_kernel"},
        "flash_prefill": {"name": "flash_prefill", "route": "cuda",
                          "source": "prima_tpu_torch/" + attn.PREFILL_SOURCE,
                          "replaces": "prima_tpu/ops/attention_pallas.py:32 _attn_kernel"},
        "hbm_probe": {"name": "hbm_probe", "route": "cuda",
                      "source": "prima_tpu_torch/" + hbm_probe.SOURCE,
                      "replaces": "tools/probe_hbm.py:25 _stream_kernel "
                                  "(also bench.py:345)"},
    }
    t0 = time.time()
    logs = nvcc.build([qm.SOURCE, kvw.SOURCE, attn.DECODE_SOURCE, attn.PREFILL_SOURCE,
                       hbm_probe.SOURCE])
    log(f"build: {time.time() - t0:.1f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    if "kernels" in phases:
        t0 = time.time()
        phase_kernels(dev, report)
        log(f"kernels: {time.time() - t0:.1f} s")
    if "server" in phases:
        t0 = time.time()
        phase_server(report)
        phase_tiny_parity(report)
        log(f"server: {time.time() - t0:.1f} s")
    # launches are counted only by the main paths' runs, each with the counts
    # set to 0 just before and read just after: the long phase (its bf16
    # run), which runs the GEMV, the KV store and both flash kernels; the moe
    # phase's serving run, for the expert-indexed GEMV; the KV write's by the
    # server that restored a slot; the probe's by its own entry point
    launches = dict.fromkeys(("qgemv", "kv_store", "flash_decode", "flash_prefill"))
    if phases & {"full", "long"}:
        cfg, params = weights_8b(dev)
    if "full" in phases:
        t0 = time.time()
        phase_full(dev, report, cfg, params)
        log(f"full: {time.time() - t0:.1f} s")
    if "long" in phases:
        t0 = time.time()
        launches = dict(phase_long(dev, report, cfg, params))
        log(f"long: {time.time() - t0:.1f} s")
    if phases & {"full", "long"}:
        del params  # the 8B weights make room for Mixtral's
        gc.collect()
        torch.cuda.empty_cache()
    launches["qgemv_indexed"] = None
    if "moe" in phases:
        t0 = time.time()
        launches["qgemv_indexed"] = phase_moe(dev, report)["qgemv_indexed"]
        log(f"moe: {time.time() - t0:.1f} s")
    launches["kv_write"] = report.get("server_long_context", {}).get(
        "launches", {}).get("kv_write")
    launches["hbm_probe"] = report["hbm_probe"].get("entry_point_launches")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name in ("qgemv", "qgemv_indexed", "kv_write", "kv_store", "flash_decode",
                 "flash_prefill", "hbm_probe"):
        r = dict(report[name], launches=launches[name])
        kernels.append({k: r.get(k) for k in keys}
                       | {k: v for k, v in r.items() if k not in keys})
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "report": report, "kernels": kernels}, f, indent=1)
    summary = [{k: r[k] for k in keys} for r in kernels]
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
