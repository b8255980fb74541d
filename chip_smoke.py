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
               a shared expert); then the tiny pair's server in f32 on the
               card against the same server --device cpu: with the draft
               model (-md, 4 concurrent requests; the same text as without
               it), under a GBNF grammar and a response_format JSON schema,
               with a LoRA adapter written by the port's GGUF writer at
               scale 1.0 and, through POST /lora-adapters, at 0 (the base
               text); the draft's acceptance on the card; and the CLI on
               the card with -md and --json-schema.
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
  6. spec    — speculative decoding at full width: the 8B-shape target of
               phase 4 and a Llama-3.2-1B-shape Q4_K draft generated on the
               card, one slot, max_seq 2048, 8 drafts a round. In f32: 32
               greedy tokens from a 128-token prompt through the plain
               engine, the host SpeculativeDecoder and FusedSpeculative,
               equal streams, and each accepted position's verify logits
               against incremental decode; the target drafting for itself
               (every draft accepted, every verify chain 9 long). In bf16
               with flash attention: FusedSpeculative at force_accept 0, 4
               and 8 (tok/s, wall and device ms a round), plain fused
               decode beside it, the launch counts of these runs, the
               synchronizing calls of one call of rounds, and one verify's
               device time at chain lengths 1-9. Last, a rank-16 LoRA on
               wq, wv and w_down of every layer: one decode step's f32
               logits, every kernel against every plain version.
  7. ring    — profile_device() on the card (its fields printed) and the
               layer-window solver on [profile, profile, profile with a
               tenth of its read rate and flops] (w, n, k, removed; every
               layer owned once); the 8B shape (Q4_K, each layer drawn from
               a generator seeded by (seed, layer)) over a world-2 TCP ring
               on one card, -lw 8,8, k = 2, bf16, flash attention,
               TcpRingEngine(n_slots=4, n_groups=2), rank 1 a process of
               its own (this script with --ring-rank 1) that keeps the last
               4 layers of each window on the card and streams the other
               4: 4 requests of 128 seeded prompt tokens and 32 greedy
               tokens; a prefill chunk's and a decode step's logits equal,
               bit for bit, those of the one-process ring over the same
               groups, the streams equal it and the Engine's at 4 slots
               (logits within 1e-2 of max |logit|); rank 1's peak memory
               under its resident layers, two streamed windows, its KV
               cache and 0.5 GiB; the one-process ring at -ngl 8 (24
               layers streamed from pinned memory each step) bit for bit
               against every layer resident, then pinned against pageable
               host layers; the hop over loopback (Nagle on and off) and
               its device-to-host copy; on the tiny pair, the CLI at -w 2
               (-lw 3,1 -k 1, and with no -lw: profiles, then the solver),
               -ngl 1, and the f32 server at -w 2 (4 concurrent requests,
               and one more with -md) against the same at -w 1.
  8. moe     — Mixtral-8x7B at full width and depth (8 experts, top-2),
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
  9. tools   — this slice's paths, each with the kernel counts set to 0
               just before and read just after: bench_tool --synth 8b -p 512
               -n 128 -b 1,4 -r 3 -o json through its main (pp and tg tok/s,
               qgemv and kv_store launches); on the 8B shape (Q4_K, one slot,
               max_seq 1024, a 128-token prompt of a 16-token pattern),
               LookupDecoder with 8 drafts (64 tokens) and LookaheadDecoder
               at W = 15, N = 5, G = 15 (S = 120 rows a step, 32 tokens): in
               f32 both give plain greedy's stream, and each accepted lookup
               position's verify logits are within 1e-3 * max |logit| of
               incremental decode; in bf16 their drafts, acceptance, tok/s,
               verify or step ms and the device's idle share; over a q8_0
               cache every lookahead commit copies codes and scales bit for
               bit; two seeded perplexity chunks of 512 through the port's
               chunk_logp, --matmul kernel vs plain within 1e-3 relative
               (f32) and 1e-2 (bf16); then the tools on the tiny pair in
               f32, the card against --device cpu (simple, batched,
               parallel, speculative -md, save_load_state, passkey, lookup
               create and run, lookahead, perplexity and its KL divergence
               against the base file the run wrote, gritlm): equal exit codes
               and stdout, gritlm embeddings at cosine >= 0.9999;
               batched_bench and profile_tool run and exit 0.
 10. quant   — the activation taps and the quantize toolchain, the kernel
               counts set to 0 before each path and read after it: on the 8B
               shape (Q4_K, generated on the card, a tokenizer that gives
               seeded ids), imatrix over two chunks of 512 in bf16 (225
               entries, finite, >= 0, nonzero; a chunk's wall and device ms,
               idle share and host syncs; a tapped forward synchronizes no
               more than an untapped one) and at -c 16 in f32, kernels vs
               plain; eval_callback's forward of 16 tokens in f32, kernels vs
               plain (each tap's rms / min / max, the top-5 ids);
               cvector_generator from two prompt pairs in f32, kernels vs
               plain (cosine a layer), its file loaded as a control vector
               on the 8B engine, which decodes 8 tokens; layer 0 dequantized
               to the host, quantized to Q4_K by the port's quantize_np
               (attn_k weighted by the imatrix through an imatrix file),
               written by the port's GGUFWriter, loaded by the port's loader
               and held through qgemv against qmatmul_plain at B = 1 and 4;
               then on the tiny pair in f32, the card against --device cpu:
               imatrix at -c 64, quantize to Q4_K_M with it and 16 greedy
               tokens of the result, quantize_stats, export_lora, gguf_split
               and its merge, gguf_hash, tokenize and gbnf_validator.
 11. embed   — the embedding server at full width: a BAAI/bge-base-en-v1.5-
               shape GGUF (12 layers, 768 wide, 12 heads, FFN 3072, a WPM
               vocabulary of 30522, 512 positions, CLS pooling) and a
               cross-encoder/ms-marco-MiniLM-L-6-v2-shape one (6 layers, 384
               wide, a cls / cls.output rank head), Q8_0 weights from a seed,
               written by the port's GGUFWriter; in process, 8 texts of 8-24
               tokens (72 qgemv launches a forward) and 4 of 128-512 (the
               dense path, no launch), kernels against plain within 1e-4 of
               max |v|, wall and device ms, idle share and peak memory; then
               python -m prima_tpu_torch.server on each GGUF: /health,
               /v1/models, the short and the long texts, the short ones as 4
               concurrent requests (equal bits), a /v1/rerank of 8 documents
               with top_n 3, each against the plain runtime; the embedding
               and retrieval tools on a tiny bert, card against CPU.
 12. vision  — llava-1.5-7b at full width: CLIP ViT-L/14-336 (24 layers, 23
               run) with an mlp projector into 4096 dims, f32 weights from a
               seed, on a seeded normalized image, card against CPU within
               1e-4 of max |out|; Llama-2-7B with centred Q4_K weights
               generated on the card through LlavaRuntime: 5 text tokens,
               the 576 image embeddings, 12 text tokens and 32 greedy
               tokens, kernels against plain in f32 (logits within 1e-3 of
               max |logit|, equal argmax and streams), then in bf16: CLIP
               ms, the splice's prefill ms, decode tok/s, idle share, peak
               memory, and 225 qgemv and 32 kv_store launches a decode step.
 13. families — the dense family runtimes at full width, weights from seeds
               at the scale of HF's initializers: DeepSeek-V2-Lite (27
               layers, 64 routed experts of 1408, top-6, two shared, YaRN
               factor 40) in bf16, Mamba-2.8B, RWKV-6 Finch 1.6B and
               Flan-T5-Large in f32; each first at full width and 2 or 4
               layers in f32, the card's generate against one teacher-forced
               CPU forward (logits within 1e-3 of max |logit|, argmax and top
               5 ids equal at every step), then at full depth (DeepSeek-V2-
               Lite at 14 of its 27 layers, to keep the script inside its 20
               minutes): prefill ms,
               per-token wall and device ms, idle share, peak memory, and for
               Mamba and RWKV-6 the decode's logits against one full-sequence
               forward; then tiny deepseek2 (served through Engine),
               minicpm3, mamba, rwkv6 and t5 GGUFs through the CLI, card
               against --device cpu. None of
               these runs may launch a hand kernel.
 14. mesh    — the mesh plane (--pp/--tp/--dp) over torch.distributed, several
               ranks on this card, so gloo with host staging (the transport is
               printed): the 8B shape (Q4_K layers drawn on the card from
               generators seeded by (seed, layer)) at pp 2 x tp 2, k = 2, 2
               microbatches of 2 rows, world 4, f32 with f32 caches; 4 requests
               of 128 prompt tokens and 32 greedy tokens through
               DistributedEngine.step_fused against the one-process Engine over
               the same weights (every decode step's logits within 1e-3 of max
               |logit|, argmax equal save ties, equal streams), qgemv and
               kv_store launches on every rank, prefill and decode tok/s, the
               hop's and the all-reduces' ms and bytes, every rank's peak
               memory and rank 0's idle share; sp = 2 at the 8B width over 2
               layers with a 4000-token prompt against the one-process forward;
               the streamed pipe (pp 2, k 2, half of each window streamed, bf16)
               bit for bit against the resident pipe, each rank's peak against
               k * n_res + 2 * (W - n_res) layers; the tiny pair's f32 server at
               --pp 2 --tp 2 against the single-device server, and --lora over a
               mesh exiting 1.
 15. train   — train_tiny_pair's step (autograd, clip, AdamW, the schedule) on
               the tiny target shape for 50 steps on the card and on the CPU
               from the same init and batches (losses within 1e-4 relative),
               seconds a step, then save_gguf and 8 greedy tokens of the file,
               card = CPU.
 16. native  — the native C++ layer at full width: a Llama-3-8B-shape GGUF of
               32 layers (types from QuantPlanner at Q4_K_M, seeded block
               bytes, a BPE vocabulary learned from the repository's
               Markdown) written by the port's GGUFWriter and loaded with
               load_model(device="cuda"): every quantized tensor converted
               natively, seconds and GB/s split into block conversion and H2D
               copies, peak host RSS and device memory, then 4 requests of 64
               + 16 greedy tokens through step_fused (qgemv and kv_store
               launched); the same widths at 8 layers loaded natively and
               under PRIMA_NO_NATIVE=1 (no conversion counted): every QTensor
               field, the 4 streams and one f32 decode step's logits equal bit
               for bit; ~200 KB of that Markdown through the native and Python
               merge loops of the BPE and of an SPM vocabulary (equal ids,
               MB/s).
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
import concurrent.futures
import contextlib
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
    for K and for V), exact bits for dense values, codes and scales, at the
    8B's GQA shapes and at phase vision's Llama-2-7B rows; its time beside
    the two launches it replaces (two kv_write for a dense cache, two
    update_kv for a quantized one) and two index_copy_."""
    import torch

    from prima_tpu_torch.ops import kv_write as kvw
    from prima_tpu_torch.ops import kvquant as kvq

    bf16, f32 = torch.bfloat16, torch.float32
    d = 128
    # llava-1.5-7b's Llama-2-7B (MHA, 32 heads) at phase vision's rows: the
    # 5-token prefix, the 576 image rows, the 12-token suffix, a decode step
    p_img, p_suf = VISION_PREFIX, VISION_PREFIX + 576
    p_dec = p_suf + VISION_SUFFIX
    llava = [(f"Llama-2-7B {what}, {name} cache (vision path)", 1, n, VISION_CTX, 32,
              "dense", dt, [p])
             for what, n, p in (("prefix 5", VISION_PREFIX, 0), ("image 576", 576, p_img),
                                ("suffix 12", VISION_SUFFIX, p_suf), ("decode", 1, p_dec))
             for name, dt in (("bf16", bf16), ("f32", f32))]
    scases = []
    for label, b, s, t_, h, kind, dt, pos in [
            ("8B decode, bf16 cache (main path)", 4, 1, 8192, 8, "dense", bf16,
             [4000, 4031, 9000, 4060]),
            ("8B decode, q8_0 cache (main path)", 4, 1, 8192, 8, "q8_0", bf16,
             [4000, 4031, 9000, 4060]),
            ("8B decode, q4_0 cache", 4, 1, 8192, 8, "q4_0", bf16, [4000, 4031, 9000, 4060]),
            ("8B decode, f32 cache", 4, 1, 8192, 8, "dense", f32, [4000, 4031, 9000, 4060]),
            ("8B prefill 256 (slot row), bf16 cache", 1, 256, 8192, 8, "dense", bf16, [3840]),
            ("8B prefill 256 (slot row), q8_0 cache", 1, 256, 8192, 8, "q8_0", bf16, [8000]),
            ("8B prefill 256 (slot row), q4_0 cache", 1, 256, 8192, 8, "q4_0", bf16, [3840]),
            ("8B prefill 256 (slot row), f32 cache", 1, 256, 8192, 8, "dense", f32, [8000]),
            *llava]:
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


def _start_server(extra: list[str], device: str = "cuda", model: str = TINY):
    """python -m prima_tpu_torch.server on `model` (the tiny model) with
    `extra` flags; returns (process, port, its output lines, seconds to come
    up) once /health answers."""
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "prima_tpu_torch.server", "-m", model,
                             "--device", device, "--port", str(port), *extra], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out: list[str] = []
    reader = threading.Thread(target=lambda: out.extend(proc.stdout), daemon=True)
    reader.start()
    t0 = time.time()
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError("server exited:\n" + "".join(out))
            try:
                if _get(port, "/health").get("status") == "ok":
                    return proc, port, out, time.time() - t0
            except OSError:
                pass
            if time.time() - t0 > 240:
                raise AssertionError("server did not come up:\n" + "".join(out))
            time.sleep(0.5)
    except BaseException:
        _stop(proc)
        raise


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _server(extra: list[str], report: dict, key: str, slots: bool = False) -> None:
    """Start the server on the tiny model with `extra` flags, answer the
    concurrent requests (and save slot 0 and restore it into slot 1 when
    `slots`), check that the default path's kernels ran, stop it."""
    proc, port, out, up_s = _start_server(extra)
    try:
        log(f"server {' '.join(extra) or '(defaults)'} up in {up_s:.1f} s")
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
        _stop(proc)


def phase_server(report: dict) -> None:
    _server([], report, "server")
    slot_dir = os.path.join(ROOT, "build", "chip_smoke_slots")
    os.makedirs(slot_dir, exist_ok=True)
    _server(["-ctk", "q8_0", "-gan", "2", "-gaw", "64", "--slot-save-path", slot_dir],
            report, "server_long_context", slots=True)
    phase_server_f32(report)
    phase_cli(report)


DRAFT = os.path.join("models_tiny_pair", "draft.gguf")
F32_SERVER = ["--dtype", "f32", "-ctk", "f32"]
GBNF = 'root ::= ("yes" | "no" | "maybe") " " [a-z]+ (" " [a-z]+)* "."'
SCHEMA = {"type": "object", "properties": {"name": {"type": "string"},
                                           "age": {"type": "integer"}},
          "required": ["name", "age"]}
LORA_TEXTS = ["Once upon a time", "The quick brown fox"]


def write_tiny_lora(path: str, seed: int = 4) -> str:
    """A rank-8 LoRA GGUF for every projection of the tiny target, written
    with the port's GGUF writer from a seed."""
    import numpy as np

    from prima_tpu_torch.gguf.reader import GGUFModel
    from prima_tpu_torch.gguf.writer import GGUFWriter
    from prima_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.from_gguf(GGUFModel.open(os.path.join(ROOT, TINY)))
    e, f, nq, nk = (cfg.n_embd, cfg.n_ff, cfg.n_heads * cfg.head_dim,
                    cfg.n_kv_heads * cfg.head_dim)
    shapes = {"attn_q": (nq, e), "attn_k": (nk, e), "attn_v": (nk, e), "attn_output": (e, nq),
              "ffn_gate": (f, e), "ffn_up": (f, e), "ffn_down": (e, f)}
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, arch="llama")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.alpha", 16.0)
    for li in range(cfg.n_layers):
        for name, (n, k) in shapes.items():
            w.add_tensor(f"blk.{li}.{name}.weight.lora_a",
                         (rng.standard_normal((8, k)) * 0.2).astype(np.float32))
            w.add_tensor(f"blk.{li}.{name}.weight.lora_b",
                         (rng.standard_normal((n, 8)) * 0.2).astype(np.float32))
    w.write()
    return path


def _texts(port: int, bodies: list[dict], concurrent: bool = False) -> list[str]:
    """The /completion text of each body, one after another or all at once."""
    out: dict = {}

    def one(i, body):
        out[i] = _post(port, "/completion", body)["choices"][0]["text"]

    if not concurrent:
        for i, body in enumerate(bodies):
            one(i, body)
        return [out[i] for i in range(len(bodies))]
    threads = [threading.Thread(target=one, args=(i, b)) for i, b in enumerate(bodies)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if len(out) != len(bodies):
        raise AssertionError(f"only {len(out)} of {len(bodies)} requests answered")
    return [out[i] for i in range(len(bodies))]


def _f32_server_run(device: str, lora: str, lora_tokens: list) -> dict:
    """The tiny pair's servers in f32 on `device`: with the draft model (4
    concurrent greedy requests), without it (the same requests, a GBNF and
    a response_format JSON-schema request, the LoRA prompts' base text), and
    with the LoRA adapter at scale 1.0, then at scale 0 through
    POST /lora-adapters."""
    greedy = [{"prompt": p, "n_predict": 32, "temperature": 0} for p in PROMPTS]
    # token prompts without BOS, each with another first token, so that no
    # request reuses a prefix cached at another adapter scale
    lora_bodies = [{"prompt": t, "n_predict": 32, "temperature": 0} for t in lora_tokens]
    res: dict = {}
    for key, flags in (("draft", ["-md", DRAFT]), ("plain", []),
                       ("lora", ["--lora", lora])):
        proc, port, out, up_s = _start_server(F32_SERVER + flags, device)
        try:
            if key == "draft":
                res["draft"] = _texts(port, greedy, concurrent=True)
            elif key == "plain":
                res["plain"] = _texts(port, greedy, concurrent=True)
                res["gbnf"], res["json_schema"] = _texts(port, [
                    {"prompt": "Once upon a time", "n_predict": 32, "temperature": 0,
                     "grammar": GBNF},
                    {"prompt": "Once upon a time", "n_predict": 48, "temperature": 0,
                     "response_format": {"type": "json_schema",
                                         "json_schema": {"schema": SCHEMA}}}])
                res["lora_base"] = _texts(port, lora_bodies)
            else:
                listed = _get(port, "/lora-adapters")
                if [r["scale"] for r in listed] != [1.0]:
                    raise AssertionError(f"/lora-adapters: {listed}")
                res["lora_1"] = _texts(port, lora_bodies[:1])
                _post(port, "/lora-adapters", [{"id": 0, "scale": 0.0}])
                res["lora_0"] = _texts(port, lora_bodies[1:])
        finally:
            _stop(proc)
        log(f"f32 server {' '.join(flags) or '(no draft)'} on {device}: up in {up_s:.1f} s")
    return res


def phase_server_f32(report: dict) -> None:
    """The tiny pair's f32 servers on the card against the same servers
    --device cpu: equal text with the draft model (which equals the text
    without it), under a GBNF grammar and a JSON schema, and with a LoRA
    adapter at scale 1.0 and at 0 (the base text again). The draft's
    acceptance on the card comes from the same decoder run in process."""
    import torch

    from prima_tpu_torch.grammar import GrammarMatcher, parse_gbnf
    from prima_tpu_torch.grammar.json_schema import json_schema_to_gbnf
    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.models.loader import load_model
    from prima_tpu_torch.runtime.engine import Engine
    from prima_tpu_torch.runtime.speculative import SpecStats, SpeculativeDecoder

    os.makedirs(os.path.join(ROOT, "build", "chip_smoke"), exist_ok=True)
    lora = write_tiny_lora(os.path.join(ROOT, "build", "chip_smoke", "tiny_lora.gguf"))
    tok = load_model(TINY, device="cpu").tokenizer
    # the byte tokenizer starts every text with the 3 bytes of its space mark
    lora_tokens = [tok.encode(t, add_special=False)[3:] for t in LORA_TEXTS]
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:  # independent processes
        runs = [ex.submit(_f32_server_run, d, lora, lora_tokens) for d in ("cuda", "cpu")]
        card, cpu = (f.result() for f in runs)
    for key, texts in card.items():
        log(f"f32 server {key}: card {texts!r}")
        if texts != cpu[key]:
            raise AssertionError(f"f32 server {key}: card {texts!r} cpu {cpu[key]!r}")
    if card["draft"] != card["plain"]:
        raise AssertionError("the server's text with the draft model differs from without")
    if card["lora_0"] != card["lora_base"][1:] or card["lora_1"] == card["lora_base"][:1]:
        raise AssertionError(f"LoRA: scale 1 {card['lora_1']!r}, scale 0 {card['lora_0']!r},"
                             f" base {card['lora_base']!r}")
    for key, gtext in (("gbnf", GBNF), ("json_schema", json_schema_to_gbnf(SCHEMA))):
        if not card[key] or not GrammarMatcher(parse_gbnf(gtext)).advance_text(
                card[key].encode()):
            raise AssertionError(f"{key} text {card[key]!r} is not in its grammar")
    # the draft's acceptance over the 4 prompts on the card, in process
    m, dm = load_model(TINY, device="cuda"), load_model(DRAFT, device="cuda")
    mk = lambda mm: Engine(mm.cfg, mm.params, n_slots=1, max_seq=256, device="cuda",
                           opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                           eog_ids=mm.eog_ids)
    stats = SpecStats()
    spec = SpeculativeDecoder(mk(m), mk(dm))
    for p in PROMPTS:
        for _ in spec.generate_stream(m.tokenizer.encode(p, add_special=True), n_predict=32,
                                      stats=stats):
            pass
    log(f"tiny pair on the card: {stats.n_accepted} of {stats.n_drafted} drafts accepted "
        f"({stats.acceptance:.3f}) in {stats.n_target_calls} verify rounds")
    report["server_f32"] = {"identical_card_cpu": sorted(card), "texts": card,
                            "draft_acceptance": stats.acceptance,
                            "drafted": stats.n_drafted, "accepted": stats.n_accepted,
                            "verify_rounds": stats.n_target_calls, "wall_s": time.time() - t0}


def phase_cli(report: dict) -> None:
    """python -m prima_tpu_torch.tools.cli on the card: with the draft model
    and a JSON schema, and with the JSON schema alone (its perf line gives
    the grammar path's decode rate)."""
    from prima_tpu_torch.grammar import GrammarMatcher, parse_gbnf
    from prima_tpu_torch.grammar.json_schema import json_schema_to_gbnf

    schema = json.dumps(SCHEMA)
    report["cli"] = {}
    for key, extra in (("draft_json_schema", ["-md", DRAFT]), ("json_schema", [])):
        t0 = time.time()
        run = subprocess.run(
            [sys.executable, "-m", "prima_tpu_torch.tools.cli", "-m", TINY, "-p",
             "Once upon a time", "-n", "48", "--temp", "0", "--no-display-prompt",
             "--json-schema", schema, "-v", *extra], cwd=ROOT, capture_output=True,
            text=True, timeout=300)
        wall = time.time() - t0
        perf = [ln for ln in run.stderr.splitlines() if ln.startswith("prompt eval")]
        log(f"cli {' '.join(extra + ['--json-schema'])}: rc {run.returncode}, "
            f"{wall:.1f} s, {run.stdout.strip()!r} | {perf[-1] if perf else ''}")
        if run.returncode != 0:
            raise AssertionError(f"cli failed: {run.stderr[-2000:]}")
        if not GrammarMatcher(parse_gbnf(json_schema_to_gbnf(SCHEMA))).advance_text(
                run.stdout.strip().encode()):
            raise AssertionError(f"cli output {run.stdout!r} is not in the schema's grammar")
        report["cli"][key] = {"text": run.stdout.strip(), "wall_s": wall,
                              "perf": perf[-1] if perf else None}


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


# ---------------------------------------------------------------------------
# phase 7: speculative decoding at full width
# ---------------------------------------------------------------------------

# Llama-3.2-1B's config.json (tied embeddings), without its llama3 RoPE
# frequency factors, as the 8B target leaves them out
LLAMA32_1B = dict(n_layers=16, n_embd=2048, n_heads=32, n_kv_heads=8, head_dim=64,
                  n_ff=8192, n_vocab=128256, n_ctx_train=131072, rope_base=500000.0,
                  rope_dim=64, tie_embeddings=True)


def weights_draft(dev):
    """The Llama-3.2-1B shape with Q4_K weights generated on the card from
    another seed than the target's."""
    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.config import tiny_config
    from prima_tpu_torch.models.llama import synth_params_device

    cfg = tiny_config(**LLAMA32_1B)
    return cfg, synth_params_device(cfg, GGMLType.Q4_K, seed=1, device=dev)


def spec_engine(cfg, params, dev, dtype, attn_impl: str = "plain"):
    import torch

    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.runtime.engine import Engine

    return Engine(cfg, params, n_slots=1, max_seq=2048, device=dev, kv_dtype=dtype,
                  opts=ForwardOptions(attn_impl=attn_impl, dtype=dtype))


def free(*engines) -> None:
    import torch

    for e in engines:
        e.kv.caches = None
    gc.collect()  # an engine sits in a reference cycle with its generator
    torch.cuda.empty_cache()


def spec_identity(dev, cfg, params, dcfg, dparams, prompt: list) -> dict:
    """32 greedy tokens in f32 from the plain engine, the host
    SpeculativeDecoder and FusedSpeculative (8 drafts a round, p_min 0.75):
    equal streams, and each accepted position's verify logits within
    LOGITS_TOL * max |logit| of the plain engine's incremental step."""
    import numpy as np
    import torch

    from prima_tpu_torch.runtime.speculative import SpecStats, SpeculativeDecoder
    from prima_tpu_torch.runtime.speculative_fused import FusedSpeculative

    plain = spec_engine(cfg, params, dev, torch.float32)
    steps, real = [], plain._decode_raw

    def record(*a):
        logits, caches = real(*a)
        steps.append(logits[0].float().cpu().numpy())
        return logits, caches

    plain._decode_raw = record
    want = plain.run_to_completion(prompt, n_predict=32)
    free(plain)
    t, d = spec_engine(cfg, params, dev, torch.float32), spec_engine(dcfg, dparams, dev,
                                                                      torch.float32)
    chains, verify = [], t.verify_chain
    t.verify_chain = lambda sid, chain: chains.append(verify(sid, chain)) or chains[-1]
    os.environ["PRIMA_SPEC_FUSED"] = "0"
    host = SpecStats()
    try:
        rounds = list(SpeculativeDecoder(t, d, n_draft=8).generate_stream(prompt, n_predict=32,
                                                                          stats=host))
    finally:
        del os.environ["PRIMA_SPEC_FUSED"]
    got = [x for r in rounds for x in r]
    n, worst = 0, 0.0
    for r, logits in zip(rounds, chains):
        for j in range(len(r)):
            ref = steps[n + j]
            worst = max(worst, float(np.abs(logits[j] - ref).max() / np.abs(ref).max()))
        n += len(r)
    fused, fstats = FusedSpeculative(t, d, n_draft=8).generate(prompt, n_predict=32)
    free(t, d)
    out = {"tokens": 32, "plain": want, "host_equal": got == want, "fused_equal": fused == want,
           "host": vars(host), "fused": vars(fstats), "verify_rounds": len(chains),
           "verify_logits_max_rel_err": worst,
           "tolerance": f"max|verify - incremental| <= {LOGITS_TOL} * max|logit| (f32)"}
    log("spec greedy identity (f32)", json.dumps(out))
    if not (out["host_equal"] and out["fused_equal"]):
        raise AssertionError(f"speculative streams differ: plain {want} host {got} "
                             f"fused {fused}")
    if not worst <= LOGITS_TOL:
        raise AssertionError(f"verify logits {worst} of max |logit| from incremental decode")
    return out


def spec_self_draft(dev, cfg, params, prompt: list) -> dict:
    """The target drafting for itself (a second engine on the same weights,
    f32, p_min 0 so that every round drafts 8): every draft is accepted and
    every host verify chain is 9 long; 36 tokens are 4 such rounds."""
    import torch

    from prima_tpu_torch.runtime.speculative import SpecStats, SpeculativeDecoder
    from prima_tpu_torch.runtime.speculative_fused import FusedSpeculative

    t, d = spec_engine(cfg, params, dev, torch.float32), spec_engine(cfg, params, dev,
                                                                      torch.float32)
    lengths, verify = [], t.verify_chain
    t.verify_chain = lambda sid, chain: lengths.append(len(chain)) or verify(sid, chain)
    os.environ["PRIMA_SPEC_FUSED"] = "0"
    host = SpecStats()
    try:
        got = [x for r in SpeculativeDecoder(t, d, n_draft=8, p_min=0.0).generate_stream(
            prompt, n_predict=36, stats=host) for x in r]
    finally:
        del os.environ["PRIMA_SPEC_FUSED"]
    fused, fstats = FusedSpeculative(t, d, n_draft=8, p_min=0.0).generate(prompt, n_predict=36)
    free(t, d)
    out = {"host": vars(host), "fused": vars(fstats), "host_chain_lengths": lengths,
           "streams_equal": got == fused}
    log("spec target as its own draft (f32)", json.dumps(out))
    for st in (host, fstats):
        if not (st.n_drafted == 32 and st.n_accepted == st.n_drafted):
            raise AssertionError(f"target as draft: {st}")
    if lengths != [9] * 4 or got != fused:
        raise AssertionError(f"target as draft: chains {lengths}, streams equal {got == fused}")
    return out


def verify_cost(t, dev, cfg, rng) -> list:
    """Device ms of one verify forward of a chain of 1-9 tokens at position
    1024 of the target's slot row (bf16, flash attention), by kernel, beside
    the bytes bound of reading the GEMV's weights once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from prima_tpu_torch.quant.qtensor import QTensor

    weights = [w for layer in t.params["layers"] for w in layer.values()
               if isinstance(w, QTensor)] + [t.params["output"]]
    wbytes = sum(w.nbytes for w in weights)
    row = t.slot_row(0)
    out = []
    for n in range(1, 10):
        toks = torch.as_tensor(rng.integers(0, cfg.n_vocab, (1, n)), device=dev)
        pos = torch.arange(1024, 1024 + n, dtype=torch.int32, device=dev)[None]
        call = lambda: t._fwd_raw(t.params, row, toks, pos, pos[:, 0].contiguous(), pos)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        by, _ = device_ms(prof)
        out.append({"chain": n, "device_ms": sum(by.values()), "by_kernel_ms": by,
                    "gemv_passes": -(-n // 8),
                    "gemv_bound_ms": wbytes / HBM_BYTES_PER_S * 1e3})
        log(f"verify chain {n}: {sum(by.values()):.3f} ms device (qgemv {by['qgemv']:.3f}, "
            f"flash_decode {by['flash_decode']:.3f}, flash_prefill {by['flash_prefill']:.3f}, "
            f"kv_store {by['kv_store']:.3f}); GEMV bound {out[-1]['gemv_bound_ms']:.3f}")
    return out


def count_syncs(fn) -> dict:
    """Run fn() under torch.cuda.set_sync_debug_mode("warn"): the
    synchronizing calls it made, by the innermost line of the port on the
    stack of each."""
    import traceback
    import warnings

    import torch

    pkg = os.path.join(ROOT, "prima_tpu_torch")
    where: Counter = Counter()
    inside = [False]  # switching the mode itself synchronizes once: not fn's

    def record(message, category, filename, lineno, file=None, line=None):
        if not inside[0] or "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        mine = [f for f in stack if f.filename.startswith(pkg)]
        # else the innermost caller outside torch and this function
        f = (mine or [f for f in stack if f.filename.startswith(ROOT)] or stack)[-1]
        thread = threading.current_thread().name
        where[f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} ({thread})"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        inside[0] = True
        try:
            fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode(0)
    return {"count": sum(where.values()), "by_line": dict(where.most_common())}


def spec_cost(dev, cfg, params, dcfg, dparams, prompt: list, rng) -> dict:
    """bf16, flash attention: FusedSpeculative at force_accept 0, 4 and 8
    (8 drafts a round, 8 rounds a call, p_min 0 so that every chain is 9
    long): tokens per second and wall ms a round of one call, device ms a
    round of the next under the profiler; plain fused decode of the target
    beside it; the kernels' launches over these runs; the synchronizing
    calls of one call of rounds; one verify's device time by chain length."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from prima_tpu_torch.ops import attention as attn
    from prima_tpu_torch.ops import kv_write as kvw
    from prima_tpu_torch.quant import qmatmul as qm
    from prima_tpu_torch.runtime.engine import SlotState
    from prima_tpu_torch.runtime.speculative_fused import FusedSpeculative

    t = spec_engine(cfg, params, dev, torch.bfloat16, "kernel")
    d = spec_engine(dcfg, dparams, dev, torch.bfloat16, "kernel")
    counters = {"qgemv": qm.launches, "flash_decode": attn.decode_launches,
                "flash_prefill": attn.prefill_launches, "kv_store": kvw.store_launches}
    t.run_to_completion(prompt[:16], n_predict=2)  # warm-up, not counted
    torch.cuda.synchronize()
    for c in counters.values():
        c.count = 0
    out = {"rounds_per_call": 8, "n_draft": 8, "by_force_accept": {}}
    for fa in (0, 4, 8):
        fs = FusedSpeculative(t, d, n_draft=8, p_min=0.0, rounds=8, force_accept=fa)
        gen = fs.generate_stream(prompt, n_predict=3 * 8 * (fa + 1))
        next(gen)  # prefill and the first call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = next(gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            next(gen)
            torch.cuda.synchronize()
        gen.close()
        by, top = device_ms(prof)
        r = {"tokens_per_call": len(toks), "tok_s": len(toks) / wall,
             "wall_ms_per_round": wall * 1e3 / 8,
             "device_ms_per_round": sum(by.values()) / 8,
             "device_idle_share": 1 - sum(by.values()) / (wall * 1e3),
             "device_ms_per_call": by, "top_kernels_ms": top}
        out["by_force_accept"][fa] = r
        log(f"spec force_accept {fa}: {len(toks)} tokens a call, {r['tok_s']:.1f} tok/s, "
            f"{r['wall_ms_per_round']:.1f} ms wall and {r['device_ms_per_round']:.2f} ms "
            f"device a round")
    out["launches"] = {k: c.count for k, c in counters.items()}
    log("spec launches (bf16, flash attention, 3 force_accept levels)",
        json.dumps(out["launches"]))
    if not all(out["launches"].values()):
        raise AssertionError(f"the speculative path ran without a kernel: {out['launches']}")
    # the plain fused decode of the target alone, one 8-step chunk timed
    slot = t.submit(prompt, n_predict=24)
    t.step_fused(max_chunk=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = len(t.step_fused(max_chunk=8))
    torch.cuda.synchronize()
    out["plain_fused_tok_s"] = n / (time.perf_counter() - t0)
    while slot.state != SlotState.IDLE:
        t.step_fused(max_chunk=8)
    log(f"plain fused decode of the target: {out['plain_fused_tok_s']:.1f} tok/s")
    # the synchronizing calls of one call of 8 rounds (after the first call)
    gen = FusedSpeculative(t, d, n_draft=8, p_min=0.0, rounds=8,
                           force_accept=4).generate_stream(prompt, n_predict=80)
    next(gen)
    torch.cuda.synchronize()
    out["syncs_per_call"] = count_syncs(lambda: next(gen))
    gen.close()
    log("synchronizing calls in one call of 8 rounds", json.dumps(out["syncs_per_call"]))
    out["verify"] = verify_cost(t, dev, cfg, rng)
    free(t, d)
    return out


def spec_lora(dev, cfg, params) -> dict:
    """A rank-16 LoRA from a seed on wq, wv and w_down of every layer: one
    decode step's f32 logits at 4 rows, every kernel against every plain
    version, and how far the adapter moves them."""
    import torch

    from prima_tpu_torch.models.adapters import apply_lora
    from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    e, nq, nk, f = (cfg.n_embd, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim,
                    cfg.n_ff)
    # strong enough to move logits that the random weights' common mode
    # dominates (at 0.02 it moved them by 3.5e-5 of their largest)
    ab = lambda n, k: (torch.randn((16, k), generator=gen, device=dev) * 0.2,
                       torch.randn((n, 16), generator=gen, device=dev) * 0.2, 2.0)
    lora = {i: {"wq": ab(nq, e), "wv": ab(nk, e), "w_down": ab(e, f)}
            for i in range(cfg.n_layers)}
    lparams = apply_lora(params, lora)
    toks = torch.as_tensor([[11], [2024], [77777], [128000]], device=dev) % cfg.n_vocab
    logits = {}
    for name, p, impl in (("kernel", lparams, "kernel"), ("plain", lparams, "plain"),
                          ("base", params, "kernel")):
        kv = init_kv_caches(cfg, 4, 64, torch.float32, dev)
        with torch.no_grad():
            logits[name], _ = forward(
                p, cfg, toks, torch.zeros((4, 1), dtype=torch.int32, device=dev), kv,
                torch.zeros(4, dtype=torch.int32, device=dev),
                ForwardOptions(matmul_impl=impl, dtype=torch.float32))
    out = {"rank": 16, "targets": ["wq", "wv", "w_down"], "layers": cfg.n_layers,
           "moved_by": (logits["kernel"] - logits["base"]).abs().max().item()}
    check_logits(out, logits, "8B with LoRA")
    if not out["moved_by"] > 1e-3 * out["logits_max_abs"]:
        raise AssertionError(f"the LoRA moved the logits by {out['moved_by']} only")
    return out


def phase_spec(dev, report: dict, cfg, params) -> None:
    """Speculative decoding at full width: the 8B-shape target, a
    Llama-3.2-1B-shape draft, one slot, max_seq 2048, 8 drafts a round."""
    import numpy as np
    import torch

    dcfg, dparams = weights_draft(dev)
    torch.cuda.synchronize()
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.n_vocab, 128).tolist()
    spec = {"target": "8B shape Q4_K", "draft": "Llama-3.2-1B shape Q4_K", "max_seq": 2048,
            "prompt_tokens": 128}
    spec["identity"] = spec_identity(dev, cfg, params, dcfg, dparams, prompt)
    spec["self_draft"] = spec_self_draft(dev, cfg, params, prompt)
    spec["cost"] = spec_cost(dev, cfg, params, dcfg, dparams, prompt, rng)
    spec["lora"] = spec_lora(dev, cfg, params)
    report["spec"] = spec
    del dparams
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase ring: the device profiler, the layer-window solver, the TCP ring
# ---------------------------------------------------------------------------

# world 2, -lw 8,8, k = 2; rank 1 keeps the last 4 layers of each window on
# the card and streams the other 4; 4 slots in 2 groups; 4 requests of 128
# seeded prompt tokens and 32 greedy tokens
RING = dict(windows=[8, 8], k=2, resident=4, n_slots=4, n_groups=2, max_seq=512,
            n_batch=128, prompt=128, gen=32, seed=7, ngl=8)
RING_DEADLINE = 300.0  # seconds: every socket wait of the ring and every rank process
RING_TOL = 1e-2  # the ring's logits vs the Engine's (B = 2 vs 4): the bf16 tolerance
RING_MARK = "count_mark"  # a kv message that only this script's rank 1 knows


def ring_layer(cfg, i: int, dev):
    """Layer i of the ring's 8B-shape model: Q4_K weights drawn on the card
    from a generator seeded by (seed, i), so that every process that makes
    layer i makes the same one."""
    import torch

    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.llama import synth_layer_device

    gen = torch.Generator(device=dev)
    gen.manual_seed(RING["seed"] * 1000 + 1 + i)
    return synth_layer_device(cfg, gen, GGMLType.Q4_K, dev)


def ring_params(cfg, dev, resident, streamed=(), head: bool = False) -> tuple:
    """(params with the `resident` layers on the card and None for the
    others, the `streamed` layers packed in pinned host memory)."""
    import torch

    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.llama import synth_head_device
    from prima_tpu_torch.runtime.streaming import pack_host_layer

    params: dict = {"layers": [None] * cfg.n_layers}
    if head:
        gen = torch.Generator(device=dev)
        gen.manual_seed(RING["seed"] * 1000)
        params.update(synth_head_device(cfg, gen, GGMLType.Q4_K, dev))
    host = {}
    for i in sorted(set(resident) | set(streamed)):
        layer = ring_layer(cfg, i, dev)
        if i in streamed:
            host[i] = pack_host_layer(layer, pin=True)
        else:
            params["layers"][i] = layer
    torch.cuda.synchronize(dev)
    return params, host or None


def ring_split(plan, rank: int, resident: int) -> tuple[set, set]:
    """(resident, streamed) layers of a rank that keeps the last `resident`
    layers of each window on the card (src/llama.cpp:7597-7605)."""
    streamed = {i for lo, hi in plan.layer_ranges()[rank] for i in range(lo, hi - resident)}
    return plan.owned(rank) - streamed, streamed


def kernel_counts() -> dict:
    from prima_tpu_torch.ops import attention as attn
    from prima_tpu_torch.ops import kv_write as kvw
    from prima_tpu_torch.quant import qmatmul as qm

    return {"qgemv": qm.launches, "kv_store": kvw.store_launches,
            "flash_decode": attn.decode_launches, "flash_prefill": attn.prefill_launches}


def ring_worker_main(port: int, out_path: str) -> int:
    """Rank 1 of the full-width ring, a process of its own: its layers
    (8-15 and 24-31, the first 4 of each window streamed), its windows'
    service loop until STOP, then its peak memory, bytes and launches."""
    import torch

    from prima_tpu_torch.models.config import tiny_config
    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.parallel.bootstrap import RingConfig, RingNode
    from prima_tpu_torch.parallel.ring_host import RingPlan
    from prima_tpu_torch.parallel.ring_tcp import RingContext, TcpRingWorker
    from prima_tpu_torch.runtime.streaming import layer_nbytes

    dev = torch.device("cuda", 0)
    cfg = tiny_config(**LLAMA3_8B)
    plan = RingPlan(RING["windows"], RING["k"])
    node = RingNode(RingConfig(rank=1, world=2, data_port=port))
    node.listener.settimeout(RING_DEADLINE)
    node.connect_ring()
    resident, streamed = ring_split(plan, 1, RING["resident"])
    params, host = ring_params(cfg, dev, resident, streamed)
    worker = TcpRingWorker(RingContext(node, plan, 1, 2), cfg, params,
                           max_seq=RING["max_seq"], opts=ForwardOptions(attn_impl="kernel"),
                           n_slots=RING["n_slots"], n_groups=RING["n_groups"],
                           streamed_host=host, device=dev)
    apply_kv_op, warmup = worker.w.apply_kv_op, {}

    def apply_or_mark(msg: dict) -> None:
        """Rank 0's mark after its warm-up request: the measured run starts
        here, so the counts go to 0 (the warm-up's launches are kept apart)."""
        if msg["op"] != RING_MARK:
            return apply_kv_op(msg)
        warmup.update({k: c.count for k, c in kernel_counts().items()},
                      streamed_bytes=worker.w.streamer.uploads.bytes)
        for c in kernel_counts().values():
            c.count = 0

    worker.w.apply_kv_op = apply_or_mark
    t0 = time.time()
    worker.serve(timeout=RING_DEADLINE)
    node.close()
    if not warmup:
        raise AssertionError("rank 1 never got rank 0's mark of the measured run")
    torch.cuda.synchronize(dev)
    win = [sum(layer_nbytes(host[i]) for i in ids) for ids in worker.w.streamer.win_ids]
    kv = sum(a.numel() * a.element_size() for kvc in worker.w.kvc for p in kvc.caches
             if p is not None for a in p)
    out = {"peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "resident_gib": sum(layer_nbytes(params["layers"][i]) for i in resident) / 2 ** 30,
           "window_gib": [w / 2 ** 30 for w in win], "window_bytes": win,
           "kv_gib": kv / 2 ** 30,
           "streamed_bytes": worker.w.streamer.uploads.bytes, "serve_s": time.time() - t0,
           "launches": {k: c.count for k, c in kernel_counts().items()},
           "warmup": warmup,
           "layers": sorted(plan.owned(1)), "streamed_layers": sorted(streamed)}
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def ring_serve(eng, prompts: list, n_predict: int, dev) -> dict:
    """A warm-up request, then `prompts` through submit + step (the loop
    the server's worker runs for this engine), with the kernels' counts set
    to 0 just before and read just after; on a ring of processes a mark
    sent round after the warm-up sets the other ranks' counts to 0 too.
    Captures the logits of the first prefill chunk (the head over its
    hidden states) and of the first decode step, by group."""
    import torch

    from prima_tpu_torch.quant.qtensor import dequant_slices
    from prima_tpu_torch.runtime.streaming import STREAM_DEQUANT_WEIGHTS

    eng.run_to_completion(prompts[0][:16], n_predict=2, reuse_prefix=False)
    if eng.ctx.world > 1:
        eng.core._bcast_kv({"op": RING_MARK})
    cap: dict = {}
    ring_pass, head = eng.core.ring_pass, eng.core.head

    def capture_pass(groups):
        hidden = ring_pass(groups)
        if "prefill" not in cap and groups[0][1].shape[1] > 1:
            # the head over every row of the chunk is the check's, not the
            # path's: slices keep its dequant of the output matrix out of
            # the ranks' peak memory, with the same bits
            with dequant_slices(STREAM_DEQUANT_WEIGHTS):
                cap["prefill"] = [head(hidden[g]).float().cpu() for g in sorted(hidden)]
        return hidden

    def capture_head(h):
        out = head(h)
        if len(cap.setdefault("decode", [])) < eng.G:
            cap["decode"].append(out.float().cpu())
        return out

    eng.core.ring_pass, eng.core.head = capture_pass, capture_head
    eng.perf = {k: 0 * v for k, v in eng.perf.items()}
    calls0 = eng.n_decode_calls
    torch.cuda.synchronize(dev)
    for c in kernel_counts().values():
        c.count = 0
    slots = [eng.submit(p, n_predict=n_predict, reuse_prefix=False) for p in prompts]
    t0, steps = time.time(), []
    while any(s.state.name != "IDLE" for s in slots):
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize(dev)
        steps.append(time.perf_counter() - t)
    wall = time.time() - t0
    launches = {k: c.count for k, c in kernel_counts().items()}
    eng.core.ring_pass, eng.core.head = ring_pass, head
    p = eng.perf
    return {"streams": [list(s.generated) for s in slots], "cap": cap,
            "prefill_tok_s": p["n_prompt"] / p["t_prompt_s"],
            "decode_tok_s": p["n_decode"] / p["t_decode_s"], "wall_s": wall,
            "decode_step_ms": statistics.median(steps[1:]) * 1e3,
            "first_step_ms": steps[0] * 1e3, "passes": eng.n_decode_calls - calls0,
            "passes_total": eng.n_decode_calls,
            "launches": launches}


def ring_engine(cfg, params, dev, world: int = 1, node=None, plan=None, streamed=None):
    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.parallel.ring_host import RingPlan
    from prima_tpu_torch.parallel.ring_tcp import RingContext, TcpRingEngine

    plan = plan or RingPlan([cfg.n_layers // RING["k"]], RING["k"])
    return TcpRingEngine(RingContext(node, plan, 0, world), cfg, params,
                         n_slots=RING["n_slots"], n_groups=RING["n_groups"],
                         max_seq=RING["max_seq"], n_batch=RING["n_batch"],
                         opts=ForwardOptions(attn_impl="kernel"), streamed_host=streamed,
                         device=dev, recv_timeout=RING_DEADLINE)


def bits_equal(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))


def ring_hops(dev) -> dict:
    """One ring hop in the wire's format (a JSON header, then the
    activation as bf16): one-way ms from 2-way round trips over loopback
    between two RingNodes, with Nagle's algorithm on (the JAX package's
    sockets) and with TCP_NODELAY; and the device-to-host copy each hop
    makes first. Shapes: a decode group (2 rows), 4 decode rows (32 KB on
    the wire), a prefill group (2 x 127 rows)."""
    import threading

    import numpy as np
    import torch

    from prima_tpu_torch.parallel.bootstrap import RingConfig, RingNode
    from prima_tpu_torch.parallel.ring_tcp import recv_act, send_act, to_host

    out = {}
    for nodelay in (False, True):
        port = _free_port()
        nodes = [RingNode(RingConfig(rank=r, world=2, data_port=port)) for r in range(2)]
        th = [threading.Thread(target=n.connect_ring) for n in nodes]
        for t in th:
            t.start()
        for t in th:
            t.join(60)
        if nodelay:
            for n in nodes:
                n.send_sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        for name, shape, n in (("decode_group", (2, 1, 4096), 200),
                               ("decode_4rows", (4, 1, 4096), 200),
                               ("prefill_group", (2, 127, 4096), 20)):
            a = torch.randn(shape, device=dev).to(torch.bfloat16)
            host = to_host(a)

            def echo():
                for _ in range(n):
                    nodes[1].recv_prev(timeout=60)
                    x = recv_act(nodes[1].recv_sock)
                    nodes[1].send_next({"tag": "act", "cycle": 0, "group": 0})
                    send_act(nodes[1].send_sock, x)

            t = threading.Thread(target=echo)
            t.start()
            t0 = time.perf_counter()
            for _ in range(n):
                nodes[0].send_next({"tag": "act", "cycle": 0, "group": 0})
                send_act(nodes[0].send_sock, host)
                nodes[0].recv_prev(timeout=60)
                recv_act(nodes[0].recv_sock)
            hop = (time.perf_counter() - t0) / n / 2
            t.join(60)
            d2h = []
            for _ in range(20):
                torch.cuda.synchronize(dev)
                t1 = time.perf_counter()
                to_host(a)
                d2h.append(time.perf_counter() - t1)
            key = f"{name}{'_nodelay' if nodelay else ''}"
            out[key] = {"shape": list(shape), "wire_bytes": int(np.prod(shape)) * 2,
                        "hop_ms": hop * 1e3, "d2h_ms": statistics.median(d2h) * 1e3}
            log(f"ring hop {key}: {json.dumps(out[key])}")
        for n_ in nodes:
            n_.close()
    return out


def ring_profile(dev) -> dict:
    """profile_device() on the card, and the solver on two copies of the
    profile plus one with a tenth of its read rate and its flops: w, n, k,
    the removed devices; every layer owned exactly once over the k
    cycles."""
    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.config import tiny_config
    from prima_tpu_torch.parallel.ring_host import RingPlan
    from prima_tpu_torch.profiler.device import _bench_h2d, print_device_props, profile_device
    from prima_tpu_torch.profiler.model_cost import model_cost_from_config
    from prima_tpu_torch.sched import assign_layers_and_select_devices

    t0 = time.time()
    p = profile_device(dev, full=True, bench_disk=True)
    log("profile_device():\n" + print_device_props(p))
    weak = dataclasses.replace(p, hbm_bw=p.hbm_bw / 10, flops_bf16=p.flops_bf16 / 10,
                               flops_f32=p.flops_f32 / 10,
                               flops_q4k_dequant=p.flops_q4k_dequant / 10)
    cfg = tiny_config(**LLAMA3_8B)
    cost = model_cost_from_config(cfg, GGMLType.Q4_K)
    res = assign_layers_and_select_devices([p, p, weak], cost, n_ctx=4096)
    removed = [i for i, w in enumerate(res.w) if w == 0]
    owned = sorted(i for d in range(3) for i in RingPlan(res.w, res.k).owned(d))
    log(f"solver on [profile, profile, profile / 10]: w {res.w} n {res.n} k {res.k} "
        f"removed {removed} classes {res.device_class}")
    if owned != list(range(cfg.n_layers)):
        raise AssertionError(f"the solver's windows own layers {owned}")
    return {"profile": p.to_dict(), "h2d_pageable_bw": _bench_h2d(dev, 64, pin=False),
            "tf32": False, "solver": {"w": res.w, "n": res.n, "k": res.k,
                                      "removed": removed, "classes": res.device_class,
                                      "objective_s": res.objective},
            "wall_s": time.time() - t0}


def ring_full(dev, r: dict) -> None:
    """The 8B shape over the world-2 ring (rank 1 a process of its own),
    then the same requests through the one-process ring over the same
    groups (every layer resident), the Engine at 4 slots, and the
    one-process ring at -ngl 8 (pinned, then pageable host layers)."""
    import numpy as np
    import torch

    from prima_tpu_torch.models.config import tiny_config
    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.parallel.bootstrap import RingConfig, RingNode
    from prima_tpu_torch.parallel.ring_host import RingPlan
    from prima_tpu_torch.runtime.engine import Engine
    from prima_tpu_torch.runtime.streaming import layer_nbytes, pack_host_layer

    cfg = tiny_config(**LLAMA3_8B)
    plan = RingPlan(RING["windows"], RING["k"])
    rng = np.random.default_rng(RING["seed"])
    prompts = [rng.integers(0, cfg.n_vocab, RING["prompt"]).tolist() for _ in range(4)]
    port = _free_port()
    out_path = os.path.join(ROOT, "build", "chip_smoke", "ring_rank1.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    if os.path.exists(out_path):
        os.remove(out_path)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ring-rank", "1",
                             "--ring-port", str(port), "--ring-out", out_path], cwd=ROOT)
    try:
        node = RingNode(RingConfig(rank=0, world=2, data_port=port))
        node.listener.settimeout(RING_DEADLINE)
        node.connect_ring()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        params, _ = ring_params(cfg, dev, plan.owned(0), head=True)
        eng = ring_engine(cfg, params, dev, 2, node, plan)
        try:
            ring2 = ring_serve(eng, prompts, RING["gen"], dev)
        finally:
            eng.stop()
            node.close()
        peak0 = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        proc.wait(timeout=RING_DEADLINE)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"ring rank 1 exited with {proc.returncode}")
    with open(out_path) as f:
        rank1 = json.load(f)
    bound = (rank1["resident_gib"] + 2 * max(rank1["window_gib"]) + rank1["kv_gib"] + 0.5)
    log(f"ring world 2: {ring2['decode_tok_s']:.1f} decode tok/s, "
        f"{ring2['prefill_tok_s']:.1f} prefill tok/s, decode step "
        f"{ring2['decode_step_ms']:.1f} ms; rank 0 peak {peak0:.2f} GiB; rank 1 "
        f"{json.dumps(rank1)}")
    if rank1["peak_gib"] > bound:
        raise AssertionError(f"rank 1 peak {rank1['peak_gib']:.2f} GiB over its bound "
                             f"{bound:.2f}")
    if rank1["streamed_bytes"] - rank1["warmup"]["streamed_bytes"] \
            < ring2["passes"] * sum(rank1["window_bytes"]):
        raise AssertionError("rank 1 did not stream both windows every pass")
    if not all(ring2["launches"].values()) or not all(rank1["launches"].values()):
        raise AssertionError(f"a kernel did not run on the ring: rank 0 "
                             f"{ring2['launches']}, rank 1 {rank1['launches']}")

    # the one-process ring over the same groups, every layer resident
    for i in sorted(plan.owned(1)):
        params["layers"][i] = ring_layer(cfg, i, dev)
    one = ring_serve(ring_engine(cfg, params, dev), prompts, RING["gen"], dev)
    same = {k: bits_equal(ring2["cap"][k], one["cap"][k]) for k in ("prefill", "decode")}
    log(f"ring world 2 vs one process, same groups: logits bits equal {same}, streams "
        f"equal {ring2['streams'] == one['streams']}; one process "
        f"{one['decode_tok_s']:.1f} decode tok/s, {one['prefill_tok_s']:.1f} prefill tok/s")
    if not all(same.values()) or ring2["streams"] != one["streams"]:
        raise AssertionError("the world-2 ring differs from one process over the same groups")

    # the Engine at 4 slots: the same streams, logits within the bf16 tolerance
    e = Engine(cfg, params, n_slots=RING["n_slots"], max_seq=RING["max_seq"],
               n_batch=RING["n_batch"], opts=ForwardOptions(attn_impl="kernel"), device=dev)
    e.run_to_completion(prompts[0][:16], n_predict=2, reuse_prefix=False)
    first: list = []
    decode_raw = e._decode_raw

    def capture(*a):
        out = decode_raw(*a)
        if not first:
            first.append(out[0].float().cpu())
        return out

    e._decode_raw = capture
    slots = [e.submit(p, n_predict=RING["gen"], reuse_prefix=False) for p in prompts]
    while any(s.state.name != "IDLE" for s in slots):
        e.step()
    e_streams = [list(s.generated) for s in slots]
    ring_rows = torch.cat([g[:, -1] for g in ring2["cap"]["decode"]])
    err = (ring_rows - first[0]).abs().max().item()
    scale = first[0].abs().max().item()
    log(f"ring vs Engine(4 slots): streams equal {e_streams == ring2['streams']}, first "
        f"decode logits max |err| {err:.3e} of max |logit| {scale:.3e}")
    if e_streams != ring2["streams"] or err > RING_TOL * scale:
        raise AssertionError("the ring's streams or logits differ from the Engine's")
    del e, slots
    gc.collect()

    # -ngl 8 on one process: the first 24 layers stream from pinned memory
    ngl = RING["ngl"]
    L = cfg.n_layers
    host = {i: pack_host_layer(params["layers"][i], pin=True) for i in range(L - ngl)}
    for i in range(L - ngl):
        params["layers"][i] = None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ring_engine(cfg, params, dev, plan=RingPlan([L], 1), streamed=host)
    up = eng.core.streamer.uploads
    b0 = up.bytes
    streamed = ring_serve(eng, prompts, RING["gen"], dev)
    step_bytes = sum(layer_nbytes(h) for h in host.values())
    same = {k: bits_equal(streamed["cap"][k], one["cap"][k]) for k in ("prefill", "decode")}
    ngl_r = {k: streamed[k] for k in ("prefill_tok_s", "decode_tok_s", "decode_step_ms",
                                      "passes", "launches")}
    ngl_r.update(bits_equal=same, streams_equal=streamed["streams"] == one["streams"],
                 bytes_per_step=step_bytes, bytes_streamed=up.bytes - b0,
                 peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    if not all(same.values()) or streamed["streams"] != one["streams"] \
            or ngl_r["bytes_streamed"] < step_bytes * streamed["passes"]:
        raise AssertionError(f"-ngl {ngl} differs from every layer resident: {ngl_r}")
    # pinned against pageable: the 24 layers' upload alone, and decode steps
    # of one request, each streaming them
    pageable = {i: pack_host_layer(h, pin=False) for i, h in host.items()}
    for name, src in (("pinned", host), ("pageable", pageable)):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        layers = [up.ready(up.start(h)) for h in src.values()]
        torch.cuda.synchronize(dev)
        ngl_r[f"{name}_upload_gbs"] = step_bytes / (time.perf_counter() - t) / 1e9
        del layers
        eng.core.streamer.host = src
        s = eng.submit(prompts[1][:32], n_predict=5, reuse_prefix=False)
        times = []
        while s.state.name != "IDLE":
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t)
        ngl_r[f"{name}_step_ms"] = statistics.median(times[1:]) * 1e3
    log(f"-ngl {ngl} (world 1): {json.dumps(ngl_r)}")
    r["launches"] = {"rank0": ring2["launches"], "rank1": rank1["launches"]}
    r["full"] = {"world2": {k: v for k, v in ring2.items() if k not in ("cap", "streams")},
                 "rank0_peak_gib": peak0, "rank1": rank1, "rank1_bound_gib": bound,
                 "one_process": {k: v for k, v in one.items() if k not in ("cap", "streams")},
                 "engine_logits_err": err, "engine_logits_max": scale,
                 "rank1_bytes_per_step": sum(rank1["window_bytes"]),
                 "rank1_bytes_per_pass_measured": (rank1["streamed_bytes"]
                                                   - rank1["warmup"]["streamed_bytes"])
                 / ring2["passes"],
                 "ngl": ngl_r}
    del eng, params, host, pageable
    gc.collect()
    torch.cuda.empty_cache()


def _ring_ranks(module: str, args: list, world: int = 2, log: str | None = None) -> list:
    """Start `python -m module args --rank r --data-port P` for every rank.
    Without `log`, return (returncode, stdout, stderr) of each within the
    deadline (a fresh base port when one of them found its port taken);
    with it, return the processes at once, their standard error going to
    build/chip_smoke/{log}_rank{r}.log."""
    for _ in range(3):
        port = _free_port()
        if log:
            os.makedirs(os.path.join(ROOT, "build", "chip_smoke"), exist_ok=True)
            procs = []
            for r in range(world):
                with open(os.path.join(ROOT, "build", "chip_smoke",
                                       f"{log}_rank{r}.log"), "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", module, *args, "--data-port", str(port),
                         "--rank", str(r)], cwd=ROOT, stdout=subprocess.DEVNULL, stderr=f))
            return procs
        procs = [subprocess.Popen([sys.executable, "-m", module, *args, "--data-port",
                                   str(port), "--rank", str(r)], cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(world)]
        res = []
        try:
            for p in procs:
                o, e = p.communicate(timeout=RING_DEADLINE)
                res.append((p.returncode, o, e))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if not any(rc and "Address already in use" in e for rc, _, e in res):
            return res
    return res


def _cli_text(args: list) -> str:
    """The port's CLI in this process (on the card), its standard output."""
    import contextlib
    import io

    from prima_tpu_torch.tools.cli import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(args)
    if rc != 0:
        raise AssertionError(f"cli {args} exited {rc}")
    return buf.getvalue()


def _ring_server_texts(flags: list, bodies: list, log: str) -> list:
    """The tiny pair's server at -w 2 (-lw 2,2) with `flags`: the texts of
    `bodies`, requested at once; both ranks stopped after."""
    for _ in range(3):
        http_port = _free_port()
        procs = _ring_ranks("prima_tpu_torch.server", [
            "-m", TINY, "--port", str(http_port), "-w", "2", "-lw", "2,2", "-c", "256", "-b",
            "64", *flags], log=log)
        out = []
        try:
            t0 = time.time()
            while time.time() - t0 < RING_DEADLINE and procs[0].poll() is None:
                try:
                    if _get(http_port, "/health").get("status") == "ok":
                        break
                except OSError:
                    time.sleep(0.5)
            if procs[0].poll() is None:
                out = _texts(http_port, bodies, concurrent=True)
        finally:
            procs[0].terminate()  # SIGTERM: rank 0 sends STOP round the ring
            res = []
            for r, p in enumerate(procs):
                try:
                    rc = p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    rc = p.wait()
                with open(os.path.join(ROOT, "build", "chip_smoke",
                                       f"{log}_rank{r}.log")) as f:
                    res.append((rc, f.read()))
        if out:
            return out
        if not any("Address already in use" in e for _, e in res):
            break
    raise AssertionError("ring server: " + " | ".join(e[-1500:] for _, e in res))


def _inprocess_server_texts(engine_fn, bodies: list) -> list:
    """The texts of `bodies` from the server app over engine_fn(model) in
    this process on the card."""
    import threading

    from prima_tpu_torch.models.loader import load_model
    from prima_tpu_torch.server.app import serve

    m = load_model(TINY, device="cuda")
    httpd, ctx = serve(m, engine_fn(m), "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        return _texts(httpd.server_address[1], bodies, concurrent=True)
    finally:
        httpd.shutdown()
        ctx.worker.shutdown()
        httpd.server_close()


def ring_entry_points(r: dict) -> None:
    """The normal entry points on the tiny trained pair, each against the
    same command at -w 1 on the card: the CLI at -w 2 with -lw 3,1 -k 1,
    the CLI at -w 2 with no -lw (each rank profiles its device, rank 0
    solves), -ngl 1 on one process; the server at -w 2 (4 concurrent
    requests, and with -md one more), in f32."""
    import torch

    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.parallel.ring_host import RingPlan
    from prima_tpu_torch.parallel.ring_tcp import RingContext, TcpRingEngine
    from prima_tpu_torch.runtime.engine import Engine

    t0 = time.time()
    cli = ["-m", TINY, "-p", "Once upon a time", "-n", "24", "--temp", "0",
           "--no-display-prompt", "-c", "256"]
    # the ring commands run as processes while this one runs the -w 1 side
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        rings = {key: pool.submit(_ring_ranks, "prima_tpu_torch.tools.cli",
                                  cli + ["-w", "2"] + extra)
                 for key, extra in (("lw3,1", ["-lw", "3,1", "-k", "1"]), ("auto", []))}
        want = _cli_text(cli)
        got = {"ngl1": _cli_text(cli + ["-ngl", "1"])}
        for key, fut in rings.items():
            res = fut.result()
            for rc, _, e in res:
                if rc != 0:
                    raise AssertionError(f"cli -w 2 ({key}): {e[-2000:]}")
            got[key] = res[0][1]
            if key == "auto":
                got["auto_schedule"] = [ln for ln in res[0][2].splitlines()
                                        if ln.startswith("rank ")]
        log(f"cli on the tiny pair, -w 1: {want!r}; {json.dumps(got)}")
        if any(got[k] != want for k in ("ngl1", "lw3,1", "auto")):
            raise AssertionError("a ring CLI's text differs from -w 1's")

        f32 = ForwardOptions(dtype=torch.float32)
        bodies = [{"prompt": p, "n_predict": 32, "temperature": 0} for p in PROMPTS]
        engine = lambda m: Engine(m.cfg, m.params, n_slots=4, max_seq=256, n_batch=64,
                                  opts=f32, kv_dtype=torch.float32, eog_ids=m.eog_ids,
                                  device="cuda")
        servers = [pool.submit(_ring_server_texts, F32_SERVER, bodies, "plain"),
                   pool.submit(_ring_server_texts, F32_SERVER + ["-md", DRAFT], bodies[1:2], "md")]
        one = _inprocess_server_texts(engine, bodies)
        ring, md = (f.result() for f in servers)
        srv = {"w1": one, "w2": ring, "w2_md": md, "equal": ring == one and md == one[1:2]}
        if not srv["equal"]:
            # which made it: the one-process ring over the same groups has the
            # ring's K split and no wire
            same_groups = lambda m: TcpRingEngine(
                RingContext(None, RingPlan([2], 2), 0, 1), m.cfg, m.params, n_slots=4,
                n_groups=2, max_seq=256, n_batch=64, opts=f32, kv_dtype=torch.float32,
                eog_ids=m.eog_ids, device="cuda")
            srv["w1_ring_same_groups"] = _inprocess_server_texts(same_groups, bodies)
            srv["cause"] = ("K split" if srv["w1_ring_same_groups"] == ring else "wire")
            log(f"ring server text differs from -w 1: {json.dumps(srv)}")
            if srv["cause"] == "wire":
                # bf16, where the wire is lossless: the same groups must match exactly
                bf16 = lambda m: TcpRingEngine(
                    RingContext(None, RingPlan([2], 2), 0, 1), m.cfg, m.params, n_slots=4,
                    n_groups=2, max_seq=256, n_batch=64, eog_ids=m.eog_ids, device="cuda")
                srv["bf16_w1_ring"] = _inprocess_server_texts(bf16, bodies)
                srv["bf16_w2"] = _ring_server_texts([], bodies, "bf16")
                if srv["bf16_w2"] != srv["bf16_w1_ring"]:
                    raise AssertionError(f"bf16 ring server differs from one process: {srv}")
        log(f"ring server on the tiny pair: {json.dumps(srv)}")
    r["entry_points"] = {"cli_w1": want, "cli": got, "server": srv,
                         "wall_s": time.time() - t0}


def phase_ring(dev, report: dict) -> None:
    """The profiler and the solver on the card, the 8B shape over the TCP
    ring, the ring's entry points on the tiny pair, the hop's cost."""
    r: dict = {}
    t0 = time.time()
    r["profiler"] = ring_profile(dev)
    log(f"ring profiler + solver: {time.time() - t0:.1f} s")
    t0 = time.time()
    ring_full(dev, r)
    log(f"ring full width: {time.time() - t0:.1f} s")
    r["hops"] = ring_hops(dev)
    t0 = time.time()
    ring_entry_points(r)
    log(f"ring entry points: {time.time() - t0:.1f} s")
    report["ring"] = r


# ---------------------------------------------------------------------------
# phase 9: the masked forward, lookup and lookahead decoding, and the tools
# ---------------------------------------------------------------------------

TOOLS_PROMPT = 128  # a 128-token prompt: a 16-token pattern, 8 times
PPL_TOL = {"f32": 1e-3, "bf16": 1e-2}  # relative, kernels vs plain


def tool_call(main, args: list) -> tuple[int, str, str]:
    """A tool's main(args) in this process: (exit code, stdout, stderr)."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(args)
    return rc, out.getvalue(), err.getvalue()


def zero_counts() -> dict:
    """Every kernel counter of the model's paths, each set to 0."""
    from prima_tpu_torch.ops import kv_write as kvw
    from prima_tpu_torch.quant import qmatmul as qm

    counters = dict(kernel_counts(), kv_write=kvw.launches, qgemv_indexed=qm.indexed_launches)
    for c in counters.values():
        c.count = 0
    return counters


def read_counts(counters: dict) -> dict:
    return {k: c.count for k, c in counters.items() if c.count}


def tools_bench() -> dict:
    """bench_tool --synth 8b -p 512 -n 128 -b 1,4 -r 1 -o json through its
    main, the launch counts of that run (one repetition: the script's time
    limit)."""
    import torch

    from prima_tpu_torch.tools import bench_tool

    counters = zero_counts()
    t0 = time.time()
    rc, out, err = tool_call(bench_tool.main, ["--synth", "8b", "-p", "512", "-n", "128",
                                               "-b", "1,4", "-r", "1", "-o", "json"])
    wall = time.time() - t0
    launches = read_counts(counters)
    gc.collect()
    torch.cuda.empty_cache()
    if rc != 0:
        raise AssertionError(f"bench_tool exited {rc}: {err[-2000:]}")
    rows = json.loads(out)
    got = {(r["test"], r["n_batch"]): r for r in rows}
    if sorted(got) != [("pp512", 1), ("pp512", 4), ("tg128", 1), ("tg128", 4)]:
        raise AssertionError(f"bench_tool rows {sorted(got)}")
    for r in rows:
        if not (r["avg_ts"] > 0 and r["backend"] == torch.cuda.get_device_name(0)):
            raise AssertionError(f"bench_tool row {r}")
    if not (launches.get("qgemv") and launches.get("kv_store")):
        raise AssertionError(f"bench_tool ran without qgemv or kv_store: {launches}")
    res = {"rows": [{k: r[k] for k in ("test", "n_batch", "avg_ts", "stddev_ts", "max_ts",
                                       "size_gib", "backend")} for r in rows],
           "wall_s": wall, "launches": launches}
    for r in res["rows"]:
        log(f"bench_tool {r['test']} b={r['n_batch']}: {r['avg_ts']:.2f} "
            f"± {r['stddev_ts']:.2f} tok/s")
    log(f"bench_tool: {wall:.1f} s, launches {launches}")
    return res


def tools_engine(cfg, params, dev, dtype):
    """The decoders' engine: one slot, max_seq 1024, activations and KV in
    `dtype` (a torch dtype, or "q8_0" for a q8_0 cache under bf16)."""
    import torch

    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.runtime.engine import Engine

    act = torch.bfloat16 if isinstance(dtype, str) else dtype
    return Engine(cfg, params, n_slots=1, max_seq=1024, device=dev, kv_dtype=dtype,
                  opts=ForwardOptions(dtype=act))


def plain_greedy(cfg, params, dev, prompt: list, n: int) -> tuple[list, list]:
    """Plain greedy in f32 and each step's logits (host numpy)."""
    import torch

    eng = tools_engine(cfg, params, dev, torch.float32)
    steps, real = [], eng._decode_raw

    def record(*a):
        logits, caches = real(*a)
        steps.append(logits[0].float().cpu().numpy())
        return logits, caches

    eng._decode_raw = record
    toks = eng.run_to_completion(prompt, n_predict=n)
    free(eng)
    return toks, steps


def profiled_wall(run) -> dict:
    """run() -> (tokens, ...) once timed on the host (ending in a
    synchronize), with every kernel count set to 0 just before and read
    just after, then again under torch.profiler: wall ms, the launches,
    device busy ms, and the idle share of the device over the unprofiled
    wall time. run() must do the same work both times (greedy decoding on
    a fresh engine)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    counters = zero_counts()
    t0 = time.perf_counter()
    first = run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = read_counts(counters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = run()
        torch.cuda.synchronize()
    by, top = device_ms(prof)
    busy = sum(by.values())
    return {"result": first, "same_tokens_profiled": first[0] == second[0], "wall_ms": wall,
            "launches": launches, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall, "device_ms": by, "top_kernels_ms": top}


def tools_lookup(cfg, params, dev, prompt: list, plain: tuple) -> dict:
    """LookupDecoder, 8 drafts a verify, 64 tokens: in f32 the plain greedy
    stream, each accepted position's verify logits within LOGITS_TOL *
    max |logit| of incremental decode; in bf16 the drafts, acceptance,
    tok/s, verify wall ms by chain length, device idle share."""
    import numpy as np
    import torch

    from prima_tpu_torch.runtime.ngram_cache import LookupDecoder

    want, steps = plain
    t = tools_engine(cfg, params, dev, torch.float32)
    chains, pos0s, verify = [], [], t.verify_chain

    def record(sid, chain):
        pos0s.append(t.kv.used(sid))
        chains.append(verify(sid, chain))
        return chains[-1]

    t.verify_chain = record
    got, stats = LookupDecoder(t, n_draft=8).generate(prompt, n_predict=64)
    free(t)
    accepted = [b - a for a, b in zip(pos0s, pos0s[1:])]
    accepted.append(len(got) - sum(accepted))
    n, worst = 0, 0.0
    for logits, k in zip(chains, accepted):
        for j in range(k):
            ref = steps[n + j]
            worst = max(worst, float(np.abs(logits[j] - ref).max() / np.abs(ref).max()))
        n += k
    out = {"f32": {"tokens": 64, "equal_plain": got == want, "stats": vars(stats),
                   "verify_logits_max_rel_err": worst,
                   "tolerance": f"max|verify - incremental| <= {LOGITS_TOL} * max|logit|"}}
    log("lookup (f32)", json.dumps(out["f32"]))
    if got != want:
        raise AssertionError(f"lookup greedy stream differs: {got} vs plain {want}")
    if not worst <= LOGITS_TOL:
        raise AssertionError(f"lookup verify logits {worst} of max |logit| from incremental")

    engines = []

    def run():
        t = tools_engine(cfg, params, dev, torch.bfloat16)
        engines.append(t)
        verify, walls = t.verify_chain, {}

        def timed(sid, chain):
            t0 = time.perf_counter()
            logits = verify(sid, chain)  # ends in a copy to the host
            walls.setdefault(len(chain), []).append((time.perf_counter() - t0) * 1e3)
            return logits

        t.verify_chain = timed
        toks, st = LookupDecoder(t, n_draft=8).generate(prompt, n_predict=64)
        free(t)
        return toks, vars(st), walls

    run()  # warm-up, not counted
    prof = profiled_wall(run)
    toks, st, walls = prof.pop("result")
    launches = prof["launches"]
    bf16 = dict(prof, tokens=len(toks), stats=st, tok_s=len(toks) / prof["wall_ms"] * 1e3,
                verify_wall_ms_by_chain={n: statistics.median(v) for n, v in sorted(walls.items())},
                verify_calls_by_chain={n: len(v) for n, v in sorted(walls.items())})
    out["bf16"] = bf16
    log("lookup (bf16)", json.dumps({k: v for k, v in bf16.items() if k != "top_kernels_ms"}))
    if not (launches.get("qgemv") and launches.get("kv_store")):
        raise AssertionError(f"lookup ran without qgemv or kv_store: {launches}")
    return out


def tools_lookahead(cfg, params, dev, prompt: list, plain: tuple) -> dict:
    """LookaheadDecoder at W = 15, N = 5, G = 15 (S = 120), 32 tokens: in
    f32 the plain greedy stream; in bf16 tokens a step, wall and device ms
    a step, idle share; over a q8_0 cache each commit leaves the
    destination rows' codes and scales equal to the source rows', and one
    more commit is checked directly on the last step's scratch rows."""
    import torch

    from prima_tpu_torch.runtime.kv import _parts
    from prima_tpu_torch.runtime.lookahead import LookaheadDecoder

    want = plain[0][:32]
    t = tools_engine(cfg, params, dev, torch.float32)
    la = LookaheadDecoder(t)
    got, stats = la.generate(prompt, n_predict=32)
    free(t)
    out = {"S": la.S, "f32": {"tokens": 32, "equal_plain": got == want, "stats": vars(stats)}}
    log("lookahead (f32)", json.dumps(out["f32"]))
    if la.S != 120 or got != want:
        raise AssertionError(f"lookahead S {la.S}, stream {got} vs plain {want}")

    def run():
        t = tools_engine(cfg, params, dev, torch.bfloat16)
        toks, st = LookaheadDecoder(t).generate(prompt, n_predict=32)
        free(t)
        return toks, vars(st)

    run()  # warm-up, not counted
    prof = profiled_wall(run)
    toks, st = prof.pop("result")
    launches = prof["launches"]
    steps = st["n_steps"]
    bf16 = dict(prof, tokens=len(toks), stats=st, tokens_per_step=st["n_predict"] / steps,
                step_wall_ms=prof["wall_ms"] / steps,
                step_device_ms=prof["device_busy_ms"] / steps)
    out["bf16"] = bf16
    log("lookahead (bf16)", json.dumps({k: v for k, v in bf16.items()
                                        if k != "top_kernels_ms"}))
    if not launches.get("kv_store"):
        raise AssertionError(f"lookahead ran without kv_store: {launches}")

    # q8_0: every commit a bit-for-bit copy of codes and scales
    t = tools_engine(cfg, params, dev, "q8_0")
    la = LookaheadDecoder(t)
    checked, real = [], la._commit

    def rows(lo: int) -> list:
        return [a[0, lo:lo + la.N - 1].clone() for k, v in t.kv.caches
                for a in _parts(k) + _parts(v)]

    def check(slot, src0, dst0):
        src = rows(src0)
        real(slot, src0, dst0)
        checked.append((src0, dst0, all(torch.equal(a, b) for a, b in zip(rows(dst0), src))))

    pos0s, step = [], la._step
    la._step = lambda tokens, pos0, slot: pos0s.append(pos0) or step(tokens, pos0, slot)
    la._commit = check
    toks_q8, st_q8 = la.generate(prompt, n_predict=32)
    # the last step's scratch rows are still in the cache: n-gram 3's rows
    # onto the tail, as a commit that accepted it would copy them
    check(0, pos0s[-1] + la.v0 + 3 * (la.N - 1), pos0s[-1] + 1)
    free(t)
    out["q8_0"] = {"stats": vars(st_q8), "commits_checked": len(checked),
                   "commits_in_run": len(checked) - 1,
                   "codes_and_scales_equal": all(c[2] for c in checked)}
    log("lookahead (q8_0 cache)", json.dumps(out["q8_0"]))
    if not all(c[2] for c in checked):
        raise AssertionError(f"a lookahead commit over q8_0 changed codes or scales: {checked}")
    return out


def tools_perplexity(cfg, params, dev) -> dict:
    """Two seeded chunks of n_ctx 512 through the port's chunk_logp, the
    second half of each scored as the tool does, --matmul kernel against
    --matmul plain, in f32 and in bf16; ms a chunk on the host clock."""
    import math

    import numpy as np
    import torch

    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.tools.perplexity import chunk_logp

    n_ctx = 512
    rng = np.random.default_rng(7)
    chunks = [torch.as_tensor(rng.integers(0, cfg.n_vocab, n_ctx), device=dev)
              for _ in range(2)]
    out: dict = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        res = {}
        for impl in ("kernel", "plain"):
            opts = ForwardOptions(matmul_impl=impl, dtype=dtype)
            chunk_logp(params, cfg, chunks[0], opts)  # warm-up
            counters = zero_counts()
            nll, ms = 0.0, []
            for c in chunks:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logp = chunk_logp(params, cfg, c, opts)
                nxt = logp[torch.arange(n_ctx - 1, device=dev), c[1:]]
                nll -= float(nxt[n_ctx // 2:].sum())
                ms.append((time.perf_counter() - t0) * 1e3)
            res[impl] = {"ppl": math.exp(nll / (2 * (n_ctx - 1 - n_ctx // 2))),
                         "ms_per_chunk": ms, "launches": read_counts(counters)}
        rel = abs(res["kernel"]["ppl"] - res["plain"]["ppl"]) / res["plain"]["ppl"]
        out[name] = dict(res, rel_diff=rel, tolerance=f"relative <= {PPL_TOL[name]}")
        log(f"perplexity 8B ({name}): kernel {res['kernel']['ppl']:.6f} plain "
            f"{res['plain']['ppl']:.6f} (rel {rel:.2e}), ms a chunk "
            f"{[round(x, 1) for x in res['kernel']['ms_per_chunk']]} / plain "
            f"{[round(x, 1) for x in res['plain']['ms_per_chunk']]}, launches "
            f"{res['kernel']['launches']}")
        if not (math.isfinite(res["kernel"]["ppl"]) and rel <= PPL_TOL[name]):
            raise AssertionError(f"perplexity {name}: kernels {res['kernel']['ppl']} vs plain "
                                 f"{res['plain']['ppl']}")
        if not res["kernel"]["launches"].get("kv_store"):
            raise AssertionError(f"perplexity ran without kv_store: {res['kernel']}")
    return out


def f32_defaults():
    """The tools' forwards in f32, for the card against the CPU: every
    ForwardOptions they build defaults to f32 activations, and every bf16
    cache they ask for is f32 (the tools have no dtype flags)."""
    import contextlib
    import functools

    import torch

    from prima_tpu_torch.models import llama
    from prima_tpu_torch.runtime import kv

    opts, init = llama.ForwardOptions, llama.init_kv_caches

    def init_f32(cfg, batch, max_seq, dtype=torch.bfloat16, *a, **kw):
        return init(cfg, batch, max_seq, torch.float32 if dtype == torch.bfloat16 else dtype,
                    *a, **kw)

    @contextlib.contextmanager
    def patched():
        llama.ForwardOptions = functools.partial(opts, dtype=torch.float32)
        llama.init_kv_caches = kv.init_kv_caches = init_f32
        try:
            yield
        finally:
            llama.ForwardOptions, llama.init_kv_caches, kv.init_kv_caches = opts, init, init

    return patched()


def tiny_tool_runs(device: str, work: str) -> dict:
    """The tools on the tiny pair on `device`: {name: (exit code, the
    deterministic stdout)}; files go under `work`."""
    import re

    from prima_tpu_torch.tools import (batched, batched_bench, gritlm, lookahead, lookup,
                                       parallel, passkey, perplexity, profile_tool,
                                       save_load_state, simple, speculative)

    d = ["--device", device]
    corpus = os.path.join(work, "corpus.txt")
    with open(corpus, "w") as f:
        f.write("Once upon a time there was a little fox. The fox ran to the river. "
                "Once upon a time there was a little bird. The bird flew to the river. " * 6)
    static = os.path.join(work, f"static.{device}")
    base = os.path.join(work, f"base.{device}.logits")
    runs = [
        ("simple", simple.main, ["-m", TINY, "-p", "Once upon a time", "-n", "24"]),
        ("batched", batched.main, ["-m", TINY, "-p", "The quick brown fox", "-np", "3",
                                   "-n", "16", "--temp", "0", "-c", "256"]),
        ("parallel", parallel.main, ["-m", TINY, "-np", "2", "-ns", "4", "-n", "16",
                                     "-c", "256"]),
        ("speculative", speculative.main, ["-m", TINY, "-md", DRAFT, "-p", "Once upon a time",
                                           "-n", "32", "-c", "256"]),
        ("save_load_state", save_load_state.main, ["-m", TINY, "-p", "Once upon a time",
                                                   "-n", "16", "--temp", "0"]),
        ("passkey", passkey.main, ["-m", TINY, "--junk", "2", "--pos", "1", "-s", "3",
                                   "-c", "1024", "-n", "8"]),
        ("lookup_create", lookup.main, ["create", "-m", TINY, "-f", corpus, "-o", static]),
        ("lookup_run", lookup.main, ["run", "-m", TINY, "-p", "Once upon a time there was",
                                     "-n", "32", "-lcs", static]),
        ("lookahead", lookahead.main, ["-m", TINY, "-p", "Once upon a time", "-n", "24",
                                       "--temp", "0"]),
        ("perplexity", perplexity.main, ["-m", TINY, "-f", corpus, "-c", "128",
                                         "--logits-file", base]),
        ("kl_divergence", perplexity.main, ["-m", TINY, "-f", corpus, "--kl-divergence",
                                            "--logits-file", base]),
        ("gritlm_generate", gritlm.main, ["-m", TINY, "--mode", "generate", "-p",
                                          "Once upon a time", "-n", "24"]),
        ("batched_bench", batched_bench.main, ["-m", TINY, "-npp", "32", "-ntg", "8",
                                               "-npl", "1,2", "-c", "128"]),
        ("profile_tool", profile_tool.main, ["-m", TINY, "--no-disk"]),
    ]
    out = {}
    for name, main, args in runs:
        rc, text, err = tool_call(main, args + d)
        if name in ("batched_bench", "profile_tool"):
            text = ""  # timings only: they have to run and exit 0
        elif name == "parallel":
            text = re.sub(r"\(\s*[0-9.]+s, ", "(", text)  # latencies
        out[name] = (rc, text)
        if rc not in ((0, 1) if name == "passkey" else (0,)):
            raise AssertionError(f"{name} on {device} exited {rc}: {err[-2000:]}")
    with open(static, "rb") as f:
        out["lookup_static_bytes"] = (0, f.read().hex())
    from prima_tpu_torch.models.loader import load_model
    from prima_tpu_torch.tools.gritlm import encode, gritlm_instruction

    m = load_model(TINY, device=device)
    out["gritlm_embeddings"] = encode(m, ["hello world", "goodbye moon"],
                                      gritlm_instruction("retrieve stuff"), "kernel", device)
    return out


# the tools whose stdout prints f32 results (ppl, KLD) past f32's
# resolution: a ppl of ~3663 to 4 decimals is 1e-8 relative, and the card
# sums in another order than the CPU (card 3663.2964, CPU 3663.2970)
PRINTED_F32 = ("perplexity", "kl_divergence")
F32_PRINT_TOL = 1e-5  # relative, and absolute for values under 1


def same_text_f32(a: str, b: str) -> bool:
    """Equal text, the decimal numbers in it within F32_PRINT_TOL."""
    import re

    num = re.compile(r"-?\d+\.\d+")
    if num.sub("#", a) != num.sub("#", b):
        return False
    return all(abs(float(x) - float(y)) <= F32_PRINT_TOL * max(1.0, abs(float(y)))
               for x, y in zip(num.findall(a), num.findall(b)))


def tools_tiny(report_tools: dict) -> None:
    """The tools on the tiny pair in f32, on the card against --device cpu:
    equal exit codes and deterministic stdout (text, tokens, the static
    lookup cache's bytes; ppl and KLD within F32_PRINT_TOL), gritlm
    embeddings at cosine >= 0.9999; the card's launch counts, among them
    kv_write's from save_load_state's slot restores."""
    import numpy as np

    work = os.path.join(ROOT, "build", "chip_smoke", "tools")
    os.makedirs(work, exist_ok=True)
    t0 = time.time()
    with f32_defaults():
        counters = zero_counts()
        card = tiny_tool_runs("cuda", work)
        launches = read_counts(counters)
        cpu = tiny_tool_runs("cpu", work)
    ec, ep = card.pop("gritlm_embeddings"), cpu.pop("gritlm_embeddings")
    cos = [float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) for a, b in zip(ec, ep)]
    diff = sorted(k for k in card if card[k] != cpu[k] and not (
        k in PRINTED_F32 and card[k][0] == cpu[k][0] and same_text_f32(card[k][1], cpu[k][1])))
    report_tools["tiny"] = {"tools": sorted(card), "differ": diff, "gritlm_cosine": cos,
                            "f32_printed": {k: (card[k][1], cpu[k][1]) for k in PRINTED_F32},
                            "launches": launches, "wall_s": time.time() - t0,
                            "stdout": {k: v[1][-400:] for k, v in card.items()
                                       if k != "lookup_static_bytes"}}
    for k in sorted(card):
        if k != "lookup_static_bytes":
            log(f"tool {k} on the card: rc {card[k][0]} {card[k][1].strip()[-160:]!r}")
    log(f"tiny tools card vs cpu: differ {diff}, gritlm cosine {cos}, launches {launches}")
    for k in diff:
        log(f"  {k}: card {card[k][1][-600:]!r}\n  {k}: cpu  {cpu[k][1][-600:]!r}")
    if diff or min(cos) < 0.9999:
        raise AssertionError(f"tools differ on the card from the CPU: {diff}, cosine {cos}")
    for name in ("qgemv", "kv_store", "kv_write"):
        if not launches.get(name):
            raise AssertionError(f"the tiny tools ran without {name}: {launches}")


def phase_tools(dev, report: dict) -> None:
    """bench_tool at the 8B shape; lookup and lookahead decoding and the
    perplexity chunk on the 8B-shape engine; the tools on the tiny pair,
    card against CPU."""
    import numpy as np
    import torch

    r: dict = {}
    t0 = time.time()
    r["bench"] = tools_bench()
    log(f"tools bench: {time.time() - t0:.1f} s")
    cfg, params = weights_8b(dev)
    pattern = np.random.default_rng(11).integers(0, cfg.n_vocab, 16).tolist()
    prompt = pattern * (TOOLS_PROMPT // 16)
    t0 = time.time()
    plain = plain_greedy(cfg, params, dev, prompt, 64)
    r["lookup"] = tools_lookup(cfg, params, dev, prompt, plain)
    log(f"tools lookup: {time.time() - t0:.1f} s")
    t0 = time.time()
    r["lookahead"] = tools_lookahead(cfg, params, dev, prompt, plain)
    log(f"tools lookahead: {time.time() - t0:.1f} s")
    t0 = time.time()
    r["perplexity"] = tools_perplexity(cfg, params, dev)
    log(f"tools perplexity: {time.time() - t0:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    tools_tiny(r)
    launches = Counter()
    for part in (r["bench"]["launches"], r["lookup"]["bf16"]["launches"],
                 r["lookahead"]["bf16"]["launches"], r["tiny"]["launches"],
                 r["perplexity"]["bf16"]["kernel"]["launches"]):
        launches.update(part)
    r["launches"] = dict(launches)
    for name, n in launches.items():
        report[name]["tools_launches"] = n
    report["tools"] = r


QUANT_CTX = 512  # imatrix's default -c: every chunk takes the dense weight path
QUANT_CHUNKS = 2
QUANT_SHORT = 16  # rows under qmatmul.MAX_B: the GEMV route
# imatrix and eval_callback taps in f32, kernels vs plain: max |err| of a
# key <= QUANT_REL * its largest value (sums of x^2 over 16-32 rows whose
# inputs differ by the GEMV's ~3e-6 of max |y|)
QUANT_REL = 1e-4
QUANT_COS = 0.9999  # a layer's control direction, kernels vs plain (f32)
GGUF_NAMES = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
              "w_gate": "ffn_gate", "w_up": "ffn_up", "w_down": "ffn_down"}


class SeededTokens:
    """The tokenizer of the synthetic 8B weights: encode() gives `n` token
    ids drawn from a generator seeded by the text."""

    def __init__(self, n_vocab: int, n: int):
        self.n_vocab, self.n = n_vocab, n

    def encode(self, text: str, add_special: bool = True, parse_special: bool = False) -> list:
        import zlib

        import numpy as np

        rng = np.random.default_rng(zlib.crc32(text.encode()))
        return rng.integers(0, self.n_vocab, self.n).tolist()


def weights_8b_centred(dev):
    """The Llama-3-8B shape with centred Q4_K weights generated on the card
    (zero_mean, as phase moe's): with the synth's default mean every hidden
    state shares one direction, which a difference of two prompts' hidden
    states cancels, and cvector_generator's directions are such differences
    of differences."""
    return weights_centred(dev, LLAMA3_8B, seed=10, name="8B-shape")


def weights_centred(dev, shape: dict, seed: int, name: str):
    """A llama of `shape` with centred Q4_K weights generated on the card."""
    import torch

    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.config import tiny_config
    from prima_tpu_torch.models.llama import synth_qtensor_device

    cfg = tiny_config(**shape)
    e, h, kvh, hd, f = cfg.n_embd, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_ff
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
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
            "w_gate": q(f, e), "w_up": q(f, e), "w_down": q(e, f)})
    torch.cuda.synchronize()
    log(f"{name} centred Q4_K weights generated on the card in {time.time() - t0:.1f} s")
    return cfg, params


def quant_model(cfg, params, n_tokens: int):
    """What the tools take from a loaded model: cfg, params, a tokenizer."""
    import types

    return types.SimpleNamespace(cfg=cfg, params=params,
                                 tokenizer=SeededTokens(cfg.n_vocab, n_tokens))


def max_rel(a: dict, b: dict) -> float:
    """The largest max |a[k] - b[k]| / max |b[k]| over the keys."""
    import numpy as np

    return max(float(np.abs(np.asarray(a[k], np.float64) - b[k]).max() / np.abs(b[k]).max())
               for k in b)


def quant_imatrix(dev, cfg, params) -> dict:
    """collect_imatrix over two chunks of 512 seeded tokens in bf16 (the
    tool's defaults): 7 entries a layer and output.weight, each finite,
    >= 0 and nonzero; one chunk's wall and device ms, idle share and host
    syncs; a tapped forward synchronizes no more than an untapped one;
    then at -c 16 in f32 (the GEMV route), kernels vs plain."""
    import io

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
    from prima_tpu_torch.tools.imatrix import chunk_taps, collect_imatrix

    model = quant_model(cfg, params, QUANT_CHUNKS * QUANT_CTX)
    counters = zero_counts()
    t0 = time.perf_counter()
    stats = collect_imatrix(model, "calibration", n_ctx=QUANT_CTX, max_chunks=QUANT_CHUNKS,
                            logfile=io.StringIO(), device=dev)
    wall = time.perf_counter() - t0  # the last chunk's sums came back to the host
    launches = read_counts(counters)
    want = {f"blk.{i}.{n}.weight" for i in range(cfg.n_layers) for n in GGUF_NAMES.values()}
    want.add("output.weight")
    bad = sorted(k for k, (ssq, cnt, ncall) in stats.items()
                 if not (np.isfinite(ssq).all() and (ssq >= 0).all() and (ssq > 0).any()
                         and cnt == QUANT_CHUNKS * QUANT_CTX and ncall == QUANT_CHUNKS))
    stored = {k: ((ssq / cnt) * ncall).astype(np.float32, copy=False)
              for k, (ssq, cnt, ncall) in stats.items()}
    out = {"entries": len(stats), "entries_expected": len(want), "bad_entries": bad,
           "n_ctx": QUANT_CTX, "chunks": QUANT_CHUNKS, "wall_s": wall, "launches": launches}

    toks = torch.as_tensor(np.random.default_rng(12).integers(0, cfg.n_vocab, QUANT_CTX),
                           device=dev)
    opts = ForwardOptions()
    chunk_taps(model, toks, opts)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk_taps(model, toks, opts)  # ends in the copy of the sums to the host
    chunk_wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk_taps(model, toks, opts)
        torch.cuda.synchronize()
    by, top = device_ms(prof)
    busy = sum(by.values())
    syncs = count_syncs(lambda: chunk_taps(model, toks, opts))

    def fwd(taps):
        kv = init_kv_caches(cfg, 1, QUANT_CTX, torch.bfloat16, dev)
        with torch.no_grad():
            forward(params, cfg, toks[None], torch.arange(QUANT_CTX, device=dev,
                                                          dtype=torch.int32)[None],
                    kv, torch.zeros(1, dtype=torch.int32, device=dev), opts, taps=taps)

    tapped, untapped = count_syncs(lambda: fwd({})), count_syncs(lambda: fwd(None))
    # what the taps cost: the chunk's forward with and without them, in
    # turns, each ending in a synchronize; and each one's device time
    walls = {"tapped": [], "untapped": []}
    for _ in range(3):
        for name, taps in (("untapped", None), ("tapped", {})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd(taps)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    busy_fwd = {}
    for name, taps in (("untapped", None), ("tapped", {})):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fwd(taps)
            torch.cuda.synchronize()
        busy_fwd[name] = sum(device_ms(prof)[0].values())
    out["chunk"] = {"wall_ms": chunk_wall, "device_busy_ms": busy,
                    "device_idle_share": 1 - busy / chunk_wall, "device_ms": by,
                    "top_kernels_ms": top, "host_syncs": syncs,
                    "forward_syncs_tapped": tapped, "forward_syncs_untapped": untapped,
                    "forward_wall_ms": walls, "forward_device_ms": busy_fwd,
                    "taps_wall_share": statistics.median(walls["tapped"])
                    / statistics.median(walls["untapped"]) - 1,
                    "taps_device_share": busy_fwd["tapped"] / busy_fwd["untapped"] - 1}
    log("imatrix 8B (bf16)", json.dumps({k: v for k, v in out.items() if k != "chunk"}))
    log("imatrix 8B chunk", json.dumps({k: v for k, v in out["chunk"].items()
                                        if k != "top_kernels_ms"}))
    if len(stats) != len(want) or set(stats) != want or bad:
        raise AssertionError(f"imatrix: {len(stats)} entries of {len(want)}, bad {bad}")
    if tapped["count"] != untapped["count"]:
        raise AssertionError(f"a tapped forward synchronizes more: {tapped} vs {untapped}")

    # f32 at -c 16: the GEMV route, kernels vs plain
    short = {}
    with f32_defaults():
        for impl in ("kernel", "plain"):
            counters = zero_counts()
            st = collect_imatrix(quant_model(cfg, params, QUANT_CHUNKS * QUANT_SHORT),
                                 "calibration", n_ctx=QUANT_SHORT, matmul=impl,
                                 max_chunks=QUANT_CHUNKS, logfile=io.StringIO(), device=dev)
            short[impl] = ({k: v[0] for k, v in st.items()}, read_counts(counters))
    rel = max_rel(short["kernel"][0], short["plain"][0])
    out["f32_short"] = {"n_ctx": QUANT_SHORT, "max_rel_err": rel,
                        "tolerance": f"max|err| <= {QUANT_REL} * max|plain| a key",
                        "launches": short["kernel"][1], "plain_launches": short["plain"][1]}
    log("imatrix 8B (f32, -c 16) kernels vs plain", json.dumps(out["f32_short"]))
    if sorted(short["kernel"][0]) != sorted(short["plain"][0]) or not rel <= QUANT_REL:
        raise AssertionError(f"imatrix kernels vs plain: {rel}")
    if not short["kernel"][1].get("qgemv"):
        raise AssertionError(f"imatrix at -c 16 ran without qgemv: {short['kernel'][1]}")
    out["stored"] = stored
    return out


def tap_table(taps: dict) -> dict:
    """eval_callback's columns a key: rms, column min and max."""
    import numpy as np

    out = {}
    for name, (ssq, cnt) in taps.items():
        col = np.asarray(ssq, np.float64) / max(int(cnt), 1)
        out[name] = np.sqrt([col.mean(), col.min(), col.max()])
    return out


def quant_eval_callback(dev, cfg, params) -> dict:
    """eval_callback's forward (f32 activations, logits and cache) of a
    16-token prompt, kernels vs plain: each tap's rms / min / max within
    QUANT_REL, the top-5 ids equal."""
    import numpy as np

    from prima_tpu_torch.tools.eval_callback import run_taps

    model = quant_model(cfg, params, QUANT_SHORT)
    toks = model.tokenizer.encode("Hello world")
    res = {}
    for impl in ("kernel", "plain"):
        counters = zero_counts()
        last, taps = run_taps(model, toks, impl, dev)
        res[impl] = (last, tap_table(taps), read_counts(counters))
    (kl, kt, launches), (pl, pt, _) = res["kernel"], res["plain"]
    rel = max(float(np.abs(kt[k] - pt[k]).max() / np.abs(pt[k]).max()) for k in pt)
    top_k, top_p = np.argsort(-kl)[:5].tolist(), np.argsort(-pl)[:5].tolist()
    out = {"tokens": len(toks), "keys": len(kt), "max_rel_err": rel, "top5": top_k,
           "top5_plain": top_p, "logits_max_abs_err": float(np.abs(kl - pl).max()),
           "tolerance": f"rms/min/max within {QUANT_REL} relative, top-5 ids equal",
           "launches": launches}
    log("eval_callback 8B (f32) kernels vs plain", json.dumps(out))
    if sorted(kt) != sorted(pt) or len(kt) != 7 * cfg.n_layers + 1:
        raise AssertionError(f"eval_callback keys: {len(kt)} vs {len(pt)}")
    if not (rel <= QUANT_REL and top_k == top_p):
        raise AssertionError(f"eval_callback kernels vs plain: {rel}, {top_k} vs {top_p}")
    if not launches.get("qgemv"):
        raise AssertionError(f"eval_callback ran without qgemv: {launches}")
    return out


def quant_cvector(dev, cfg, params, work: str) -> dict:
    """cvector_generator's directions from two prompt pairs in f32, kernels
    vs plain, cosine >= QUANT_COS a layer; the kernels' file loaded as a
    control vector on the 8B engine, which decodes 8 tokens. Beside each
    layer's cosine: the hidden states' error, kernels vs plain, and how far
    the centred pair differences the direction comes from cancel."""
    import numpy as np

    from prima_tpu_torch.models.adapters import apply_control_vector, load_control_vector
    from prima_tpu_torch.runtime.engine import Engine
    from prima_tpu_torch.tools.cvector_generator import (cvector_directions, hidden_per_layer,
                                                         pca_directions, write_cvector)

    model = quant_model(cfg, params, 24)
    pos, neg = ["happy one", "happy two"], ["sad one", "sad two"]
    hidden, dirs, launches = {}, {}, {}
    with f32_defaults():
        for impl in ("kernel", "plain"):
            counters = zero_counts()
            dirs[impl] = cvector_directions(model, pos, neg, impl, dev)
            launches[impl] = read_counts(counters)
            hidden[impl] = np.stack([hidden_per_layer(model, p, impl, dev) for p in pos + neg])
    norm = lambda a: np.linalg.norm(a, axis=-1)
    h, hk = hidden["plain"].astype(np.float64), hidden["kernel"].astype(np.float64)
    diffs = h[:2] - h[2:]  # (pair, layer, n_embd)
    centred = diffs[0] - diffs[1]
    per_layer = [{"cosine": float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))),
                  "hidden_rel_err": float((norm(hk[:, li] - h[:, li]) / norm(h[:, li])).max()),
                  "hidden_over_centred": float(norm(h[:, li]).max() / norm(centred[li]))}
                 for li, (a, b) in enumerate(zip(dirs["kernel"], dirs["plain"]))]
    again = pca_directions((hidden["kernel"][:2] - hidden["kernel"][2:]).transpose(1, 0, 2))
    path = os.path.join(work, "cvector_8b.gguf")
    write_cvector(path, dirs["kernel"], cfg.arch)
    cvec = load_control_vector(path, strength=4.0, device=dev)
    eng = Engine(cfg, apply_control_vector(params, cvec), n_slots=1, max_seq=256, device=dev)
    counters = zero_counts()
    toks = eng.run_to_completion(SeededTokens(cfg.n_vocab, QUANT_SHORT).encode("steer"),
                                 n_predict=8)
    launches["engine"] = read_counts(counters)
    free(eng)
    cos = [r["cosine"] for r in per_layer]
    hidden_err = max(r["hidden_rel_err"] for r in per_layer)
    out = {"hidden_max_rel_err": hidden_err,
           "hidden_tolerance": f"|kernel - plain| <= {LOGITS_TOL} * |plain| a state","pairs": len(pos), "min_cosine": min(cos), "layers": len(cos),
           "tolerance": f"cosine >= {QUANT_COS} a layer", "directions_loaded": len(cvec),
           "directions_repeat": bool(np.array_equal(again, dirs["kernel"])),
           "steered_tokens": toks, "launches": launches["kernel"],
           "engine_launches": launches["engine"], "per_layer": per_layer}
    log("cvector_generator 8B (f32) kernels vs plain",
        json.dumps({k: v for k, v in out.items() if k != "per_layer"}))
    for li, r in enumerate(per_layer):
        log(f"  layer {li + 1}: cosine {r['cosine']:.7f}, hidden rel err "
            f"{r['hidden_rel_err']:.2e}, |h| / |centred diff| {r['hidden_over_centred']:.1f}")
    if not (len(cos) == cfg.n_layers and min(cos) >= QUANT_COS and hidden_err <= LOGITS_TOL):
        raise AssertionError(f"cvector directions kernels vs plain: cosine {cos}, hidden "
                             f"states {hidden_err}")
    if not out["directions_repeat"]:
        raise AssertionError("cvector_generator's directions differ from the same hidden states'")
    if len(cvec) != cfg.n_layers or len(toks) != 8:
        raise AssertionError(f"control vector: {len(cvec)} directions, {len(toks)} tokens")
    if not launches["kernel"].get("qgemv"):
        raise AssertionError(f"cvector_generator ran without qgemv: {launches['kernel']}")
    return out


def quant_roundtrip(dev, cfg, params, stored: dict, work: str) -> dict:
    """Layer 0 of the 8B weights dequantized to f32 on the host, quantized
    with the port's quantize_np to Q4_K (attn_k weighted by the imatrix,
    through an imatrix file), written with the port's GGUFWriter, loaded
    by the port's loader, and held through qgemv against qmatmul_plain at
    B = 1 and 4 (GEMV_TOL of max |y|); the host seconds a layer."""
    import numpy as np
    import torch

    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.gguf.reader import GGUFModel
    from prima_tpu_torch.gguf.writer import GGUFWriter
    from prima_tpu_torch.models.config import ModelConfig
    from prima_tpu_torch.models.llama import gguf_host_layer
    from prima_tpu_torch.quant import qmatmul as qm
    from prima_tpu_torch.quant.dequant_np import dequantize
    from prima_tpu_torch.quant.qtensor import dequant
    from prima_tpu_torch.quant.quantize_imatrix import (load_imatrix, quantize_weighted,
                                                        save_imatrix)
    from prima_tpu_torch.quant.quantize_np import quantize

    q4k = GGMLType.Q4_K
    layer = params["layers"][0]
    t0 = time.perf_counter()
    host = {k: dequant(layer[k], torch.float32).cpu().numpy() for k in GGUF_NAMES}
    t_dequant = time.perf_counter() - t0
    im_path = os.path.join(work, "8b.imatrix")
    save_imatrix(im_path, {k: (v, QUANT_CHUNKS) for k, v in stored.items()}, QUANT_CHUNKS,
                 dataset="seeded")
    qw = load_imatrix(im_path)["blk.0.attn_k.weight"]
    t0 = time.perf_counter()
    raw = {k: quantize(x, q4k) for k, x in host.items()}
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw_k = quantize_weighted(host["wk"], q4k, qw)
    t_weighted = time.perf_counter() - t0
    k_cols = host["wk"].shape[1]
    werr = {name: float(np.sum(qw * (dequantize(r, q4k, k_cols) - host["wk"]) ** 2))
            for name, r in (("weighted", raw_k), ("unweighted", raw["wk"]))}
    raw["wk"] = raw_k

    path = os.path.join(work, "layer0_q4k.gguf")
    w = GGUFWriter(path, arch="llama")
    for key, val in {"block_count": cfg.n_layers, "embedding_length": cfg.n_embd,
                     "attention.head_count": cfg.n_heads,
                     "attention.head_count_kv": cfg.n_kv_heads,
                     "feed_forward_length": cfg.n_ff, "context_length": cfg.n_ctx_train,
                     "attention.layer_norm_rms_epsilon": cfg.rms_eps,
                     "rope.freq_base": cfg.rope_base, "rope.dimension_count": cfg.rope_dim,
                     "vocab_size": cfg.n_vocab}.items():
        w.add_kv(f"llama.{key}", val)
    for norm in ("attn_norm", "ffn_norm"):
        w.add_tensor(f"blk.0.{norm}.weight", layer[norm].float().cpu().numpy())
    for k, r in raw.items():
        n, kk = host[k].shape
        w.add_tensor(f"blk.0.{GGUF_NAMES[k]}.weight", r, ne=(kk, n), ggml_type=q4k)
    t0 = time.perf_counter()
    w.write()
    m = GGUFModel.open(path)
    loaded = params_to(gguf_host_layer(m, ModelConfig.from_gguf(m), 0), dev)
    t_io = time.perf_counter() - t0
    m.close()
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    cases, worst = [], 0.0
    for k in GGUF_NAMES:
        qt = loaded[k]
        for b in (1, 4):
            x = torch.randn(b, qt.n_cols, generator=gen, device=dev)
            y, ref = qm.qgemv(x, qt), qm.qmatmul_plain(x, qt)
            err = (y - ref).abs().max().item() / ref.abs().max().item()
            worst = max(worst, err)
            cases.append({"tensor": GGUF_NAMES[k], "b": b, "rel_err": err})
        rt = dequant(qt, torch.float32).cpu().numpy()
        cases[-1]["roundtrip_rel_rmse"] = float(np.sqrt(np.mean((rt - host[k]) ** 2))
                                               / np.sqrt(np.mean(host[k] ** 2)))
    out = {"file_mib": os.path.getsize(path) / 2 ** 20, "host_s": {
        "dequant_to_host": t_dequant, "quantize_7_q4k": t_plain,
        "quantize_weighted_attn_k": t_weighted, "write_and_load": t_io,
        "layer": t_dequant + t_plain + t_weighted + t_io},
        "attn_k_weighted_error": werr, "qgemv_max_rel_err": worst,
        "tolerance": f"max|qgemv - plain| <= {GEMV_TOL} * max|plain|", "cases": cases}
    log("quantize round trip of layer 0 (8B)", json.dumps(out))
    if not worst <= GEMV_TOL:
        raise AssertionError(f"re-quantized layer: qgemv vs plain {worst}")
    if not werr["weighted"] <= werr["unweighted"] * 1.001:
        raise AssertionError(f"the imatrix-weighted attn_k errs more where it counts: {werr}")
    return out


def quant_tiny_runs(device: str, work: str) -> dict:
    """The quantize toolchain on the tiny pair: {name: (exit code, output)};
    quantize takes the card's imatrix in both runs, so that the host tools
    see the same inputs."""
    import hashlib
    import re

    from prima_tpu_torch.quant.quantize_imatrix import load_imatrix
    from prima_tpu_torch.tools import (export_lora, gbnf_validator, gguf_hash, gguf_split,
                                       imatrix, quantize, quantize_stats, simple, tokenize)

    d = ["--device", device]
    corpus = os.path.join(work, "calib.txt")
    with open(corpus, "w") as f:
        f.write("Once upon a time there was a little fox. The fox ran to the river. "
                "Once upon a time there was a little bird. The bird flew to the river. " * 6)
    grammar = os.path.join(work, "g.gbnf")
    with open(grammar, "w") as f:
        f.write('root ::= "{" ws "\\"a\\":" ws arr ws "}"\narr ::= "[" ws num (ws "," ws num)* '
                'ws "]"\nnum ::= [0-9]+\nws ::= [ ]*\n')
    inputs = {}
    for name, text in (("valid", '{"a": [1, 2]}'), ("invalid", '{"a": [1, 2}')):
        inputs[name] = os.path.join(work, f"{name}.txt")
        with open(inputs[name], "w") as f:
            f.write(text)
    lora = write_tiny_lora(os.path.join(work, "lora.gguf"))
    im = os.path.join(work, f"tiny.{device}.imatrix")
    q = os.path.join(work, f"q4km.{device}.gguf")
    split = os.path.join(work, f"split.{device}")
    digest = lambda p: hashlib.sha256(open(p, "rb").read()).hexdigest()
    out = {}

    def call(name, main, args, rc=0):
        got, text, err = tool_call(main, args)
        if got != rc:
            raise AssertionError(f"{name} on {device} exited {got}: {err[-2000:]}")
        out[name] = (got, text.replace(work, "W").replace(device, "DEV"))
        return text

    call("imatrix", imatrix.main, ["-m", TINY, "-f", corpus, "-o", im, "-c", "64"] + d)
    out["imatrix_values"] = (0, load_imatrix(im))
    call("quantize", quantize.main, [TINY, q, "Q4_K_M", "--imatrix",
                                     os.path.join(work, "tiny.cuda.imatrix")])
    out["quantize"] = (0, re.sub(r"in [0-9.]+s", "in #s", out["quantize"][1]))
    out["quantized_file"] = (0, digest(q))
    call("simple_q4km", simple.main, ["-m", q, "-p", "Once upon a time", "-n", "16"] + d)
    call("quantize_stats", quantize_stats.main, ["-m", TINY, "--type", "q4_K", "--type",
                                                 "q8_0", "--type", "iq4_nl", "-p"])
    merged = os.path.join(work, f"merged.{device}.gguf")
    call("export_lora", export_lora.main, ["-m", TINY, "--lora", lora, "-o", merged])
    out["merged_file"] = (0, digest(merged))
    shards = call("gguf_split", gguf_split.main, ["split", TINY, split,
                                                  "--split-max-tensors", "10"]).split()
    out["shards"] = (0, [digest(s) for s in shards])
    call("gguf_merge", gguf_split.main, ["merge", shards[0], split + ".merged.gguf"])
    out["merged_shards"] = (0, digest(split + ".merged.gguf"))
    call("gguf_hash", gguf_hash.main, [TINY, "--all"])
    call("tokenize", tokenize.main, ["-m", TINY, "-p", "Once upon a time, the fox ran.",
                                     "--show-count"])
    for name, rc in (("valid", 0), ("invalid", 1)):
        call(f"gbnf_{name}", gbnf_validator.main, [grammar, inputs[name]], rc)
    return out


QUANT_PRINTED_F32 = ("quantize_stats",)


def quant_tiny() -> dict:
    """The quantize toolchain on the tiny pair in f32, the card against
    --device cpu: imatrix values within F32_PRINT_TOL of each key's
    largest; every other output equal (text, file digests; quantize_stats'
    floats within F32_PRINT_TOL); a Q4_K_M quantization with the imatrix
    decodes 16 greedy tokens, the same on both."""
    work = os.path.join(ROOT, "build", "chip_smoke", "quant")
    os.makedirs(work, exist_ok=True)
    t0 = time.time()
    with f32_defaults():
        counters = zero_counts()
        card = quant_tiny_runs("cuda", work)
        launches = read_counts(counters)
        cpu = quant_tiny_runs("cpu", work)
    ic, ip = card.pop("imatrix_values")[1], cpu.pop("imatrix_values")[1]
    rel = max_rel(ic, ip) if sorted(ic) == sorted(ip) else float("inf")
    diff = sorted(k for k in card if card[k] != cpu[k] and not (
        k in QUANT_PRINTED_F32 and card[k][0] == cpu[k][0]
        and same_text_f32(card[k][1], cpu[k][1])))
    out = {"tools": sorted(card), "differ": diff, "imatrix_entries": len(ic),
           "imatrix_max_rel_err": rel, "launches": launches, "wall_s": time.time() - t0,
           "stdout": {k: str(v[1])[-400:] for k, v in card.items()}}
    for k in sorted(card):
        log(f"tool {k} on the card: rc {card[k][0]} {str(card[k][1]).strip()[-160:]!r}")
    log(f"tiny quantize tools card vs cpu: differ {diff}, imatrix {len(ic)} entries within "
        f"{rel:.2e}, launches {launches}")
    for k in diff:
        log(f"  {k}: card {str(card[k][1])[-600:]!r}\n  {k}: cpu  {str(cpu[k][1])[-600:]!r}")
    if diff or not rel <= F32_PRINT_TOL or len(ic) != 29:
        raise AssertionError(f"quantize tools differ on the card from the CPU: {diff}, "
                             f"imatrix {len(ic)} entries within {rel}")
    for name in ("qgemv", "kv_store"):
        if not launches.get(name):
            raise AssertionError(f"the tiny quantize tools ran without {name}: {launches}")
    return out


def phase_quant(dev, report: dict) -> None:
    """imatrix, eval_callback and cvector_generator at the 8B shape, a
    full-width layer's quantize round trip, and the quantize toolchain on
    the tiny pair, card against CPU."""
    import torch

    r: dict = {}
    work = os.path.join(ROOT, "build", "chip_smoke", "quant")
    os.makedirs(work, exist_ok=True)
    cfg, params = weights_8b_centred(dev)
    failed = []

    def part(name, fn, *a):
        t0 = time.time()
        try:
            r[name] = fn(*a)
        except AssertionError as e:  # the phase's other checks still run
            log(f"quant {name} FAILED: {e}")
            failed.append(name)
            r[name] = {"failed": str(e)}
        log(f"quant {name}: {time.time() - t0:.1f} s")

    part("imatrix", quant_imatrix, dev, cfg, params)
    stored = r["imatrix"].pop("stored", None)
    part("eval_callback", quant_eval_callback, dev, cfg, params)
    part("cvector", quant_cvector, dev, cfg, params, work)
    if stored is not None:
        part("roundtrip", quant_roundtrip, dev, cfg, params, stored, work)
    del params, stored
    gc.collect()
    torch.cuda.empty_cache()
    part("tiny", quant_tiny)
    report["quant"] = r
    if failed:
        raise AssertionError(f"phase quant failed: {failed}")
    launches = Counter()
    for counts in (r["imatrix"]["launches"], r["imatrix"]["f32_short"]["launches"],
                   r["eval_callback"]["launches"], r["cvector"]["launches"],
                   r["cvector"]["engine_launches"], r["tiny"]["launches"]):
        launches.update(counts)
    r["launches"] = dict(launches)
    for name, n in launches.items():
        report[name]["quant_launches"] = n


# -- phase embed ---------------------------------------------------------------

# BAAI/bge-base-en-v1.5's config.json (BertModel, CLS pooling) and
# cross-encoder/ms-marco-MiniLM-L-6-v2's (a cls / cls.output rank head)
BGE_BASE = dict(n_layers=12, n_embd=768, n_heads=12, n_ff=3072, n_vocab=30522, n_pos=512,
                pooling=2)
MINILM_L6 = dict(n_layers=6, n_embd=384, n_heads=12, n_ff=1536, n_vocab=30522, n_pos=512,
                 pooling=4)  # llama.cpp's RANK pooling
TINY_BERT = dict(n_layers=2, n_embd=64, n_heads=4, n_ff=128, n_vocab=256, n_pos=128, pooling=1)
EMBED_TOL = 1e-4  # max |kernel - plain| / max |plain| of a vector: phase kernels' GEMV's
EMBED_NORM_TOL = 1e-5
EMBED_COS_MAX = 0.99  # two distinct texts must embed apart
BERT_SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}


def wpm_words(n: int) -> list[str]:
    """n distinct lower-case pseudo-words of two and three syllables."""
    syl = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]
    words = [a + b for a in syl for b in syl]
    words += [a + b + c for a in syl for b in syl for c in syl]
    return words[:n]


def wpm_vocab(n_vocab: int) -> list[str]:
    """A WordPiece vocabulary as a BERT GGUF stores it: the specials at
    bert-base-uncased's ids, [unusedN] fillers below 100, then word-initial
    pieces behind U+2581."""
    toks = [BERT_SPECIALS.get(i, f"[unused{i}]") for i in range(104)]
    return toks + ["▁" + w for w in wpm_words(n_vocab - 104)]


def wpm_text(rng, n_words: int, n_vocab: int) -> str:
    """A text of n_words words of the vocabulary: n_words + 2 tokens with
    [CLS] and [SEP]."""
    words = wpm_words(n_vocab - 104)
    return " ".join(words[i] for i in rng.integers(0, len(words), n_words))


def write_bert_gguf(path: str, shape: dict, seed: int, rank_head: bool = False,
                    ftype=None) -> str:
    """A bert GGUF of `shape` from a seed, written by the port's GGUFWriter:
    projections and the token table in Q8_0 (the usual quant of embedding
    GGUFs, by the port's quantize_np), the rest f32. The weights are
    normal, so centred."""
    import numpy as np

    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.gguf.writer import GGUFWriter
    from prima_tpu_torch.quant.quantize_np import quantize

    ftype = GGMLType.Q8_0 if ftype is None else ftype
    rng = np.random.default_rng(seed)
    e, f, V = shape["n_embd"], shape["n_ff"], shape["n_vocab"]
    w = GGUFWriter(path, arch="bert")
    for key, val in {"block_count": shape["n_layers"], "embedding_length": e,
                     "attention.head_count": shape["n_heads"], "feed_forward_length": f,
                     "context_length": shape["n_pos"], "attention.layer_norm_epsilon": 1e-12,
                     "attention.causal": False, "pooling_type": shape["pooling"]}.items():
        w.add_kv(f"bert.{key}", val)
    toks = wpm_vocab(V)
    w.add_kv("tokenizer.ggml.model", "bert")
    w.add_kv("tokenizer.ggml.tokens", toks)
    w.add_kv("tokenizer.ggml.token_type", [3 if i in BERT_SPECIALS else 1 for i in range(V)])
    for key, i in (("unknown", 100), ("cls", 101), ("seperator", 102), ("padding", 0)):
        w.add_kv(f"tokenizer.ggml.{key}_token_id", i)

    def mat(name, rows, cols, std=0.05):
        x = rng.standard_normal((rows, cols), dtype=np.float32) * np.float32(std)
        if ftype == GGMLType.F32:
            w.add_tensor(name, x)
        else:
            w.add_tensor(name, quantize(x, ftype), ne=(cols, rows), ggml_type=ftype)

    def vec(name, n, around=0.0, std=0.02):
        w.add_tensor(name, (around + rng.standard_normal(n) * std).astype(np.float32))

    def norm(name, n):
        vec(name + ".weight", n, 1.0)
        vec(name + ".bias", n)

    mat("token_embd.weight", V, e, std=0.5)
    w.add_tensor("token_types.weight", (rng.standard_normal((2, e)) * 0.1).astype(np.float32))
    w.add_tensor("position_embd.weight",
                 (rng.standard_normal((shape["n_pos"], e)) * 0.1).astype(np.float32))
    norm("token_embd_norm", e)
    for i in range(shape["n_layers"]):
        p = f"blk.{i}."
        for t in ("q", "k", "v"):
            mat(p + f"attn_{t}.weight", e, e)
            vec(p + f"attn_{t}.bias", e)
        mat(p + "attn_output.weight", e, e)
        vec(p + "attn_output.bias", e)
        norm(p + "attn_output_norm", e)
        mat(p + "ffn_up.weight", f, e)
        vec(p + "ffn_up.bias", f)
        mat(p + "ffn_down.weight", e, f)
        vec(p + "ffn_down.bias", e)
        norm(p + "layer_output_norm", e)
    if rank_head:
        w.add_tensor("cls.weight", (rng.standard_normal((e, e)) * 0.05).astype(np.float32))
        vec("cls.bias", e)
        w.add_tensor("cls.output.weight", (rng.standard_normal((1, e)) * 0.2).astype(np.float32))
        vec("cls.output.bias", 1)
    w.write()
    return path


def bert_forward_bytes(path: str) -> int:
    """The bytes one forward of a short text reads at least: every
    projection's blocks once (the token table only by rows)."""
    from prima_tpu_torch.gguf.reader import GGUFModel

    m = GGUFModel.open(path)
    n = sum(ti.nbytes for name, ti in m.tensors.items()
            if name.startswith("blk.") and name.endswith(".weight") and ti.n_elements > 4096)
    m.close()
    return n


def embed_profile(rt, texts: list) -> dict:
    """profiled_wall of rt.embed(texts): wall ms, launches, device busy ms,
    idle share."""
    r = profiled_wall(lambda: (len(texts), rt.embed(texts)))
    del r["result"], r["same_tokens_profiled"]
    return dict(r, inputs=len(texts))


def _vec_err(got, want) -> float:
    """max |got - want| / max |want| over rows."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} against {want.shape}")
    return float(np.abs(got - want).max() / np.abs(want).max())


def _server_launches(port: int, before: Counter | None = None) -> Counter:
    """The server's kernel launch counts from /props, less `before`."""
    now = Counter(_get(port, "/props")["kernel_launches"])
    return now - before if before is not None else now


def embed_server(path: str, rt, short: list, long: list) -> dict:
    """The embedding model behind python -m prima_tpu_torch.server: /health,
    /v1/models, the short inputs in one request, the long ones in one, the
    short ones again as 4 concurrent requests of 2; each vector against the
    plain runtime, unit norms, distinct texts apart, concurrent answers
    equal to the sequential ones to the bit; each request's launches read
    from the server's /props (qgemv 6 a layer for each short input, none
    for a long one)."""
    import numpy as np

    n_proj = 6 * BGE_BASE["n_layers"]
    proc, port, out, up_s = _start_server([], model=path)
    try:
        r = {"up_s": up_s, "health": _get(port, "/health"), "models": _get(port, "/v1/models")}
        if r["health"] != {"status": "ok"} or r["models"]["data"][0]["id"] != "prima-tpu":
            raise AssertionError(f"embeddings server: {r}")
        vecs, launches = {}, Counter()
        for key, texts in (("short", short), ("long", long)):
            before = _server_launches(port)
            t0 = time.perf_counter()
            resp = _post(port, "/v1/embeddings", {"input": texts})
            wall = (time.perf_counter() - t0) * 1e3
            ran = _server_launches(port, before)
            got = np.asarray([d["embedding"] for d in resp["data"]], np.float32)
            want = rt.embed(texts, matmul_impl="plain")
            vecs[key] = resp["data"]
            r[key] = {"inputs": len(texts), "wall_ms": wall,
                      "embeddings_per_s": len(texts) / wall * 1e3,
                      "max_rel_err_vs_plain": _vec_err(got, want),
                      "max_norm_err": float(np.abs(np.linalg.norm(got, axis=1) - 1).max()),
                      "usage": resp["usage"], "launches": dict(ran)}
            if (r[key]["max_rel_err_vs_plain"] > EMBED_TOL
                    or r[key]["max_norm_err"] > EMBED_NORM_TOL):
                raise AssertionError(f"/v1/embeddings {key}: {r[key]}")
            expect = {"qgemv": n_proj * len(texts)} if key == "short" else {}
            if dict(ran) != expect:
                raise AssertionError(f"/v1/embeddings {key} launched {dict(ran)}, want {expect}")
            launches.update(ran)
        g = np.asarray([d["embedding"] for d in vecs["short"]])
        cos = g @ g.T
        r["max_cosine_distinct"] = float(np.max(cos - 2 * np.eye(len(g))))
        if r["max_cosine_distinct"] >= EMBED_COS_MAX:
            raise AssertionError(f"distinct texts embed alike: cosine {r['max_cosine_distinct']}")
        bodies = [{"input": short[i:i + 2]} for i in range(0, len(short), 2)]
        before = _server_launches(port)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
            conc = list(ex.map(lambda b: _post(port, "/v1/embeddings", b), bodies))
        wall = (time.perf_counter() - t0) * 1e3
        ran = _server_launches(port, before)
        r["concurrent"] = {"requests": len(bodies), "wall_ms": wall, "launches": dict(ran),
                           "equal_to_sequential": [d["embedding"] for c in conc for d in c["data"]]
                           == [d["embedding"] for d in vecs["short"]]}
        if not r["concurrent"]["equal_to_sequential"]:
            raise AssertionError("concurrent /v1/embeddings answers differ from sequential ones")
        if dict(ran) != {"qgemv": n_proj * len(short)}:
            raise AssertionError(f"concurrent /v1/embeddings launched {dict(ran)}")
        launches.update(ran)
        r["launches"] = dict(launches)
        return r
    finally:
        _stop(proc)


def rerank_server(path: str, rt, rng) -> dict:
    """The reranker behind the server: /v1/rerank of a query against 8
    documents with top_n 3; scores against the plain runtime's, same order;
    the request's launches from /props (qgemv 6 a layer for each pair, every
    pair under 32 tokens)."""
    import numpy as np

    V = MINILM_L6["n_vocab"]
    query = wpm_text(rng, 4, V)
    docs = [wpm_text(rng, int(n), V) for n in rng.integers(6, 20, 8)]
    enc = lambda t: len(rt.tokenizer.encode(t, add_special=False))
    pair_tokens = [enc(query) + enc(d) + 4 for d in docs]  # [CLS] q [SEP] [SEP] d [SEP]
    if max(pair_tokens) >= 32:
        raise AssertionError(f"rerank pairs miss the GEMV route: {pair_tokens} tokens")
    proc, port, out, up_s = _start_server([], model=path)
    try:
        before = _server_launches(port)
        t0 = time.perf_counter()
        resp = _post(port, "/v1/rerank", {"query": query, "documents": docs, "top_n": 3})
        wall = (time.perf_counter() - t0) * 1e3
        ran = _server_launches(port, before)
    finally:
        _stop(proc)
    want = rt.rerank(query, docs, matmul_impl="plain")
    order = [int(i) for i in np.argsort(-want, kind="stable")[:3]]
    got = {x["index"]: x["relevance_score"] for x in resp["results"]}
    err = max(abs(got[i] - float(want[i])) for i in got) / float(np.abs(want).max())
    expect = {"qgemv": 6 * MINILM_L6["n_layers"] * len(docs)}
    r = {"up_s": up_s, "wall_ms": wall, "documents": len(docs), "pair_tokens": pair_tokens,
         "results": resp["results"], "plain_top3": order, "max_rel_err_vs_plain": err,
         "scores_plain": [float(x) for x in want], "launches": dict(ran)}
    if list(got) != order or err > EMBED_TOL:
        raise AssertionError(f"/v1/rerank against plain: {r}")
    if dict(ran) != expect:
        raise AssertionError(f"/v1/rerank launched {dict(ran)}, want {expect}")
    return r


def embed_tools(work: str) -> dict:
    """The embedding and retrieval tools on a tiny bert GGUF, the card
    against --device cpu (f32): equal text, printed numbers within 1e-5;
    the card's launch counts."""
    import re

    import numpy as np

    from prima_tpu_torch.tools import embedding, retrieval

    path = write_bert_gguf(os.path.join(work, "tiny_bert.gguf"), TINY_BERT, seed=5)
    rng = np.random.default_rng(6)
    V = TINY_BERT["n_vocab"]
    ctx = os.path.join(work, "context.txt")
    with open(ctx, "w") as f:
        f.write("\n".join(wpm_text(rng, int(n), V) for n in rng.integers(4, 12, 12)))
    prompts = "\\n".join(wpm_text(rng, 5, V) for _ in range(3))
    runs = [("embedding", embedding.main, ["-m", path, "-p", prompts]),
            ("embedding_json+", embedding.main, ["-m", path, "-p", prompts,
                                                 "--embd-output-format", "json+"]),
            ("embedding_cls_array", embedding.main, ["-m", path, "-p", prompts, "--pooling",
                                                     "cls", "--embd-output-format", "array"]),
            ("retrieval", retrieval.main, ["-m", path, "--context-file", ctx, "--chunk-size",
                                           "40", "--top-k", "3", "-q", wpm_text(rng, 3, V)])]
    num = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")
    r, counters = {}, zero_counts()
    out = {dev: {name: tool_call(main, args + ["--device", dev]) for name, main, args in runs}
           for dev in ("cuda", "cpu")}
    for name, *_ in runs:
        (rc, a, err), (rc2, b, _) = out["cuda"][name], out["cpu"][name]
        x = [float(v) for v in num.findall(a)]
        y = [float(v) for v in num.findall(b)]
        worst = max((abs(p - q) for p, q in zip(x, y)), default=0.0)
        same = (rc == rc2 == 0 and num.sub("#", a) == num.sub("#", b) and len(x) == len(y) > 0
                and worst <= 1e-5)
        r[name] = {"same": same, "max_abs_diff": worst, "stdout": a[-300:]}
        if not same:
            raise AssertionError(f"{name} on the card differs from the CPU: {a[-600:]!r} "
                                 f"against {b[-600:]!r} {err[-600:]}")
    r["launches"] = read_counts(counters)  # the CPU runs launch nothing
    if not r["launches"].get("qgemv"):
        raise AssertionError(f"the embedding tools ran without qgemv: {r['launches']}")
    return r


def phase_embed(dev, report: dict) -> dict:
    """The embedding server at full width: a bge-base-en-v1.5-shape and an
    ms-marco-MiniLM-L-6-v2-shape GGUF (Q8_0 from a seed) served by python
    -m prima_tpu_torch.server, with the launches each request made read
    from the server (72 qgemv a short forward of BERT-base); the same
    forwards in process for their device time and idle share; the
    embedding tools, card against CPU. Returns the launch counts of the
    server and the tools."""
    import numpy as np
    import torch

    from prima_tpu_torch.models.bert import BertModelRuntime

    work = os.path.join(ROOT, "build", "chip_smoke", "embed")
    os.makedirs(work, exist_ok=True)
    r: dict = {}
    t0 = time.time()
    bge = write_bert_gguf(os.path.join(work, "bge-base.gguf"), BGE_BASE, seed=21)
    rr = write_bert_gguf(os.path.join(work, "minilm-l6-rerank.gguf"), MINILM_L6, seed=22,
                         rank_head=True)
    r["write_s"] = time.time() - t0
    rng = np.random.default_rng(23)
    V = BGE_BASE["n_vocab"]
    short = [wpm_text(rng, int(n) - 2, V) for n in rng.integers(8, 25, 8)]
    long = [wpm_text(rng, int(n) - 2, V) for n in (128, 256, 384, 512)]
    torch.cuda.reset_peak_memory_stats(dev)
    rt = BertModelRuntime.load(bge, device=dev)
    n_short = [len(rt.tokenizer.encode(t)) for t in short]
    n_long = [len(rt.tokenizer.encode(t)) for t in long]
    r["tokens"] = {"short": n_short, "long": n_long}
    if max(n_short) >= 32 or min(n_long) < 128:
        raise AssertionError(f"the texts miss their routes: {r['tokens']}")
    t0 = time.time()
    r["server"] = embed_server(bge, rt, short, long)
    log(f"embed server: {time.time() - t0:.1f} s")
    rt.embed(short[:1])  # warm-up
    r["profile_short"] = embed_profile(rt, short)
    r["profile_long"] = embed_profile(rt, long)
    nbytes = bert_forward_bytes(bge)
    r["bound_ms_short_forward"] = nbytes / HBM_BYTES_PER_S * 1e3
    r["bound_bytes_short_forward"] = nbytes
    r["peak_gib_in_process"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del rt
    gc.collect()
    rrt = BertModelRuntime.load(rr, device=dev)
    t0 = time.time()
    r["rerank"] = rerank_server(rr, rrt, rng)
    log(f"embed rerank: {time.time() - t0:.1f} s")
    del rrt
    gc.collect()
    torch.cuda.empty_cache()
    r["tools"] = embed_tools(work)
    launches = Counter(r["server"]["launches"])
    launches.update(r["rerank"]["launches"])
    launches.update(r["tools"]["launches"])
    r["launches"] = dict(launches)
    s, lg = r["server"]["short"], r["server"]["long"]
    log(f"embed: bge-base short x{len(short)} ({n_short} tokens) {s['wall_ms']:.1f} ms "
        f"wall at the server, {s['embeddings_per_s']:.1f} emb/s; in process "
        f"{r['profile_short']['wall_ms']:.1f} ms wall, {r['profile_short']['device_busy_ms']:.2f} "
        f"ms device, idle {r['profile_short']['device_idle_share']:.3f}; long x{len(long)} "
        f"{lg['wall_ms']:.1f} ms, {r['profile_long']['device_busy_ms']:.2f} ms device, idle "
        f"{r['profile_long']['device_idle_share']:.3f}; bound a short forward "
        f"{r['bound_ms_short_forward']:.4f} ms; server vs plain short "
        f"{s['max_rel_err_vs_plain']:.2e} long {lg['max_rel_err_vs_plain']:.2e}; distinct cosine <= {r['server']['max_cosine_distinct']:.4f}; rerank err "
        f"{r['rerank']['max_rel_err_vs_plain']:.2e}; peak {r['peak_gib_in_process']:.2f} GiB; "
        f"launches {r['launches']}")
    report["embed"] = r
    for name, n in launches.items():
        report[name]["embed_launches"] = n
    return dict(launches)


# -- phase vision ----------------------------------------------------------------

# llava-hf/llava-1.5-7b-hf: the openai/clip-vit-large-patch14-336 tower (24
# layers, 23 run), an mlp projector into Llama-2-7B (MHA, FFN 11008)
CLIP_L336 = dict(image_size=336, patch_size=14, n_embd=1024, n_ff=4096, n_layers=24,
                 n_heads=16, eps=1e-5, proj_dim=768, use_gelu=False, projector_type="mlp")
LLAMA2_7B = dict(n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=32, head_dim=128, n_ff=11008,
                 n_vocab=32000, n_ctx_train=4096, rope_base=10000.0, rope_dim=128, rms_eps=1e-5)
VISION_PREFIX, VISION_SUFFIX, VISION_TOKENS, VISION_CTX = 5, 12, 32, 1024
CLIP_TOL = 1e-4  # card against CPU, f32: max |err| / max |out|


def clip_params_device(cfg, dev, seed: int, mm_out: int) -> dict:
    """CLIP ViT-L/14-336 and its mlp projector in f32 on the card, from a
    seeded generator (no patch bias or post-LN, as llava-1.5's mmproj)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rn = lambda *s, std=0.02: torch.randn(s, generator=gen, device=dev) * std
    e, f = cfg.n_embd, cfg.n_ff
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
    p = {"patch_embd": rn(e, 3, cfg.patch_size, cfg.patch_size), "patch_bias": None,
         "class_embd": rn(e), "pos_embd": rn(n_pos, e), "pre_ln_w": 1 + rn(e),
         "pre_ln_b": rn(e), "post_ln_w": None, "post_ln_b": None, "layers": []}
    for _ in range(cfg.n_layers):
        layer = {"ln1_w": 1 + rn(e), "ln1_b": rn(e), "ln2_w": 1 + rn(e), "ln2_b": rn(e),
                 "ffi_w": rn(f, e), "ffi_b": rn(f), "ffo_w": rn(e, f), "ffo_b": rn(e)}
        for n in ("q", "k", "v", "o"):
            layer[n + "_w"], layer[n + "_b"] = rn(e, e), rn(e)
        p["layers"].append(layer)
    p.update({"mm.0.weight": rn(mm_out, e), "mm.0.bias": rn(mm_out),
              "mm.2.weight": rn(mm_out, mm_out), "mm.2.bias": rn(mm_out)})
    return p


def llava_steps(rt, prefix: list, embeds, suffix: list, n: int) -> tuple[list, list]:
    """prefix tokens, the image's embeddings and suffix tokens through
    LlavaRuntime, then n greedy steps: (tokens, each step's logits)."""
    import numpy as np

    rt.eval_tokens(prefix)
    rt.eval_embeds(embeds)
    logits = rt.eval_tokens(suffix)
    toks, seen = [], [logits]
    for _ in range(n):
        toks.append(int(np.argmax(logits)))
        logits = rt.eval_tokens([toks[-1]])
        seen.append(logits)
    return toks, seen


def phase_vision(dev, report: dict) -> dict:
    """llava-1.5-7b at full width: CLIP ViT-L/14-336 with an mlp projector
    (f32, seeded) on a seeded normalized image, card against CPU; Llama-2-7B
    (centred Q4_K generated on the card) through LlavaRuntime: 5 text
    tokens, the 576 image embeddings, 12 text tokens and 32 greedy tokens,
    kernels against plain in f32 (logits, top 5 ids and streams), then in
    bf16 timed with its launch counts (225 qgemv and 32 kv_store a decode
    step), its device time and idle share over the same 32 steps, and peak
    memory. Returns the launch counts."""
    import types

    import numpy as np
    import torch

    from prima_tpu_torch.models.clip import ClipVisionConfig, clip_encode_image
    from prima_tpu_torch.models.llama import ForwardOptions, init_kv_caches
    from prima_tpu_torch.sampling import Sampler, SamplerParams
    from prima_tpu_torch.tools.llava_cli import LlavaRuntime

    r: dict = {}
    torch.cuda.reset_peak_memory_stats(dev)
    ccfg = ClipVisionConfig(**CLIP_L336)
    cparams = clip_params_device(ccfg, dev, seed=31, mm_out=LLAMA2_7B["n_embd"])
    px = np.random.default_rng(32).standard_normal(
        (3, ccfg.image_size, ccfg.image_size)).astype(np.float32)
    pxd = torch.from_numpy(px).to(dev)
    with torch.no_grad():
        emb = clip_encode_image(cparams, ccfg, pxd)
        r["clip_ms"] = time_ms(lambda x: clip_encode_image(cparams, ccfg, x), [(pxd,)], reps=5,
                               per_rep=1, warmup=1)
        t0 = time.time()
        cpu = clip_encode_image(params_to(cparams, "cpu"), ccfg, torch.from_numpy(px))
        r["clip_cpu_s"] = time.time() - t0
    r["clip_rows"] = list(emb.shape)
    r["clip_err_vs_cpu"] = _vec_err(emb.cpu().numpy(), cpu.numpy())
    if r["clip_err_vs_cpu"] > CLIP_TOL or list(emb.shape) != [576, LLAMA2_7B["n_embd"]]:
        raise AssertionError(f"CLIP on the card against the CPU: {r}")
    del cparams, cpu
    gc.collect()
    cfg, params = weights_centred(dev, LLAMA2_7B, seed=33, name="Llama-2-7B-shape")
    model = types.SimpleNamespace(cfg=cfg, params=params)
    rng = np.random.default_rng(34)
    prefix = rng.integers(0, cfg.n_vocab, VISION_PREFIX).tolist()
    suffix = rng.integers(0, cfg.n_vocab, VISION_SUFFIX).tolist()
    img = emb.float()
    runs = {}
    for impl in ("kernel", "plain"):  # f32 activations and caches
        rt = LlavaRuntime(model, max_seq=VISION_CTX, matmul_impl=impl, device=dev)
        rt.opts = ForwardOptions(matmul_impl=impl, dtype=torch.float32)
        rt.kv = init_kv_caches(cfg, 1, VISION_CTX, torch.float32, dev)
        runs[impl] = llava_steps(rt, prefix, img, suffix, VISION_TOKENS)
        del rt
        gc.collect()
    (kt, kl), (pt, pl) = runs["kernel"], runs["plain"]
    # the random model repeats one token, so the stream alone shows little:
    # each step's top 5 ids must match too (step_rule)
    r["f32"] = dict(step_rule(kl, pl), tokens_equal=kt == pt, tokens=kt)
    if not (kt == pt and rule_holds(r["f32"])):
        raise AssertionError(f"llava kernels against plain (f32): {r['f32']}, plain {pt}")
    # bf16, as LlavaRuntime runs by default
    rt = LlavaRuntime(model, max_seq=VISION_CTX, device=dev)
    counters = zero_counts()
    rt.eval_tokens(prefix)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt.eval_embeds(img)
    torch.cuda.synchronize()
    r["splice_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    logits = rt.eval_tokens(suffix)
    r["prefill_launches"] = read_counts(counters)
    pos0 = rt.pos

    def decode_window():  # the same 32 greedy steps from the same cache rows
        rt.pos = pos0
        return (rt.generate(Sampler(SamplerParams(temp=0.0)), VISION_TOKENS, logits, set()),)

    pw = profiled_wall(decode_window)
    out, wall, decode = pw["result"][0], pw["wall_ms"] / 1e3, pw["launches"]
    r["bf16"] = {"tokens": out, "decode_wall_ms": pw["wall_ms"],
                 "decode_tok_s": len(out) / wall, "launches": decode,
                 "same_tokens_profiled": pw["same_tokens_profiled"]}
    want = {"qgemv": 225 * VISION_TOKENS, "kv_store": 32 * VISION_TOKENS}
    if len(out) != VISION_TOKENS or decode != want or not pw["same_tokens_profiled"]:
        raise AssertionError(f"llava decode: {len(out)} tokens, launches {decode}, want "
                             f"{want}; {r['bf16']}")
    busy = pw["device_busy_ms"] / len(out)
    step_wall = pw["wall_ms"] / len(out)
    r["bf16"].update({"device_ms_a_step": busy, "wall_ms_a_step": step_wall,
                      "device_idle_share": pw["device_idle_share"],
                      "device_ms": pw["device_ms"], "top_kernels_ms": pw["top_kernels_ms"]})
    # a decode step's byte bound: every projection and the head read once
    qts = [layer[k] for layer in params["layers"] for k in GGUF_NAMES] + [params["output"]]
    step_bytes = sum(a.numel() * a.element_size() for qt in qts for a in qt.tensors()
                     if a is not None)
    r["bf16"]["bound_ms_a_step"] = step_bytes / HBM_BYTES_PER_S * 1e3
    r["bf16"]["weight_bytes_a_step"] = step_bytes
    r["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launches = Counter(r["prefill_launches"])
    launches.update(decode)
    r["launches"] = dict(launches)
    log(f"vision: CLIP-L/336 {r['clip_ms']:.2f} ms (card vs CPU {r['clip_err_vs_cpu']:.2e}, "
        f"CPU {r['clip_cpu_s']:.1f} s); splice prefill {r['splice_prefill_ms']:.1f} ms; decode "
        f"{r['bf16']['decode_tok_s']:.2f} tok/s, {busy:.2f} ms device in {step_wall:.2f} ms a "
        f"step (bound {r['bf16']['bound_ms_a_step']:.3f}), idle "
        f"{r['bf16']['device_idle_share']:.3f}; f32 kernels vs plain "
        f"{r['f32']['max_rel_logit_err']:.2e} over {r['f32']['steps']} steps, tokens equal, "
        f"top 5 equal ({r['f32']['top5_steps_tied']} steps tied); "
        f"peak {r['peak_gib']:.2f} GiB; launches {r['launches']}")
    del rt, params, model, emb, img
    gc.collect()
    torch.cuda.empty_cache()
    report["vision"] = r
    for name, n in launches.items():
        report[name]["vision_launches"] = n
    return dict(launches)


# ---------------------------------------------------------------------------
# phase 13: the dense family runtimes (deepseek2 / minicpm3, mamba, rwkv6, t5)

# The published config.json numbers of each model (nothing is downloaded).
# deepseek-ai/DeepSeek-V2-Lite: YaRN factor 40 over 4096, beta 32 / 1,
# mscale_all_dim 0.707 (yarn_log_multiplier 0.1 * 0.707); its routed
# experts are 1408 wide, the two shared ones one expert of 2816
DSV2_LITE = dict(arch="deepseek2", n_layers=27, n_embd=2048, n_heads=16, qk_rope=64, qk_nope=128,
                 v_head_dim=128, q_lora_rank=0, kv_lora_rank=512, n_ff=10944, n_dense_lead=1,
                 n_expert=64, n_expert_used=6, n_expert_shared=2, expert_weights_scale=1.0,
                 n_vocab=102400, rms_eps=1e-6, rope_base=10000.0, rope_scaling="yarn",
                 rope_factor=40.0, rope_orig_ctx=4096, yarn_log_mul=0.0707, beta_fast=32.0,
                 beta_slow=1.0)
DSV2_LITE_FF_EXP = 1408
# state-spaces/mamba-2.8b-hf: tied embeddings
MAMBA_2_8B = dict(arch="mamba", n_layers=64, n_embd=2560, d_inner=5120, d_conv=4, d_state=16,
                  dt_rank=160, n_vocab=50280, n_ctx_train=2048, rms_eps=1e-5)
# RWKV/v6-Finch-1B6-HF
RWKV6_1B6 = dict(arch="rwkv6", n_layers=24, n_embd=2048, head_size=64, n_ff=7168, n_vocab=65536,
                 ln_eps=1e-5, rescale_every=6, time_mix_extra_dim=32, time_decay_extra_dim=64)
# google/flan-t5-large: gated-GELU, untied head
FLAN_T5_LARGE = dict(arch="t5", n_layers=24, n_enc_layers=24, n_embd=1024, n_heads=16,
                     head_dim=64, n_ff=2816, n_vocab=32128, rms_eps=1e-6, rel_buckets=32,
                     rel_max_dist=128, dec_start_token=0, tie_embeddings=False, ffn_gated=True)
FAMILY_PROMPT = 32  # prompt tokens (the encoder's input for T5)
FAMILY_TOKENS = {"deepseek2": 16, "mamba": 32, "rwkv6": 32, "t5": 16}
FAMILY_CHECK_LAYERS = {"deepseek2": 2, "mamba": 4, "rwkv6": 4, "t5": 2}  # card vs CPU


class HostDraw:
    """Seeded weights in f32 numpy (params_from_numpy carries them to any
    device)."""

    def __init__(self, seed: int):
        import numpy as np

        self.rng = np.random.default_rng(seed)

    def normal(self, *shape, std=0.02, mean=0.0):
        import numpy as np

        x = self.rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(std)
        if mean:
            x += np.float32(mean)
        return x

    def uniform(self, *shape, lo, hi):
        import numpy as np

        return self.rng.uniform(lo, hi, shape).astype(np.float32)

    def const(self, a):
        import numpy as np

        return np.asarray(a, np.float32)


class CardDraw:
    """Seeded weights drawn on the card in `dtype`."""

    def __init__(self, seed: int, dev, dtype):
        import torch

        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.dev, self.dtype = dev, dtype

    def normal(self, *shape, std=0.02, mean=0.0):
        import torch

        x = torch.randn(shape, generator=self.gen, device=self.dev, dtype=self.dtype)
        x.mul_(std)
        if mean:
            x.add_(mean)
        return x

    def uniform(self, *shape, lo, hi):
        import torch

        x = torch.rand(shape, generator=self.gen, device=self.dev, dtype=torch.float32)
        return (x * (hi - lo) + lo).to(self.dtype)

    def const(self, a):
        import numpy as np
        import torch

        return torch.from_numpy(np.asarray(a, np.float32)).to(self.dev, self.dtype)


def ds2_tree(c: dict, n_layers: int, d) -> dict:
    """DeepSeek-V2 params (load_deepseek2_params' tree): projections at std
    0.02, unit norms; q_lora_rank 0 (a direct wq), stacked experts."""
    e, h = c["n_embd"], c["n_heads"]
    qk = c["qk_nope"] + c["qk_rope"]
    fe, ne = DSV2_LITE_FF_EXP, c["n_expert"]
    ones = lambda n: d.normal(n, std=0.0, mean=1.0)
    p = {"tok_embd": d.normal(c["n_vocab"], e), "layers": [], "output_norm": ones(e),
         "output": d.normal(c["n_vocab"], e), "rope_long": None, "rope_short": None}
    for i in range(n_layers):
        layer = {"attn_norm": ones(e), "wq": d.normal(h * qk, e),
                 "kv_a_mqa": d.normal(c["kv_lora_rank"] + c["qk_rope"], e),
                 "kv_a_norm": ones(c["kv_lora_rank"]),
                 "kv_b": d.normal(h * (c["qk_nope"] + c["v_head_dim"]), c["kv_lora_rank"]),
                 "wo": d.normal(e, h * c["v_head_dim"]), "ffn_norm": ones(e)}
        if i < c["n_dense_lead"]:
            layer.update(w_gate=d.normal(c["n_ff"], e), w_up=d.normal(c["n_ff"], e),
                         w_down=d.normal(e, c["n_ff"]))
        else:
            fs = fe * c["n_expert_shared"]
            layer.update(gate_inp=d.normal(ne, e), ffn_gate_exps=d.normal(ne, fe, e),
                         ffn_up_exps=d.normal(ne, fe, e), ffn_down_exps=d.normal(ne, e, fe),
                         gate_shexp=d.normal(fs, e), up_shexp=d.normal(fs, e),
                         down_shexp=d.normal(e, fs))
        p["layers"].append(layer)
    return p


def mamba_tree(c: dict, n_layers: int, d) -> dict:
    """Mamba params at the scale of HF's initializers: A_log = log(1..d_state)
    (so A = -(1..d_state)), D = 1, the dt bias the inverse softplus of a dt
    drawn log-uniform in [1e-3, 0.1], the conv uniform in +-1/sqrt(d_conv);
    projections at std 0.02, unit norms; tied embeddings."""
    import numpy as np

    e, di, ds, dtr = c["n_embd"], c["d_inner"], c["d_state"], c["dt_rank"]
    a = -np.tile(np.arange(1, ds + 1, dtype=np.float32), (di, 1))
    ones = lambda n: d.normal(n, std=0.0, mean=1.0)
    p = {"tok_embd": d.normal(c["n_vocab"], e), "layers": [], "output_norm": ones(e),
         "output": None}
    for i in range(n_layers):
        # dt from a host generator seeded by the layer, on either device
        dt = np.exp(HostDraw(1000 + i).uniform(di, lo=np.log(1e-3), hi=np.log(0.1)))
        dt_b = dt + np.log(-np.expm1(-dt))  # the inverse softplus
        bound = 1.0 / np.sqrt(c["d_conv"])
        p["layers"].append({"norm": ones(e), "ssm_in": d.normal(2 * di, e),
                            "conv_w": d.uniform(di, c["d_conv"], lo=-bound, hi=bound),
                            "conv_b": d.uniform(di, lo=-bound, hi=bound),
                            "ssm_x": d.normal(dtr + 2 * ds, di), "dt_w": d.normal(di, dtr),
                            "dt_b": d.const(dt_b), "A": d.const(a), "D": d.const(np.ones(di)),
                            "out": d.normal(e, di)})
    return p


def rwkv6_tree(c: dict, n_layers: int, d) -> dict:
    """RWKV-6 params: the lerps and the decay around 0.5 (std 0.05) and
    time_mix_first at std 0.2, as tests/test_rwkv6.py's fixture; other
    projections at std 0.02, unit LayerNorms with zero biases; layer i's
    time_mix_output and channel_mix_value divided by 2^(i // rescale_every),
    as the converter bakes the rescale into a GGUF."""
    e, f = c["n_embd"], c["n_ff"]
    H, N = e // c["head_size"], c["head_size"]
    tmx, tdx = c["time_mix_extra_dim"], c["time_decay_extra_dim"]
    ones = lambda n: d.normal(n, std=0.0, mean=1.0)
    zeros = lambda n: d.normal(n, std=0.0)
    half = lambda n: d.normal(n, std=0.05, mean=0.5)
    p = {"tok_embd": d.normal(c["n_vocab"], e), "tok_norm": ones(e), "tok_norm_b": zeros(e),
         "output_norm": ones(e), "output_norm_b": zeros(e), "output": d.normal(c["n_vocab"], e),
         "layers": []}
    for i in range(n_layers):
        scale = 0.5 ** (i // c["rescale_every"]) if c["rescale_every"] else 1.0
        layer = {"attn_norm": ones(e), "attn_norm_b": zeros(e), "attn_norm_2": ones(e),
                 "attn_norm_2_b": zeros(e), "w1": d.normal(5 * tmx, e), "w2": d.normal(5, e, tmx),
                 "first": d.normal(H, N, std=0.2), "decay": half(e),
                 "decay_w1": d.normal(tdx, e), "decay_w2": d.normal(e, tdx),
                 "key": d.normal(e, e), "value": d.normal(e, e), "receptance": d.normal(e, e),
                 "gate": d.normal(e, e), "ln": ones(e), "ln_b": zeros(e),
                 "out": d.normal(e, e, std=0.02 * scale), "cm_key": d.normal(f, e),
                 "cm_value": d.normal(e, f, std=0.02 * scale),
                 "cm_receptance": d.normal(e, e)}
        for k in ("lerp_x", "lerp_w", "lerp_k", "lerp_v", "lerp_r", "lerp_g", "cm_lerp_k",
                  "cm_lerp_r"):
            layer[k] = half(e)
        p["layers"].append(layer)
    return p


def t5_tree(c: dict, n_layers: int, d) -> dict:
    """T5 params (gated-GELU, untied head): std 0.02, unit norms, relative
    attention biases on block 0 of each stack only."""
    e, f, hd = c["n_embd"], c["n_ff"], c["n_heads"] * c["head_dim"]
    ones = lambda n: d.normal(n, std=0.0, mean=1.0)

    def block(i, cross):
        b = {"attn_norm": ones(e), "wq": d.normal(hd, e), "wk": d.normal(hd, e),
             "wv": d.normal(hd, e), "wo": d.normal(e, hd),
             "rel_b": d.normal(c["rel_buckets"], c["n_heads"]) if i == 0 else None,
             "ffn_norm": ones(e), "w_up": d.normal(f, e), "w_gate": d.normal(f, e),
             "w_down": d.normal(e, f)}
        if cross:
            b.update(cross_norm=ones(e), cq=d.normal(hd, e), ck=d.normal(hd, e),
                     cv=d.normal(hd, e), co=d.normal(e, hd))
        return b

    return {"tok_embd": d.normal(c["n_vocab"], e),
            "enc": [block(i, False) for i in range(n_layers)],
            "dec": [block(i, True) for i in range(n_layers)], "enc_norm": ones(e),
            "dec_norm": ones(e), "output": d.normal(c["n_vocab"], e)}


def family_cfg(name: str, n_layers: int | None = None):
    from prima_tpu_torch.models import deepseek2, mamba, rwkv6, t5

    c = {"deepseek2": (deepseek2.DeepseekV2Config, DSV2_LITE),
         "mamba": (mamba.MambaConfig, MAMBA_2_8B), "rwkv6": (rwkv6.Rwkv6Config, RWKV6_1B6),
         "t5": (t5.T5Config, FLAN_T5_LARGE)}[name]
    cfg = c[0](**c[1])
    if n_layers is not None:
        cfg.n_layers = n_layers
        if name == "t5":
            cfg.n_enc_layers = n_layers
    return cfg


FAMILY_TREES = {"deepseek2": (DSV2_LITE, ds2_tree), "mamba": (MAMBA_2_8B, mamba_tree),
                "rwkv6": (RWKV6_1B6, rwkv6_tree), "t5": (FLAN_T5_LARGE, t5_tree)}
FAMILY_RUNTIMES = {"deepseek2": ("deepseek2", "DeepseekV2Runtime", "deepseek2_forward"),
                   "mamba": ("mamba", "MambaRuntime", "mamba_forward"),
                   "rwkv6": ("rwkv6", "Rwkv6Runtime", "rwkv6_forward"),
                   "t5": ("t5", "T5Runtime", "t5_decode")}


def family_run(name: str, rt, prompt: list, n: int) -> tuple[list, list]:
    """rt.generate(prompt, n) (the entry point the CLI calls), recording the
    last row of the logits of each forward it makes: (tokens, rows)."""
    import importlib

    mod = importlib.import_module("prima_tpu_torch.models." + FAMILY_RUNTIMES[name][0])
    fname = FAMILY_RUNTIMES[name][2]
    real, rows = getattr(mod, fname), []

    def record(*a, **kw):
        out = real(*a, **kw)
        logits = out[0] if isinstance(out, tuple) else out
        rows.append(logits[0, -1].float().cpu().numpy())
        return out

    setattr(mod, fname, record)
    try:
        toks = rt.generate(prompt, n_predict=n)
    finally:
        setattr(mod, fname, real)
    return toks, rows


def family_teacher_forced(name: str, params, cfg, prompt: list, toks: list) -> list:
    """The rows a run that produced `toks` from `prompt` saw, from one
    teacher-forced forward of the whole sequence: for the recurrent
    families the prompt's last row and one row a generated token (their
    runs make one more forward than tokens), else one row a token."""
    import importlib

    import torch

    mod = importlib.import_module("prima_tpu_torch.models." + FAMILY_RUNTIMES[name][0])
    with torch.no_grad():
        if name == "t5":
            enc = mod.t5_encode(params, cfg, [prompt])
            lg = mod.t5_decode(params, cfg, [[cfg.dec_start_token] + toks[:-1]], enc)[0]
            return list(lg.float().cpu().numpy())
        if name == "deepseek2":
            lg = mod.deepseek2_forward(params, cfg, [prompt + toks[:-1]])[0]
        else:
            lg = getattr(mod, FAMILY_RUNTIMES[name][2])(params, cfg, [prompt + toks])[0][0]
    return list(lg[len(prompt) - 1:].float().cpu().numpy())


def step_rule(got: list, want: list) -> dict:
    """Rows against reference rows: the largest max |err| / max |want|,
    argmax equal at every step, and the top 5 ids equal at every step
    unless the reference's 5th and 6th logits lie within twice the rows'
    difference (a tie, counted apart)."""
    import numpy as np

    errs, tied, differ, argmax_equal = [], 0, 0, len(got) == len(want)
    for a, b in zip(got, want):
        diff = float(np.abs(a - b).max())
        errs.append(diff / float(np.abs(b).max()))
        argmax_equal &= int(np.argmax(a)) == int(np.argmax(b))
        ib = np.argsort(-b)[:6]
        if b[ib[4]] - b[ib[5]] <= 2 * diff:
            tied += 1
        elif set(np.argsort(-a)[:5]) != set(ib[:5]):
            differ += 1
    return {"max_rel_logit_err": max(errs), "argmax_equal": argmax_equal,
            "top5_steps_differ": differ, "top5_steps_tied": tied, "steps": len(errs)}


def rule_holds(r: dict) -> bool:
    return r["argmax_equal"] and not r["top5_steps_differ"] and r["max_rel_logit_err"] <= LOGITS_TOL


def family_card_vs_cpu(name: str, dev, seed: int) -> dict:
    """Full width at FAMILY_CHECK_LAYERS of depth in f32: seeded numpy weights
    carried by params_from_numpy to the card and to the CPU; the card's
    generate (every forward's last row recorded) against one teacher-forced
    CPU forward over the stream, by step_rule."""
    import importlib

    import numpy as np
    import torch

    from prima_tpu_torch.models.llama import params_from_numpy

    shape, tree = FAMILY_TREES[name]
    n_layers = FAMILY_CHECK_LAYERS[name]
    t0 = time.time()
    host = tree(shape, n_layers, HostDraw(seed))
    host_s = time.time() - t0
    cfg = family_cfg(name, n_layers)
    mod = importlib.import_module("prima_tpu_torch.models." + FAMILY_RUNTIMES[name][0])
    runtime = getattr(mod, FAMILY_RUNTIMES[name][1])
    prompt = np.random.default_rng(seed + 1).integers(0, cfg.n_vocab, FAMILY_PROMPT).tolist()
    t0 = time.time()
    card = runtime(cfg, params_from_numpy(host, dev))
    counters = zero_counts()
    toks, rows = family_run(name, card, prompt, FAMILY_TOKENS[name])
    launches = read_counts(counters)
    del card
    gc.collect()
    torch.cuda.empty_cache()
    card_s = time.time() - t0
    t0 = time.time()
    want = family_teacher_forced(name, params_from_numpy(host, "cpu"), cfg, prompt, toks)
    r = dict(step_rule(rows, want), layers=n_layers, tokens=toks, host_weights_s=host_s,
             card_s=card_s, cpu_s=time.time() - t0, launches=launches)
    if not rule_holds(r) or launches:
        raise AssertionError(f"{name} card against CPU ({n_layers} layers, f32): {r}")
    return r


# phase families runs DeepSeek-V2-Lite at 14 of its 27 layers (full width):
# the script's 20-minute limit made room for phases mesh and train there
FAMILY_FULL_LAYERS = {"deepseek2": 14}


def family_full(name: str, dev, dtype, seed: int) -> dict:
    """Full width on the card (full depth but for FAMILY_FULL_LAYERS),
    weights drawn there in `dtype`:
    the prompt's forward (prefill ms), then generate timed and profiled
    (profiled_wall: per-token wall and device ms, idle share), its launch
    counts (none of the hand kernels) and peak memory; for the recurrent
    families the decode's rows against one full-sequence forward on the card
    by step_rule."""
    import importlib

    import numpy as np
    import torch

    shape, tree = FAMILY_TREES[name]
    cfg = family_cfg(name, FAMILY_FULL_LAYERS.get(name))
    mod = importlib.import_module("prima_tpu_torch.models." + FAMILY_RUNTIMES[name][0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    params = tree(shape, cfg.n_layers, CardDraw(seed, dev, dtype))
    torch.cuda.synchronize()
    r: dict = {"dtype": str(dtype).removeprefix("torch."), "layers": cfg.n_layers,
               "weights_s": time.time() - t0}
    r["weight_gib"] = sum(t.numel() * t.element_size() for t in _tensors(params)) / 2 ** 30
    rt = getattr(mod, FAMILY_RUNTIMES[name][1])(cfg, params)
    prompt = np.random.default_rng(seed + 1).integers(0, cfg.n_vocab, FAMILY_PROMPT).tolist()
    n = FAMILY_TOKENS[name]
    with torch.no_grad():
        for _ in range(2):  # the second forward is timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "t5":
                mod.t5_decode(params, cfg, [[cfg.dec_start_token]],
                              mod.t5_encode(params, cfg, [prompt]))
            else:
                getattr(mod, FAMILY_RUNTIMES[name][2])(params, cfg, [prompt])
            torch.cuda.synchronize()
            r["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    counters = zero_counts()
    t0 = time.perf_counter()
    toks, rows = family_run(name, rt, prompt, n)
    torch.cuda.synchronize()
    r["generate_wall_ms"] = (time.perf_counter() - t0) * 1e3
    r["launches"] = read_counts(counters)
    r["tokens"] = toks
    # the profiled window: a recompute runtime's later forwards repeat the
    # first ones' ops over a longer prefix, so deepseek2 profiles 4 tokens
    n_prof = 4 if name == "deepseek2" else n
    pw = profiled_wall(lambda: (rt.generate(prompt, n_predict=n_prof),))
    r.update({"profiled_tokens": n_prof, "wall_ms_a_token": pw["wall_ms"] / n_prof,
              "device_ms_a_token": pw["device_busy_ms"] / n_prof,
              "device_idle_share": pw["device_idle_share"],
              "top_kernels_ms": pw["top_kernels_ms"],
              "same_tokens_profiled": pw["same_tokens_profiled"]
              and pw["result"][0] == toks[:n_prof]})
    r["launches_profiled_run"] = pw["launches"]
    if name in ("mamba", "rwkv6"):
        r["decode_vs_full"] = step_rule(rows, family_teacher_forced(name, params, cfg, prompt,
                                                                   toks))
        if not rule_holds(r["decode_vs_full"]):
            raise AssertionError(f"{name}: decode against the full forward: {r}")
    r["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if r["launches"] or r["launches_profiled_run"] or len(toks) != n \
            or not r["same_tokens_profiled"]:
        raise AssertionError(f"{name} at full depth: {r}")
    del rt, params
    gc.collect()
    torch.cuda.empty_cache()
    return r


def _tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)


def tiny_family_ggufs(work: str) -> dict:
    """Tiny GGUFs of the five family archs, written from seeds by the
    port's GGUFWriter with the trained tiny pair's tokenizer: deepseek2
    (Lite layout, YaRN keys, 4 experts; the CLI serves it through Engine,
    the decoder's latent attention), and the four the CLI sends to the
    family runtimes: minicpm3 (a q LoRA, LongRoPE factors, rope_orig_ctx
    8), mamba, rwkv6 (rescale_every 1) and t5 (gated, untied)."""
    import numpy as np

    from prima_tpu_torch.gguf.reader import GGUFModel
    from prima_tpu_torch.gguf.writer import GGUFWriter

    tm = GGUFModel.open(os.path.join(ROOT, TINY))
    tok_kv = {k: v for k, v in tm.metadata.items() if k.startswith("tokenizer.")}
    tm.close()
    nv = len(tok_kv["tokenizer.ggml.tokens"])
    os.makedirs(work, exist_ok=True)
    out = {}

    def write(arch: str, kv: dict, tensors: dict) -> None:
        path = os.path.join(work, f"{arch}.gguf")
        w = GGUFWriter(path, arch=arch)
        for k, v in kv.items():
            w.add_kv(f"{arch}.{k}", v)
        for k, v in tok_kv.items():
            w.add_kv(k, v)
        for k, v in tensors.items():
            w.add_tensor(k, np.ascontiguousarray(v, np.float32))
        w.write()
        out[arch] = path

    d = HostDraw(71)
    nrm = lambda *s: d.normal(*s, std=0.3)
    ones = lambda n: d.normal(n, std=0.05, mean=1.0)
    e = 32
    # deepseek2 and minicpm3: MLA with 4 heads, qk 8 + 8, v 8, kv rank 16
    for arch in ("deepseek2", "minicpm3"):
        kv = {"block_count": 2, "embedding_length": e, "attention.head_count": 4,
              "attention.head_count_kv": 4, "attention.key_length": 16,
              "attention.value_length": 8, "attention.kv_lora_rank": 16,
              "feed_forward_length": 48, "context_length": 64, "vocab_size": nv,
              "attention.layer_norm_rms_epsilon": 1e-6, "rope.dimension_count": 8,
              "rope.freq_base": 10000.0}
        t = {"token_embd.weight": nrm(nv, e), "output_norm.weight": ones(e),
             "output.weight": nrm(nv, e)}
        if arch == "deepseek2":
            kv.update({"leading_dense_block_count": 1, "expert_count": 4, "expert_used_count": 2,
                       "expert_shared_count": 1, "expert_weights_scale": 1.0,
                       "rope.scaling.type": "yarn", "rope.scaling.factor": 4.0,
                       "rope.scaling.original_context_length": 16,
                       "rope.scaling.yarn_log_multiplier": 0.0707})
        else:
            kv.update({"attention.q_lora_rank": 16,
                       "rope.scaling.original_context_length": 8})
            t.update({"rope_factors_long.weight": d.uniform(4, lo=1.0, hi=4.0),
                      "rope_factors_short.weight": d.uniform(4, lo=0.8, hi=1.2)})
        for i in range(2):
            p = f"blk.{i}."
            t.update({p + "attn_norm.weight": ones(e), p + "attn_kv_a_mqa.weight": nrm(24, e),
                      p + "attn_kv_a_norm.weight": ones(16), p + "attn_kv_b.weight": nrm(64, 16),
                      p + "attn_output.weight": nrm(e, 32), p + "ffn_norm.weight": ones(e)})
            if arch == "minicpm3":
                t.update({p + "attn_q_a.weight": nrm(16, e), p + "attn_q_a_norm.weight": ones(16),
                          p + "attn_q_b.weight": nrm(64, 16)})
            else:
                t[p + "attn_q.weight"] = nrm(64, e)
            if arch == "minicpm3" or i == 0:
                t.update({p + "ffn_gate.weight": nrm(48, e), p + "ffn_up.weight": nrm(48, e),
                          p + "ffn_down.weight": nrm(e, 48)})
            else:
                t.update({p + "ffn_gate_inp.weight": nrm(4, e),
                          p + "ffn_gate_exps.weight": nrm(4, 16, e),
                          p + "ffn_up_exps.weight": nrm(4, 16, e),
                          p + "ffn_down_exps.weight": nrm(4, e, 16),
                          p + "ffn_gate_shexp.weight": nrm(16, e),
                          p + "ffn_up_shexp.weight": nrm(16, e),
                          p + "ffn_down_shexp.weight": nrm(e, 16)})
        write(arch, kv, t)
    # mamba: d_inner 64, d_state 8, dt_rank 4; tied
    t = {"token_embd.weight": nrm(nv, e), "output_norm.weight": ones(e)}
    for i in range(2):
        p = f"blk.{i}."
        t.update({p + "attn_norm.weight": ones(e), p + "ssm_in.weight": nrm(128, e),
                  p + "ssm_conv1d.weight": nrm(64, 4), p + "ssm_conv1d.bias": nrm(64),
                  p + "ssm_x.weight": nrm(20, 64), p + "ssm_dt.weight": nrm(64, 4),
                  p + "ssm_dt.bias": d.uniform(64, lo=-4.0, hi=-2.0),
                  p + "ssm_a": -np.tile(np.arange(1, 9, dtype=np.float32), (64, 1)),
                  p + "ssm_d": np.ones(64, np.float32), p + "ssm_out.weight": nrm(e, 64)})
    write("mamba", {"block_count": 2, "embedding_length": e, "ssm.inner_size": 64,
                    "ssm.conv_kernel": 4, "ssm.state_size": 8, "ssm.time_step_rank": 4,
                    "context_length": 64, "vocab_size": nv,
                    "attention.layer_norm_rms_epsilon": 1e-5}, t)
    # rwkv6: 4 heads of 8
    t = {"token_embd.weight": nrm(nv, e), "output.weight": nrm(nv, e)}
    for nm in ("token_embd_norm", "output_norm"):
        t.update({nm + ".weight": ones(e), nm + ".bias": d.normal(e, std=0.05)})
    for i in range(2):
        p = f"blk.{i}."
        for nm in ("attn_norm", "attn_norm_2", "time_mix_ln"):
            t.update({p + nm + ".weight": ones(e), p + nm + ".bias": d.normal(e, std=0.05)})
        for nm in ("time_mix_lerp_x", "time_mix_lerp_w", "time_mix_lerp_k", "time_mix_lerp_v",
                   "time_mix_lerp_r", "time_mix_lerp_g", "channel_mix_lerp_k",
                   "channel_mix_lerp_r"):
            t[p + nm + ".weight"] = d.normal(1, 1, e, std=0.05, mean=0.5)
        t.update({p + "time_mix_w1.weight": nrm(5 * 8, e), p + "time_mix_w2.weight": nrm(5, e, 8),
                  p + "time_mix_first.weight": nrm(4, 8),
                  p + "time_mix_decay.weight": d.normal(e, std=0.05, mean=0.5),
                  p + "time_mix_decay_w1.weight": nrm(12, e),
                  p + "time_mix_decay_w2.weight": nrm(e, 12),
                  p + "channel_mix_key.weight": nrm(48, e),
                  p + "channel_mix_value.weight": nrm(e, 48),
                  p + "channel_mix_receptance.weight": nrm(e, e)})
        for nm in ("key", "value", "receptance", "gate", "output"):
            t[p + f"time_mix_{nm}.weight"] = nrm(e, e)
    write("rwkv6", {"block_count": 2, "embedding_length": e, "wkv.head_size": 8,
                    "feed_forward_length": 48, "context_length": 1024, "vocab_size": nv,
                    "attention.layer_norm_epsilon": 1e-5, "rescale_every_n_layers": 1,
                    "time_mix_extra_dim": 8, "time_decay_extra_dim": 12}, t)
    # t5: 4 heads of 8, gated-GELU, untied, 8 buckets
    t = {"token_embd.weight": nrm(nv, e), "output.weight": nrm(nv, e),
         "enc.output_norm.weight": ones(e), "dec.output_norm.weight": ones(e)}
    for stack in ("enc", "dec"):
        for i in range(2):
            p = f"{stack}.blk.{i}."
            t.update({p + "attn_norm.weight": ones(e), p + "ffn_norm.weight": ones(e),
                      p + "ffn_up.weight": nrm(48, e), p + "ffn_gate.weight": nrm(48, e),
                      p + "ffn_down.weight": nrm(e, 48)})
            for nm in ("q", "k", "v", "o"):
                t[p + f"attn_{nm}.weight"] = nrm(e, e)
            if i == 0:
                t[p + "attn_rel_b.weight"] = nrm(8, 4)
            if stack == "dec":
                t[p + "cross_attn_norm.weight"] = ones(e)
                for nm in ("q", "k", "v", "o"):
                    t[p + f"cross_attn_{nm}.weight"] = nrm(e, e)
    write("t5", {"block_count": 2, "encoder_block_count": 2, "embedding_length": e,
                 "attention.head_count": 4, "attention.key_length": 8, "feed_forward_length": 48,
                 "vocab_size": nv, "attention.layer_norm_rms_epsilon": 1e-6,
                 "attention.relative_buckets_count": 8, "decoder_start_token_id": 0}, t)
    return out


def family_cli(work: str) -> dict:
    """python -m prima_tpu_torch.tools.cli on each tiny family GGUF
    (deepseek2 through Engine, the others through their family runtimes):
    on the card, then --device cpu, equal exit codes and stdout, no hand
    kernel launched (the tiny weights are f32: no GEMV kernel); mamba
    greedy and sampled (--temp 0.8 -s 42). The CLI streams Engine's text
    a whole UTF-8 character at a time, so random tokens may print nothing:
    for deepseek2 the token ids its engine streamed are compared too, all
    the tokens asked for, by `bf16_streams_agree`."""
    from prima_tpu_torch.runtime.engine import Engine
    from prima_tpu_torch.tools import cli

    def engine_call(args: list) -> tuple:
        streamed, real = [], Engine.step_fused

        def step_fused(self, *a, **kw):
            events = real(self, *a, **kw)
            streamed.extend(ev.token for ev in events if ev.token is not None)
            return events

        Engine.step_fused = step_fused
        try:
            return tool_call(cli.main, args) + (streamed,)
        finally:
            Engine.step_fused = real

    res = {}
    runs = [(arch, ["--temp", "0"]) for arch in ("deepseek2", "minicpm3", "mamba", "rwkv6", "t5")]
    runs.append(("mamba", ["--temp", "0.8", "-s", "42"]))
    files = tiny_family_ggufs(work)
    for arch, extra in runs:
        args = ["-m", files[arch], "-p", "Once upon a time", "-n", "12"] + extra
        call = engine_call if arch == "deepseek2" else lambda a: tool_call(cli.main, a)
        counters = zero_counts()
        card = call(args)
        launches = read_counts(counters)
        cpu = call(args + ["--device", "cpu"])
        key = arch + ("_sampled" if "-s" in extra else "")
        res[key] = {"rc": card[0], "text": card[1], "equal": card[:2] == cpu[:2],
                    "launches": launches}
        if arch == "deepseek2":
            res[key].update(tokens=card[3], cpu_tokens=cpu[3])
        if arch == "deepseek2":
            res[key].update(bf16_streams_agree(files[arch], args[3], card[3], cpu[3]))
        if card[:2] != cpu[:2] or card[0] != 0 or launches \
                or not card[1].startswith("Once upon a time") \
                or (arch == "deepseek2" and not res[key]["streams_agree"]):
            raise AssertionError(f"CLI on {key}: card {card[:2]} against CPU {cpu[:2]}, "
                                 f"tokens {card[3:]} against {cpu[3:]}, "
                                 f"launches {launches}, stderr {card[2][-1000:]}")
    return res


# two greedy bf16 streams may part only where the f32 reference's logits of
# their two tokens lie within this share of its max |logit|: a tie at bf16
BF16_TIE = 0.05


def bf16_streams_agree(path: str, prompt: str, card: list, cpu: list) -> dict:
    """The card's and the CPU's greedy token ids (bf16, the CLI's Engine)
    against each other, 12 each: equal, or equal up to a step where the
    f32 recompute runtime's logits over the card's stream (teacher-forced)
    give their two tokens within BF16_TIE of max |logit|; the streams part
    there, so the rest is not compared."""
    import numpy as np
    import torch

    from prima_tpu_torch.models import deepseek2 as ds

    r: dict = {"streams_agree": len(card) == len(cpu) == 12, "parted_at": None}
    if not r["streams_agree"] or card == cpu:
        return r
    rt = ds.DeepseekV2Runtime.load(path, device="cpu")
    ids = rt.tokenizer.encode(prompt, add_special=True, parse_special=True)
    with torch.no_grad():
        rows = ds.deepseek2_forward(rt.params, rt.cfg, [ids + card[:-1]])[0][len(ids) - 1:]
    i = next(j for j, (a, b) in enumerate(zip(card, cpu)) if a != b)
    row = rows[i].float().numpy()
    gap = float(abs(row[card[i]] - row[cpu[i]]) / np.abs(row).max())
    r.update(parted_at=i, gap_of_max_logit=gap, streams_agree=gap <= BF16_TIE)
    return r


def phase_families(dev, report: dict) -> None:
    """The four dense family runtimes at full width, then the five archs'
    tiny GGUFs through the CLI (deepseek2's through Engine), card against
    CPU. No hand kernel may launch (the reference's runtimes reach no
    Pallas kernel)."""
    import torch

    r: dict = {}
    for i, (name, dtype) in enumerate((("deepseek2", torch.bfloat16), ("mamba", torch.float32),
                                       ("rwkv6", torch.float32), ("t5", torch.float32))):
        t0 = time.time()
        check = family_card_vs_cpu(name, dev, seed=80 + 10 * i)
        full = family_full(name, dev, dtype, seed=85 + 10 * i)
        r[name] = {"card_vs_cpu": check, "full": full, "seconds": time.time() - t0}
        log(f"families {name}: card vs CPU at {check['layers']} layers "
            f"{check['max_rel_logit_err']:.2e} over {check['steps']} steps "
            f"({check['top5_steps_tied']} tied); {full['layers']} layers {full['dtype']} "
            f"{full['weight_gib']:.2f} GiB: prefill {full['prefill_ms']:.1f} ms, "
            f"{full['wall_ms_a_token']:.1f} ms wall / {full['device_ms_a_token']:.2f} ms device a "
            f"token, idle {full['device_idle_share']:.3f}, peak {full['peak_gib']:.2f} GiB"
            + (f", decode vs full {full['decode_vs_full']['max_rel_logit_err']:.2e}"
               if "decode_vs_full" in full else "")
            + f"; check: host weights {check['host_weights_s']:.1f} s, card "
            f"{check['card_s']:.1f} s, CPU {check['cpu_s']:.1f} s; weights "
            f"{full['weights_s']:.1f} s; {r[name]['seconds']:.1f} s")
    t0 = time.time()
    r["cli"] = family_cli(os.path.join(ROOT, "build", "chip_smoke", "families"))
    log(f"families cli: {sorted(r['cli'])} card = CPU, no launches; {time.time() - t0:.1f} s")
    report["families"] = r
    for name in ("qgemv", "qgemv_indexed", "kv_write", "kv_store", "flash_decode",
                 "flash_prefill", "hbm_probe"):
        report[name]["families_launches"] = 0


# -- phase mesh: the (dp, pp, sp, tp) mesh over torch.distributed -------------------------

MESH_SEED = 13
MESH_PROMPT, MESH_NEW = 128, 32
MESH_WORK = os.path.join(ROOT, "build", "chip_smoke", "mesh")


def mesh_plan(shape: dict, n_layers: int, dtype, k: int = 1, microbatches=None,
              n_resident=None):
    """A mesh of ranks on this card over the 8B shape cut to n_layers, each
    rank drawing its own windows' Q4_K layers on the card from generators
    seeded by (MESH_SEED, layer)."""
    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.config import tiny_config
    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.parallel.launch import RankPlan, init_multihost

    cfg = tiny_config(**dict(LLAMA3_8B, n_layers=n_layers))
    return RankPlan(shape, init_multihost()[0], ("synth_seeded", cfg, GGMLType.Q4_K, MESH_SEED),
                    k_cycles=k, microbatches=microbatches, opts=ForwardOptions(dtype=dtype),
                    device="cuda", n_resident=n_resident, timeout=300.0)


def mesh_prompts(n: int, length: int, vocab: int, seed: int = MESH_SEED) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length).tolist() for _ in range(n)]


def mesh_serve4(eng, prompts: list) -> list:
    """The prompts at once through submit + step_fused(max_chunk=8)."""
    slots = [eng.submit(p, n_predict=MESH_NEW, request_id=i, reuse_prefix=False)
             for i, p in enumerate(prompts)]
    while any(s.state.name != "IDLE" for s in slots):
        eng.step_fused(max_chunk=8)
    return [list(s.generated) for s in slots]


def cuda_busy_ms(prof) -> float:
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def mesh_main_rank0() -> dict:
    """Rank 0 of the world-4 mesh (pp 2 x tp 2, k = 2, 2 microbatches of
    2 rows) at the 8B shape in f32 with f32 caches: 4 requests of 128
    prompt tokens and 32 greedy tokens, three times: counted and recorded
    (every decode step's logits), timed, and profiled on rank 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from prima_tpu_torch.parallel.engine import DistributedEngine
    from prima_tpu_torch.parallel.launch import build_rank, spawn_ranks, stop_ranks, worker_main

    plan = mesh_plan({"dp": 1, "pp": 2, "sp": 1, "tp": 2}, 32, torch.float32, k=2,
                     microbatches=2)
    t0 = time.time()
    procs = spawn_ranks(worker_main, plan, range(1, plan.world))
    mesh = eng = None
    try:
        mesh, cfg, spec, params, _ = build_rank(plan, 0)
        eng = DistributedEngine(cfg, params, spec, mesh, batch_per_micro=2, max_seq=512,
                                n_batch=128, opts=plan.opts, kv_dtype=torch.float32)
        eng.run_to_completion([1, 2, 3], n_predict=2)  # every rank's first launches
        up_s = time.time() - t0
        prompts = mesh_prompts(4, MESH_PROMPT, cfg.n_vocab)
        eng.kernel_launches(reset=True)
        eng.mesh_stats(reset=True)
        rec, run = [], eng._run

        def capture(cmd):
            out = run(cmd)
            if cmd[0] == "pass" and cmd[5] and cmd[1].shape[-1] == 1:
                rec.append(out[:, :, -1].reshape(eng.n_slots, -1).float().cpu().numpy())
            return out

        eng._run = capture
        streams = mesh_serve4(eng, prompts)
        eng._run = run
        launches = eng.kernel_launches(reset=True)
        stats = eng.mesh_stats(reset=True)
        for key in eng.perf:
            eng.perf[key] = 0
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        timed = mesh_serve4(eng, prompts)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3
        perf = dict(eng.perf)
        timed_stats = eng.mesh_stats(reset=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mesh_serve4(eng, prompts)
            torch.cuda.synchronize()
        busy = cuda_busy_ms(prof)
        eng.stop()
        return {"world": plan.world, "transport": mesh.transport, "up_s": up_s,
                "prompts": prompts, "streams": streams, "timed_streams_equal": timed == streams,
                "logits": rec, "launches": launches, "stats": stats,
                "timed_stats": timed_stats, "perf": perf, "wall_ms": wall,
                "rank0_busy_ms": busy, "rank0_idle_share": 1 - busy / wall}
    finally:
        if mesh is not None:
            mesh.close()
        stop_ranks(procs)


def mesh_sp_rank(plan, rank: int, prompt: list, dec: list):
    """One rank of the sp = 2 mesh (2 layers at the 8B width, f32): the
    prompt in one prefill pass into caches of 4096 cells in blocks of 2048,
    then a decode pass for each token of `dec`; rank 0 returns the decode
    logits."""
    import numpy as np
    import torch

    from prima_tpu_torch.parallel.engine import PipeRank
    from prima_tpu_torch.parallel.launch import build_rank

    mesh, cfg, spec, params, _ = build_rank(plan, rank)
    try:
        r = PipeRank(cfg, params, spec, mesh, 1, 4096, plan.opts, torch.float32)
        s = len(prompt)
        pos = np.arange(s, dtype=np.int32)[None, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.execute(("pass", np.asarray([[prompt]]), pos, np.zeros((1, 1), np.int32), pos, False))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        logits = []
        for i, tok in enumerate(dec):
            p = np.full((1, 1, 1), s + i, np.int32)
            out = r.execute(("pass", np.asarray([[[tok]]]), p, p[..., 0], p, True))
            if rank == 0:
                logits.append(out[0, 0, -1].float().cpu().numpy())
        stats = mesh.gather_obj0(r.stats())
        return None if rank else {"logits": logits, "prefill_s": prefill_s, "stats": stats}
    finally:
        mesh.close()


def mesh_stream_rank(plan, rank: int, batches: list):
    """One rank of the pp = 2, k = 2 pipe in bf16 over `batches`, resident
    or streaming the first W - n_resident layers of each window; rank 0
    returns the logits and every rank's memory against its bound."""
    import torch

    from prima_tpu_torch.parallel.engine import PipeRank
    from prima_tpu_torch.parallel.launch import build_rank
    from prima_tpu_torch.runtime.streaming import layer_nbytes

    mesh, cfg, spec, params, streamer = build_rank(plan, rank)
    try:
        r = PipeRank(cfg, params, spec, mesh, 2, 256, plan.opts, torch.bfloat16, streamer)
        dev = mesh.device
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        layer = next(l for l in params["layers"] if l is not None)
        layer_bytes = layer_nbytes(layer)
        held = sum(1 for l in params["layers"] if l is not None)
        torch.cuda.reset_peak_memory_stats(dev)
        up0 = streamer.uploads.bytes if streamer is not None else 0
        outs, times = [], []
        for tokens, positions, cache_pos in batches:
            t0 = time.perf_counter()
            out = r.execute(("pass", tokens, positions, cache_pos, positions, True))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if rank == 0:
                outs.append(out.float().cpu().numpy())
        w, k = spec.window, spec.k_cycles
        n_res = w if plan.n_resident is None else plan.n_resident
        mine = {"rank": rank, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                "after_build_gib": base / 2 ** 30, "layer_mib": layer_bytes / 2 ** 20,
                "resident_layers_after_build": held,
                "bound_layers": k * n_res + 2 * (w - n_res) if n_res < w else k * w,
                "streamed_bytes_a_pass": ((streamer.uploads.bytes - up0) / len(batches)
                                          if streamer is not None else 0),
                "pass_ms": [t * 1e3 for t in times]}
        ranks = mesh.gather_obj0(mine)
        return None if rank else {"logits": outs, "ranks": ranks}
    finally:
        mesh.close()


def mesh_case(case: str, out_path: str) -> int:
    """A mesh case's rank 0, run as a process of its own (this script with
    --mesh-case): it spawns the other ranks and pickles its result."""
    import pickle

    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from prima_tpu_torch.parallel.launch import spawn_ranks, stop_ranks

    if case == "main":
        out = mesh_main_rank0()
    elif case == "sp":
        plan = mesh_plan({"dp": 1, "pp": 1, "sp": 2, "tp": 1}, 2, torch.float32)
        prompt = mesh_prompts(1, 4000, LLAMA3_8B["n_vocab"], MESH_SEED + 1)[0]
        dec = mesh_prompts(1, 2, LLAMA3_8B["n_vocab"], MESH_SEED + 2)[0]
        procs = spawn_ranks(mesh_sp_rank, plan, [1], prompt, dec)
        try:
            out = dict(mesh_sp_rank(plan, 0, prompt, dec), prompt=prompt, dec=dec)
        finally:
            stop_ranks(procs)
    elif case == "stream":
        rng = np.random.default_rng(MESH_SEED + 3)
        M, B, S = 2, 2, 64
        batches = [(rng.integers(0, LLAMA3_8B["n_vocab"], (M, B, S)),
                    np.broadcast_to(np.arange(S, dtype=np.int32), (M, B, S)).copy(),
                    np.zeros((M, B), np.int32))]
        for i in range(4):
            p = np.full((M, B, 1), S + i, np.int32)
            batches.append((rng.integers(0, LLAMA3_8B["n_vocab"], (M, B, 1)), p, p[..., 0]))
        out = {}
        for name, n_res in (("resident", None), ("streamed", 4)):
            plan = mesh_plan({"dp": 1, "pp": 2, "sp": 1, "tp": 1}, 32, torch.bfloat16, k=2,
                             microbatches=2, n_resident=n_res)
            procs = spawn_ranks(mesh_stream_rank, plan, [1], batches)
            try:
                out[name] = mesh_stream_rank(plan, 0, batches)
            finally:
                stop_ranks(procs)
    else:
        raise ValueError(f"unknown mesh case {case!r}")
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def run_mesh_case(case: str, timeout: float = 600) -> dict:
    import pickle

    os.makedirs(MESH_WORK, exist_ok=True)
    out = os.path.join(MESH_WORK, f"{case}.pkl")
    logf = os.path.join(MESH_WORK, f"{case}.log")
    with open(logf, "w") as lf:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--mesh-case", case,
                             "--mesh-out", out], cwd=ROOT, stdout=lf, stderr=subprocess.STDOUT,
                            timeout=timeout).returncode
    text = open(logf).read()
    for line in text.splitlines():
        if line.startswith("mesh "):
            log(f"  {case}: {line}")
    if rc != 0:
        raise AssertionError(f"mesh case {case} exited {rc}:\n{text[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


def tied_steps(got, want) -> tuple[bool, int]:
    """Argmax equal at every (step, row), where a step whose top two lie
    within twice the runs' difference counts as tied: (ok, ties)."""
    import numpy as np

    ties, ok = 0, True
    for g, w in zip(got, want):
        diff = float(np.abs(g - w).max())
        for gr, wr in zip(g, w):
            if gr.argmax() == wr.argmax():
                continue
            top = np.sort(wr)[-2:]
            if top[1] - top[0] <= 2 * diff:
                ties += 1
            else:
                ok = False
    return ok, ties


def mesh_reference(dev, prompts: list) -> tuple[list, list, float]:
    """The one-process Engine (4 slots, kernels, f32) over the mesh's
    seeded weights: streams, every decode step's logits, seconds."""
    import torch

    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.config import tiny_config
    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.parallel.pipeline import synth_params_seeded
    from prima_tpu_torch.runtime.engine import Engine

    t0 = time.time()
    cfg = tiny_config(**LLAMA3_8B)
    params = synth_params_seeded(cfg, GGMLType.Q4_K, MESH_SEED, dev)
    eng = Engine(cfg, params, n_slots=4, max_seq=512, n_batch=128,
                 opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32, device=dev)
    rec, raw = [], eng._decode_raw

    def capture(*a):
        logits, caches = raw(*a)
        rec.append(logits.float().cpu().numpy())
        return logits, caches

    eng._decode_raw = capture
    eng._fused_gen.fwd = capture
    streams = mesh_serve4(eng, prompts)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return streams, rec, time.time() - t0


def mesh_sp_reference(dev, prompt: list, dec: list) -> list:
    """The one-process forward over the same 2 layers: the prompt, then
    the decode tokens, the decode logits."""
    import torch

    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.config import tiny_config
    from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
    from prima_tpu_torch.parallel.pipeline import synth_params_seeded

    cfg = tiny_config(**dict(LLAMA3_8B, n_layers=2))
    params = synth_params_seeded(cfg, GGMLType.Q4_K, MESH_SEED, dev)
    opts = ForwardOptions(dtype=torch.float32)
    kv = init_kv_caches(cfg, 1, 4096, torch.float32, dev)
    t = lambda a, dt=torch.int32: torch.as_tensor(a, dtype=dt, device=dev)
    s = len(prompt)
    with torch.no_grad():
        forward(params, cfg, t([prompt], torch.int64), t([list(range(s))]), kv, t([0]), opts,
                return_hidden=True)
        out = []
        for i, tok in enumerate(dec):
            lg, _ = forward(params, cfg, t([[tok]], torch.int64), t([[s + i]]), kv,
                            t([s + i]), opts)
            out.append(lg[0, -1].float().cpu().numpy())
    del params, kv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_server(report: dict) -> None:
    """The tiny pair's f32 server at --pp 2 --tp 2 (four ranks on this
    card) against the single-device server; --lora over a mesh exits 1."""
    flags = ["--dtype", "f32", "-ctk", "f32", "-np", "4", "-c", "256", "-b", "64"]
    bodies = [{"prompt": p, "n_predict": 16, "temperature": 0}
              for p in ("Once upon a time", "The quick brown fox", "def main():",
                        "import numpy as np")]
    texts = {}

    def serve(name: str, extra: list) -> None:
        proc, port, out, up = _start_server(flags + extra)
        try:
            texts[name] = _texts(port, bodies, concurrent=True)
            if name == "mesh":
                props = _get(port, "/props")
                report["server_launches_by_rank"] = props.get("kernel_launches_by_rank")
                report["server_transport"] = next((l.strip() for l in out
                                                   if l.startswith("mesh ")), None)
        finally:
            _stop(proc)
        report[f"server_{name}_up_s"] = up

    with concurrent.futures.ThreadPoolExecutor(2) as ex:  # independent processes
        runs = [ex.submit(serve, "single", []), ex.submit(serve, "mesh", ["--pp", "2", "--tp", "2"])]
        for f in runs:
            f.result()
    report["server_texts_equal"] = texts["mesh"] == texts["single"]
    rc = subprocess.run([sys.executable, "-m", "prima_tpu_torch.server", "-m", TINY, "--pp",
                         "2", "--tp", "2", "--lora", "x.gguf"], cwd=ROOT, capture_output=True,
                        text=True, timeout=120)
    report["lora_refused"] = rc.returncode == 1 and "--lora" in rc.stderr
    log(f"mesh server --pp 2 --tp 2 (tiny pair, f32): texts equal the single-device server's "
        f"{report['server_texts_equal']}, launches by rank {report['server_launches_by_rank']}; "
        f"--lora exits 1: {report['lora_refused']}")
    if not (report["server_texts_equal"] and report["lora_refused"]):
        raise AssertionError(f"mesh server: {texts}, lora rc {rc.returncode} {rc.stderr[-500:]}")


def phase_mesh(dev, report: dict) -> dict:
    """The mesh plane on this card. Returns the main run's launches of
    qgemv and kv_store, summed over its ranks."""
    import numpy as np

    r: dict = {}
    t0 = time.time()
    m = run_mesh_case("main")
    r["main_s"] = time.time() - t0
    ref_streams, ref_logits, r["reference_s"] = mesh_reference(dev, m["prompts"])
    got = m.pop("logits")
    errs = [float(np.abs(g - w).max()) for g, w in zip(got, ref_logits)]
    scale = max(float(np.abs(w).max()) for w in ref_logits)
    ok, ties = tied_steps(got, ref_logits)
    launches = m["launches"]
    per_rank = [{k: v for k, v in b.items() if v} for b in launches["by_rank"]]
    stats = m["timed_stats"]
    hop = [s["mesh"]["hop"] for s in stats]
    ar = [s["mesh"]["all_reduce"] for s in stats]
    perf = m["perf"]
    r["main"] = {
        "world": m["world"], "transport": m["transport"], "up_s": m["up_s"],
        "steps": len(got), "reference_steps": len(ref_logits),
        "max_abs_logit_err": max(errs), "max_abs_logit": scale,
        "rel_err": max(errs) / scale, "tolerance": f"max|err| <= {LOGITS_TOL} * max|logit|",
        "argmax_equal": ok, "tied_steps": ties, "streams_equal": m["streams"] == ref_streams,
        "timed_streams_equal": m["timed_streams_equal"], "launches_by_rank": per_rank,
        "prefill_tok_s": perf["n_prompt"] / perf["t_prompt_s"],
        "decode_tok_s": perf["n_decode"] / perf["t_decode_s"], "perf": perf,
        "wall_ms": m["wall_ms"], "rank0_idle_share": m["rank0_idle_share"],
        "rank0_busy_ms": m["rank0_busy_ms"],
        "hop_ms_by_rank": [h[1] * 1e3 for h in hop], "hops_by_rank": [h[0] for h in hop],
        "hop_bytes_each": [s["hop_bytes"] / max(s["hops"], 1) for s in stats],
        "all_reduce_ms_by_rank": [a[1] * 1e3 for a in ar],
        "all_reduces_by_rank": [a[0] for a in ar],
        "broadcast_ms_by_rank": [s["mesh"]["broadcast"][1] * 1e3 for s in stats],
        "gather_ms_by_rank": [s["mesh"]["gather"][1] * 1e3 for s in stats],
        "peak_gib_by_rank": [s["peak_bytes"] / 2 ** 30 for s in m["stats"]],
    }
    mm = r["main"]
    log(f"mesh main: world {mm['world']} ({mm['transport']}) pp 2 x tp 2, k 2, 8B Q4_K f32: "
        f"{mm['steps']} decode steps, logits max |err| {mm['max_abs_logit_err']:.3e} of "
        f"{scale:.3e} ({mm['rel_err']:.2e}), argmax equal {ok} ({ties} tied), streams equal "
        f"{mm['streams_equal']}; prefill {mm['prefill_tok_s']:.1f} tok/s, decode "
        f"{mm['decode_tok_s']:.1f} tok/s; rank 0 idle {mm['rank0_idle_share']:.3f}; hop ms "
        f"{[round(x, 1) for x in mm['hop_ms_by_rank']]} ({mm['hops_by_rank']} hops of "
        f"{[int(b) for b in mm['hop_bytes_each']]} B), all-reduce ms "
        f"{[round(x, 1) for x in mm['all_reduce_ms_by_rank']]} ({mm['all_reduces_by_rank']}); "
        f"peak GiB {[round(x, 2) for x in mm['peak_gib_by_rank']]}; launches {per_rank}")
    if not (mm["rel_err"] <= LOGITS_TOL and ok and mm["streams_equal"]
            and mm["steps"] == mm["reference_steps"] == MESH_NEW and mm["timed_streams_equal"]):
        raise AssertionError("mesh main: the mesh disagrees with the one-process engine")
    if not all(b.get("qgemv", 0) > 0 and b.get("kv_store", 0) > 0 for b in per_rank):
        raise AssertionError(f"mesh main: a rank launched no qgemv / kv_store: {per_rank}")

    t0 = time.time()
    sp = run_mesh_case("sp")
    want = mesh_sp_reference(dev, sp["prompt"], sp["dec"])
    errs = [float(np.abs(g - w).max()) for g, w in zip(sp["logits"], want)]
    scale = max(float(np.abs(w).max()) for w in want)
    ok, ties = tied_steps([g[None] for g in sp["logits"]], [w[None] for w in want])
    r["sp"] = {"prompt_tokens": len(sp["prompt"]), "rel_err": max(errs) / scale,
               "argmax_equal": ok, "tied": ties, "prefill_s": sp["prefill_s"],
               "all_reduces_by_rank": [s["mesh"]["all_reduce"][0] for s in sp["stats"]],
               "all_reduce_ms_by_rank": [s["mesh"]["all_reduce"][1] * 1e3 for s in sp["stats"]],
               "seconds": time.time() - t0}
    log(f"mesh sp = 2 (8B width, 2 layers, {len(sp['prompt'])}-token prompt, caches of 4096 in "
        f"blocks of 2048): decode logits rel err {r['sp']['rel_err']:.2e}, argmax equal {ok}; "
        f"prefill {sp['prefill_s']:.2f} s; {r['sp']['seconds']:.1f} s")
    if not (r["sp"]["rel_err"] <= LOGITS_TOL and ok):
        raise AssertionError("mesh sp: disagrees with the one-process forward")

    t0 = time.time()
    st = run_mesh_case("stream")
    equal = all(np.array_equal(a, b) for a, b in zip(st["resident"]["logits"],
                                                     st["streamed"]["logits"]))
    ranks = st["streamed"]["ranks"]
    # the streamed rank may hold what the resident one holds beside its
    # layers, plus bound_layers layers and 0.5 GiB of temporaries
    bound_ok = all(rk["peak_gib"] <= res["peak_gib"] + 0.5 + (
        rk["bound_layers"] - res["resident_layers_after_build"]) * rk["layer_mib"] / 1024
        for rk, res in zip(ranks, st["resident"]["ranks"]))
    r["stream"] = {"bit_equal": equal, "resident": st["resident"]["ranks"], "streamed": ranks,
                   "within_bound": bound_ok, "seconds": time.time() - t0}
    log(f"mesh streamed pipe (pp 2, k 2, W 8, 4 resident, bf16): logits bit for bit = resident "
        f"{equal}; streamed {[round(rk['streamed_bytes_a_pass'] / 2 ** 30, 3) for rk in ranks]} "
        f"GiB a pass; peak GiB streamed {[round(rk['peak_gib'], 2) for rk in ranks]} vs resident "
        f"{[round(rk['peak_gib'], 2) for rk in st['resident']['ranks']]} (bound "
        f"{ranks[0]['bound_layers']} of 16 layers of {ranks[0]['layer_mib']:.0f} MiB); "
        f"{r['stream']['seconds']:.1f} s")
    if not (equal and bound_ok):
        raise AssertionError("mesh streamed pipe: not equal to the resident pipe or over bound")

    t0 = time.time()
    mesh_server(r)
    r["server_s"] = time.time() - t0
    report["mesh"] = r
    total = launches["total"]
    for name in ("qgemv", "kv_store"):
        report[name]["mesh_launches"] = [b.get(name, 0) for b in launches["by_rank"]]
    return {"qgemv": total["qgemv"], "kv_store": total["kv_store"]}


# -- phase train: train_tiny_pair on autograd, card against CPU ---------------------------


def phase_train(dev, report: dict) -> None:
    """The tiny target shape (4, 256, 4, 704) for 50 steps on the card and
    on the CPU from the same init and batches: losses within 1e-4 relative
    at every step; then save_gguf into a scratch directory and 8 greedy
    tokens of the result through the port's loader, card = CPU."""
    import numpy as np
    import torch

    from prima_tpu_torch.models.llama import ForwardOptions
    from prima_tpu_torch.models.loader import load_model
    from prima_tpu_torch.runtime.engine import Engine
    from prima_tpu_torch.tools import train_tiny_pair as tool

    t_phase = time.time()
    cfg = tool.make_cfg(4, 256, 4, 704)
    data = tool.encode_bytes(tool.gather_corpus(1 << 20))
    rng = np.random.default_rng(MESH_SEED)
    offs = rng.integers(0, data.shape[0] - 129, (50, 8))
    batches = [np.stack([data[o:o + 129] for o in row]).astype(np.int64) for row in offs]
    losses, secs, trained = {}, {}, None
    card = str(dev)
    for device in (card, "cpu"):
        params = tool._map(tool.init_params(cfg, 0),
                           lambda t: t.to(device).requires_grad_(True))
        tr = tool.Trainer(params, cfg, 3e-3, 50, device)
        xs = [torch.from_numpy(b).to(device) for b in batches]
        t0 = time.perf_counter()
        out = [float(v) for v in torch.stack([tr.step(x) for x in xs]).cpu()]
        losses[device], secs[device] = out, (time.perf_counter() - t0) / len(xs)
        trained = trained or params
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[card], losses["cpu"])]
    work = os.path.join(ROOT, "build", "chip_smoke", "train")
    os.makedirs(work, exist_ok=True)
    path = tool.save_gguf(os.path.join(work, "target.gguf"), cfg, trained, "chip-smoke")
    toks = {}
    for device in (card, "cpu"):
        m = load_model(path, device=device)
        eng = Engine(m.cfg, m.params, n_slots=1, max_seq=64,
                     opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                     device=device)
        toks[device] = eng.run_to_completion(m.tokenizer.encode("def main():", add_special=True),
                                             n_predict=8)
    r = {"steps": len(batches), "max_rel_loss_diff": max(rel), "loss_first": losses[card][0],
         "loss_last": losses[card][-1], "card_s_a_step": secs[card],
         "cpu_s_a_step": secs["cpu"], "greedy_card": toks[card], "greedy_cpu": toks["cpu"],
         "seconds": time.time() - t_phase}
    report["train"] = r
    log(f"train: 50 steps of the tiny target (4, 256, 4, 704), batch 8 x 128, card vs CPU: max "
        f"rel loss diff {r['max_rel_loss_diff']:.2e} (loss {r['loss_first']:.4f} -> "
        f"{r['loss_last']:.4f}); {secs[card] * 1e3:.1f} ms a step on the card, "
        f"{secs['cpu'] * 1e3:.1f} on the CPU; save_gguf -> 8 greedy tokens card = CPU "
        f"{toks[card] == toks['cpu']}; {r['seconds']:.1f} s")
    if not (r["max_rel_loss_diff"] <= 1e-4 and toks[card] == toks["cpu"]):
        raise AssertionError("train: the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# phase 16: native — the C++ block converter and merge loops at full width
# ---------------------------------------------------------------------------

NATIVE_SEED = 14
NATIVE_MERGES = 1000  # learned from the text in ~2 s of host time
NATIVE_TEXT_CHARS = 200_000
# an f16 scale base per block, times a uniform draw in [0.5, 1.5): weights
# with a standard deviation of ~0.02 (Q4_K: d * sc * q - dmin * m with
# dmin = 7.5 d centres each row; Q6_K: d * sc * q, int8 sc, |q| <= 32,
# subnormal in f16, which the converter decodes too)
NATIVE_D = {"Q4_K": 1e-4, "Q6_K": 1.2e-5}


def repo_text() -> str:
    """The repository's own Markdown files at its root, concatenated in name
    order, cut to ~200 KB: the text both tokenizer paths encode."""
    import glob

    parts = [open(p, encoding="utf-8").read() for p in sorted(glob.glob(os.path.join(ROOT, "*.md")))]
    return "".join(parts)[:NATIVE_TEXT_CHARS]


def learn_merges(text: str, n_merges: int) -> list[tuple[str, str]]:
    """Byte-level BPE merges learned from `text`: the most frequent adjacent
    pair over its words (ties to the greater pair), merged in every word that
    holds it, with the pair counts kept up to date word by word."""
    from collections import defaultdict

    import regex

    from prima_tpu_torch.tokenizer.bpe import bytes_to_unicode

    b2u = bytes_to_unicode()
    words = Counter("".join(b2u[b] for b in w.encode("utf-8"))
                    for w in regex.findall(r" ?\w+| ?[^\s\w]+|\s+", text))
    seqs = {w: list(w) for w in words}
    pairs, where = Counter(), defaultdict(set)
    for w, n in words.items():
        for p in zip(seqs[w], seqs[w][1:]):
            pairs[p] += n
            where[p].add(w)
    merges = []
    while len(merges) < n_merges and pairs:
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        for w in where.pop(best):
            s, n = seqs[w], words[w]
            for p in zip(s, s[1:]):
                pairs[p] -= n
                if not pairs[p]:
                    del pairs[p]
            out, i = [], 0
            while i < len(s):
                if i + 1 < len(s) and (s[i], s[i + 1]) == best:
                    out.append(s[i] + s[i + 1])
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            seqs[w] = out
            for p in zip(out, out[1:]):
                pairs[p] += n
                where[p].add(w)
    return merges


def seeded_blocks(rng, t, rows: int, cols: int):
    """GGUF blocks of `t` (Q4_K or Q6_K) for a (rows, cols) tensor: random
    bytes from `rng`, each block's f16 d (and Q4_K's dmin) set to a finite
    small value."""
    import numpy as np

    size = {"Q4_K": 144, "Q6_K": 210}[t.name]
    n = rows * cols // 256
    raw = rng.bit_generator.random_raw(-(-n * size // 8)).view(np.uint8)[:n * size]
    raw = raw.reshape(n, size)
    d = (NATIVE_D[t.name] * (0.5 + rng.random(n))).astype(np.float16)
    if t.name == "Q4_K":
        raw[:, 0:2] = d.view(np.uint8).reshape(n, 2)
        raw[:, 2:4] = (d.astype(np.float32) * 7.5).astype(np.float16).view(np.uint8).reshape(n, 2)
    else:
        raw[:, 208:210] = d.view(np.uint8).reshape(n, 2)
    return raw.reshape(rows, -1)


def write_native_gguf(path: str, merges: list, n_layers: int, seed: int) -> dict:
    """A Llama-3-8B-shape GGUF (bench.py:94-98) of `n_layers` layers written
    by the port's GGUFWriter: each tensor's type from QuantPlanner at Q4_K_M
    (Q4_K, Q6_K for output and half of attn_v / ffn_down), its blocks from
    seeded_blocks, and a byte-level BPE vocabulary (the 256 byte symbols,
    the learned merges, then reserved control tokens up to 128256)."""
    import numpy as np

    from prima_tpu_torch.gguf.writer import GGUFWriter
    from prima_tpu_torch.quant.type_rules import QuantPlanner
    from prima_tpu_torch.tokenizer.bpe import bytes_to_unicode

    c = LLAMA3_8B
    e, f, v, hd = c["n_embd"], c["n_ff"], c["n_vocab"], c["head_dim"]
    nq, nkv = c["n_heads"] * hd, c["n_kv_heads"] * hd
    w = GGUFWriter(path, arch="llama")
    for key, val in {"block_count": n_layers, "embedding_length": e,
                     "attention.head_count": c["n_heads"],
                     "attention.head_count_kv": c["n_kv_heads"], "feed_forward_length": f,
                     "context_length": c["n_ctx_train"], "attention.layer_norm_rms_epsilon": 1e-5,
                     "rope.freq_base": c["rope_base"], "rope.dimension_count": c["rope_dim"],
                     "vocab_size": v}.items():
        w.add_kv(f"llama.{key}", val)
    tokens = list(bytes_to_unicode().values())
    tokens += list(dict.fromkeys(a + b for a, b in merges if a + b not in tokens))
    n_text = len(tokens)
    tokens += ["<|begin_of_text|>", "<|end_of_text|>"]
    tokens += [f"<|reserved_special_token_{i}|>" for i in range(v - len(tokens))]
    for key, val in {"model": "gpt2", "pre": "llama-bpe", "tokens": tokens,
                     "token_type": [1] * n_text + [3] * (v - n_text),
                     "merges": [f"{a} {b}" for a, b in merges],
                     "bos_token_id": n_text, "eos_token_id": n_text + 1}.items():
        w.add_kv(f"tokenizer.ggml.{key}", val)
    planner = QuantPlanner("Q4_K_M", n_layer=n_layers, n_gqa=c["n_heads"] // c["n_kv_heads"])
    rng = np.random.default_rng(seed)
    types = Counter()

    def quant(name: str, rows: int, cols: int) -> None:
        t = planner.get_type(name, (rows, cols))
        w.add_tensor(name, seeded_blocks(rng, t, rows, cols), ne=(cols, rows), ggml_type=t)
        types[t.name] += 1

    quant("token_embd.weight", v, e)
    for i in range(n_layers):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", np.ones(e, np.float32))
        for name, rows in (("attn_q", nq), ("attn_k", nkv), ("attn_v", nkv), ("attn_output", e)):
            quant(p + name + ".weight", rows, e if name != "attn_output" else nq)
        w.add_tensor(p + "ffn_norm.weight", np.ones(e, np.float32))
        quant(p + "ffn_gate.weight", f, e)
        quant(p + "ffn_up.weight", f, e)
        quant(p + "ffn_down.weight", e, f)
    w.add_tensor("output_norm.weight", np.ones(e, np.float32))
    quant("output.weight", v, e)
    w.write()
    if set(types) != {"Q4_K", "Q6_K"}:
        raise AssertionError(f"native: the Q4_K_M planner gave {dict(types)}")
    return {"types": dict(types), "quantized": sum(types.values()),
            "bytes": os.path.getsize(path), "text_tokens": n_text}


def write_spm_vocab(path: str, merges: list, text: str) -> None:
    """An SPM (llama-model) vocabulary: <unk> <s> </s>, the 256 byte tokens,
    each character of `text`, then each merge that decodes to text, scored
    by its rank (the earliest merge scores highest)."""
    from prima_tpu_torch.gguf.writer import GGUFWriter
    from prima_tpu_torch.tokenizer.bpe import bytes_to_unicode

    u2b = {u: b for b, u in bytes_to_unicode().items()}
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types, scores = [2, 3, 3] + [6] * 256, [0.0] * len(tokens)
    chars = sorted(set(text.replace(" ", "▁")))
    tokens += chars
    types += [1] * len(chars)
    scores += [-1e6] * len(chars)
    seen = set(tokens)
    for rank, (a, b) in enumerate(merges):
        try:
            piece = bytes(u2b[ch] for ch in a + b).decode("utf-8").replace(" ", "▁")
        except UnicodeDecodeError:
            continue  # a merge inside a multibyte character
        if piece not in seen:
            seen.add(piece)
            tokens.append(piece)
            types.append(1)
            scores.append(-float(rank))
    w = GGUFWriter(path, arch="llama")
    for key, val in {"model": "llama", "tokens": tokens, "scores": scores,
                     "token_type": types}.items():
        w.add_kv(f"tokenizer.ggml.{key}", val)
    w.write()


@contextlib.contextmanager
def timed_calls(acc: dict, patches: list):
    """Inside the block, each (module or class, function name, key) of
    `patches` adds its calls' seconds to acc[key]. Under the key "h2d" (the
    patched torch.Tensor.to) only a copy from the host to the card counts,
    and the card is synchronized first, so the copy is inside the time."""
    import torch

    saved = [(owner, name, getattr(owner, name), name in vars(owner))
             for owner, name, _ in patches]

    def wrap(fn, key):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if key == "h2d":
                if a[0].device.type != "cpu" or out.device.type == "cpu":
                    return out
                torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
            return out
        return timed

    for (owner, name, key), (_, _, fn, _) in zip(patches, saved):
        setattr(owner, name, wrap(fn, key))
    try:
        yield
    finally:
        for owner, name, fn, own in saved:
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)  # the inherited method again


@contextlib.contextmanager
def host_rss_peak(out: dict):
    """out["gib"]: this process's peak resident size over the block, sampled
    every 10 ms from /proc/self/statm (/proc/self/status may lack VmHWM)."""
    page = os.sysconf("SC_PAGE_SIZE")

    def rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page

    peak = [rss()]
    stop = threading.Event()

    def sample() -> None:
        while not stop.wait(0.01):
            peak[0] = max(peak[0], rss())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join()
        out["gib"] = max(peak[0], rss()) / 2 ** 30


def native_load(path: str, dev, numpy_route: bool):
    """load_model(path) on the card, natively or with PRIMA_NO_NATIVE=1 (the
    numpy route), timed: seconds in all, in block conversion and in the
    host-to-device copies; the conversions counted; peak host and device
    memory."""
    import torch

    from prima_tpu_torch import native
    from prima_tpu_torch.models import llama
    from prima_tpu_torch.models.loader import load_model
    from prima_tpu_torch.quant import qtensor

    patches = [(torch.Tensor, "to", "h2d")]
    patches += ([(llama, "to_device_format", "convert"), (qtensor, "pack_scales_np", "convert")]
                if numpy_route else [(qtensor, "native_convert", "convert")])
    acc = {"convert": 0.0, "h2d": 0.0}
    host = {}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = native.CONVERTED.count
    if numpy_route:
        os.environ["PRIMA_NO_NATIVE"] = "1"
    t0 = time.perf_counter()
    try:
        with host_rss_peak(host), timed_calls(acc, patches):
            m = load_model(path, device=dev)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("PRIMA_NO_NATIVE", None)
    secs = time.perf_counter() - t0
    size = os.path.getsize(path)
    r = {"route": "numpy" if numpy_route else "native", "seconds": secs,
         "convert_s": acc["convert"], "h2d_s": acc["h2d"],
         "other_s": secs - acc["convert"] - acc["h2d"], "gb_s": size / secs / 1e9,
         "convert_gb_s": size / acc["convert"] / 1e9, "h2d_gb_s": size / acc["h2d"] / 1e9,
         "converted": native.CONVERTED.count - before,
         "peak_host_gib": host["gib"],
         "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    return m, r


def param_leaves(tree, prefix: str = ""):
    """(path, QTensor or tensor) leaves of a params tree."""
    import torch

    from prima_tpu_torch.quant.qtensor import QTensor

    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from param_leaves(val, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from param_leaves(val, f"{prefix}{i}.")
    elif isinstance(tree, (QTensor, torch.Tensor)):
        yield prefix.rstrip("."), tree


def params_bits_equal(a: dict, b: dict) -> tuple[int, list]:
    """(QTensors compared, paths whose fields or metadata differ) of two
    params trees, every field bit for bit on the card."""
    import torch

    from prima_tpu_torch.quant.qtensor import QTensor

    la, lb = dict(param_leaves(a)), dict(param_leaves(b))
    bad = sorted(set(la) ^ set(lb))
    n = 0
    for key in sorted(set(la) & set(lb)):
        x, y = la[key], lb[key]
        if isinstance(x, QTensor):
            n += 1
            same = (isinstance(y, QTensor)
                    and all((u is None and w is None) or (u is not None and w is not None
                                                          and u.dtype == w.dtype
                                                          and torch.equal(u, w))
                            for u, w in zip(x.tensors(), y.tensors()))
                    and (x.sub, x.layout, x.q_offset, x.shape, x.gsub, x.packed)
                    == (y.sub, y.layout, y.q_offset, y.shape, y.gsub, y.packed))
        else:
            same = isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)
        if not same:
            bad.append(key)
    return n, bad


def tokenize_both(tok, text: str) -> dict:
    """The ids and MB/s of `tok` over `text` through its native merge loop
    and through its Python one (the vocab's cached native tokenizer set
    aside)."""
    from prima_tpu_torch.tokenizer import native as tok_native

    v = tok.vocab
    if tok_native.get(v) is None:
        raise AssertionError("native: the native tokenizer did not load")
    mb = len(text.encode("utf-8")) / 1e6
    t0 = time.perf_counter()
    ids_native = tok.encode(text, add_special=False)
    t_native = time.perf_counter() - t0
    saved = v._native_tok
    object.__setattr__(v, "_native_tok", None)
    try:
        t0 = time.perf_counter()
        ids_python = tok.encode(text, add_special=False)
        t_python = time.perf_counter() - t0
    finally:
        object.__setattr__(v, "_native_tok", saved)
    return {"ids": len(ids_native), "equal": ids_native == ids_python,
            "native_mb_s": mb / t_native, "python_mb_s": mb / t_python,
            "speedup": t_python / t_native}


def native_serve(m, dev, prompts: list) -> tuple[list, dict]:
    """The streams of 16 greedy tokens `m` gives for `prompts` through
    submit + step_fused (4 slots), with this run's launch counts and tok/s."""
    import torch

    from prima_tpu_torch.runtime.engine import Engine

    eng = Engine(m.cfg, m.params, n_slots=4, max_seq=256, device=dev)
    eng.run_to_completion(prompts[0][:16], n_predict=2)  # warm-up, not counted
    eng.perf = {k: 0 * v for k, v in eng.perf.items()}
    counters = zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = engine_streams(eng, prompts, n_predict=16)
    torch.cuda.synchronize()
    p = eng.perf
    return streams, {"wall_s": time.perf_counter() - t0, "launches": read_counts(counters),
                     "decode_tok_s": p["n_decode"] / p["t_decode_s"],
                     "prefill_tok_s": p["n_prompt"] / p["t_prompt_s"]}


def log_load(x: dict, what: str) -> None:
    log(f"native: load_model {x['route']}, {what}: {x['seconds']:.2f} s, {x['gb_s']:.3f} GB/s "
        f"(conversion {x['convert_s']:.2f} s at {x['convert_gb_s']:.3f} GB/s, H2D "
        f"{x['h2d_s']:.2f} s at {x['h2d_gb_s']:.3f} GB/s, the rest {x['other_s']:.2f} s); "
        f"{x['converted']} native conversions; peak host RSS {x['peak_host_gib']:.2f} GiB, "
        f"device {x['peak_device_gib']:.2f} GiB")


def phase_native(dev, report: dict) -> dict:
    """The native layer at full width: a Llama-3-8B-shape Q4_K_M GGUF of all
    32 layers written from a seed, loaded natively (timed, every quantized
    tensor converted) and serving 4 requests of 64 + 16 greedy tokens
    through step_fused (qgemv and kv_store launched); the same widths at 8
    layers loaded natively and through the numpy route (the numpy load of
    32 layers alone takes ~30 s of the script's time limit): every QTensor
    field, the streams and one f32 decode step's logits equal bit for bit;
    ~200 KB of the repository's text through the native and Python merge
    loops of a BPE and an SPM vocabulary (equal ids)."""
    import numpy as np
    import torch

    from prima_tpu_torch import native
    from prima_tpu_torch.gguf.reader import GGUFModel
    from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
    from prima_tpu_torch.tokenizer import Tokenizer

    t_phase = time.time()
    built = not os.path.exists(native._target(native.SOURCES, native.BUILD_DIR))
    lib = native.get_lib()
    if lib is None:
        raise AssertionError("native: the C++ library did not load (g++ or PRIMA_NO_NATIVE=1)")
    r = {"library": lib._name, "library_built": built, "library_s": time.time() - t_phase,
         "host_cores": os.cpu_count(), "card": card_line()}
    work = os.path.join(ROOT, "build", "chip_smoke", "native")
    os.makedirs(work, exist_ok=True)
    text = repo_text()
    t0 = time.time()
    merges = learn_merges(text, NATIVE_MERGES)
    r["merges"], r["merges_s"] = len(merges), time.time() - t0
    n_full = LLAMA3_8B["n_layers"]
    paths = {n: os.path.join(work, f"llama3-8b-shape-{n}l-q4_k_m.gguf") for n in (n_full, 8)}
    for n, path in paths.items():
        t0 = time.time()
        r[f"gguf_{n}l"] = g = write_native_gguf(path, merges, n, NATIVE_SEED)
        g["write_s"] = time.time() - t0
        gc.collect()
        log(f"native: {g['bytes'] / 1e9:.3f} GB GGUF of {n} layers ({g['types']}) written in "
            f"{g['write_s']:.1f} s")
    log(f"native: {len(merges)} merges in {r['merges_s']:.1f} s; {r['host_cores']} host cores; "
        f"library {r['library']} ({'built' if built else 'found'} in {r['library_s']:.1f} s)")
    rng = np.random.default_rng(NATIVE_SEED)
    prompts = [rng.integers(0, LLAMA3_8B["n_vocab"], 64).tolist() for _ in range(4)]

    full, r["load_native"] = native_load(paths[n_full], dev, numpy_route=False)
    log_load(r["load_native"], f"{n_full} layers")
    streams, r["serve"] = native_serve(full, dev, prompts)
    launches = {k: r["serve"]["launches"].get(k, 0) for k in ("qgemv", "kv_store")}
    log(f"native: {n_full} layers, 4 x (64 + 16) through step_fused: decode "
        f"{r['serve']['decode_tok_s']:.1f} tok/s, prefill {r['serve']['prefill_tok_s']:.1f}; "
        f"launches {r['serve']['launches']}")
    if (r["load_native"]["converted"] != r[f"gguf_{n_full}l"]["quantized"]
            or not all(len(s) == 16 for s in streams) or not all(launches.values())):
        raise AssertionError(f"native: {r['load_native']['converted']} conversions for "
                             f"{r[f'gguf_{n_full}l']['quantized']} quantized tensors, streams "
                             f"{streams}, launches {launches}")
    tok_bpe = full.tokenizer
    del full
    gc.collect()
    torch.cuda.empty_cache()

    models, streams = {}, {}
    for route, numpy_route in (("native", False), ("numpy", True)):
        models[route], r[f"load_{route}_8l"] = native_load(paths[8], dev, numpy_route)
        log_load(r[f"load_{route}_8l"], "8 layers")
        streams[route], r[f"serve_{route}_8l"] = native_serve(models[route], dev, prompts)
    nat, ref = models["native"], models["numpy"]
    n_q, bad = params_bits_equal(nat.params, ref.params)
    r["qtensors_compared"], r["fields_differ"] = n_q, bad[:8]
    cfg = nat.cfg
    toks = torch.as_tensor(rng.integers(0, cfg.n_vocab, (4, 1)), device=dev)
    logits = {}
    for route, m in models.items():
        kv = init_kv_caches(cfg, 4, 64, torch.float32, dev)
        with torch.no_grad():
            logits[route], _ = forward(
                m.params, cfg, toks, torch.zeros((4, 1), dtype=torch.int32, device=dev), kv,
                torch.zeros(4, dtype=torch.int32, device=dev), ForwardOptions(dtype=torch.float32))
    r["decode_logits_equal"] = (logits["native"].shape == (4, 1, cfg.n_vocab)
                                and bool(torch.isfinite(logits["native"]).all())
                                and torch.equal(logits["native"], logits["numpy"]))
    r["decode_logits_max_abs"] = logits["native"].abs().max().item()
    r["streams_equal"] = streams["native"] == streams["numpy"]
    log(f"native: 8 layers, {n_q} QTensors, every field native = numpy bit for bit: {not bad}; "
        f"one f32 decode step's logits equal and finite: {r['decode_logits_equal']} (max |logit| "
        f"{r['decode_logits_max_abs']:.3f}); 4 x (64 + 16) streams equal: {r['streams_equal']}")
    n8 = r["gguf_8l"]["quantized"]
    if (r["load_native_8l"]["converted"] != n8 or r["load_numpy_8l"]["converted"]
            or bad or n_q != n8 or not r["decode_logits_equal"] or not r["streams_equal"]):
        raise AssertionError(f"native: the 8-layer loads differ: conversions "
                             f"{r['load_native_8l']['converted']} / "
                             f"{r['load_numpy_8l']['converted']} of {n8}, fields {bad[:8]}")
    del nat, ref, models, logits
    gc.collect()
    torch.cuda.empty_cache()
    for path in paths.values():
        os.remove(path)

    spm_path = os.path.join(work, "spm.gguf")
    write_spm_vocab(spm_path, merges, text)
    r["tokenize"] = {"text_mb": len(text.encode("utf-8")) / 1e6}
    for name, tok in (("bpe", tok_bpe), ("spm", Tokenizer.from_gguf(GGUFModel.open(spm_path)))):
        x = r["tokenize"][name] = tokenize_both(tok, text)
        log(f"native: {name} over {r['tokenize']['text_mb']:.3f} MB of the repository's text: "
            f"{x['ids']} ids, native {x['native_mb_s']:.3f} MB/s, Python {x['python_mb_s']:.4f} "
            f"MB/s ({x['speedup']:.1f}x), ids equal {x['equal']}")
        if not x["equal"]:
            raise AssertionError(f"native: {name} ids differ between the native and Python paths")
    r["seconds"] = time.time() - t_phase
    report["native"] = r
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,server,full,long,spec,ring,moe,tools,quant,embed,vision,"
                            "families,mesh,train,native",
                    help="comma-separated subset of build,kernels,server,full,long,spec,ring,"
                         "moe,tools,quant,embed,vision,families,mesh,train,native")
    # rank 1 of phase ring's full-width ring runs this script with these
    ap.add_argument("--ring-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--ring-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--ring-out", help=argparse.SUPPRESS)
    # rank 0 of a phase mesh case runs this script with these
    ap.add_argument("--mesh-case", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if args.ring_rank is not None:
        return ring_worker_main(args.ring_port, args.ring_out)
    if args.mesh_case is not None:
        return mesh_case(args.mesh_case, args.mesh_out)

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
    if phases & {"full", "long", "spec"}:
        cfg, params = weights_8b(dev)
    if "full" in phases:
        t0 = time.time()
        phase_full(dev, report, cfg, params)
        log(f"full: {time.time() - t0:.1f} s")
    if "long" in phases:
        t0 = time.time()
        launches = dict(phase_long(dev, report, cfg, params))
        log(f"long: {time.time() - t0:.1f} s")
    if "spec" in phases:
        t0 = time.time()
        phase_spec(dev, report, cfg, params)
        log(f"spec: {time.time() - t0:.1f} s")
    if phases & {"full", "long", "spec"}:
        del params  # the 8B weights make room for the ring's and Mixtral's
        gc.collect()
        torch.cuda.empty_cache()
    if "ring" in phases:
        t0, held = time.time(), torch.cuda.memory_allocated(dev)
        phase_ring(dev, report)
        ring_launches = report["ring"]["launches"]  # the world-2 run, by rank
        for name in ring_launches["rank0"]:
            report[name]["ring_launches"] = {rank: n[name] for rank, n in ring_launches.items()}
        gc.collect()
        log(f"ring: {time.time() - t0:.1f} s; device memory allocated "
            f"{held / 2 ** 30:.3f} GiB before, {torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} after")
    launches["qgemv_indexed"] = None
    if "moe" in phases:
        t0 = time.time()
        launches["qgemv_indexed"] = phase_moe(dev, report)["qgemv_indexed"]
        log(f"moe: {time.time() - t0:.1f} s")
    if "tools" in phases:
        t0 = time.time()
        phase_tools(dev, report)
        log(f"tools: {time.time() - t0:.1f} s")
    if "quant" in phases:
        t0 = time.time()
        phase_quant(dev, report)
        log(f"quant: {time.time() - t0:.1f} s")
    # the qgemv and kv_store counts of the embedding server's and llava's
    # runs join the long phase's
    for phase, fn in (("embed", phase_embed), ("vision", phase_vision)):
        if phase in phases:
            t0 = time.time()
            for name, n in fn(dev, report).items():
                launches[name] = (launches.get(name) or 0) + n
            log(f"{phase}: {time.time() - t0:.1f} s")
    if "families" in phases:
        t0 = time.time()
        phase_families(dev, report)
        log(f"families: {time.time() - t0:.1f} s")
    # the mesh's served run (every rank's counts, summed) joins the
    # counts of qgemv and kv_store
    if "mesh" in phases:
        t0 = time.time()
        for name, n in phase_mesh(dev, report).items():
            launches[name] = (launches.get(name) or 0) + n
        log(f"mesh: {time.time() - t0:.1f} s")
    if "train" in phases:
        t0 = time.time()
        phase_train(dev, report)
        log(f"train: {time.time() - t0:.1f} s")
    # the natively loaded GGUF's served run joins the counts of qgemv and
    # kv_store
    if "native" in phases:
        t0 = time.time()
        for name, n in phase_native(dev, report).items():
            launches[name] = (launches.get(name) or 0) + n
        log(f"native: {time.time() - t0:.1f} s")
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
