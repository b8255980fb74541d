"""Rank programs of the port's mesh tests (tests/test_torch_pipe*.py,
test_torch_dist_engine.py, test_torch_mesh_cuda.py).

`run_world(plan, fn, *args)` starts one process per rank of `plan` (the
spawn start method, gloo on the CPU), runs fn(plan, rank, *args) in each
and returns rank 0's result. A failing rank's traceback fails the test;
every wait has a deadline and the processes are ended after it, so a
broken mesh cannot hang the suite. This module imports only torch and
prima_tpu_torch: the children never load JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import traceback

import numpy as np
import torch

from prima_tpu_torch.gguf.constants import GGMLType
from prima_tpu_torch.models.llama import ForwardOptions
from prima_tpu_torch.parallel.engine import DistributedEngine, PipeRank, PipeWorker
from prima_tpu_torch.parallel.launch import RankPlan, build_rank, init_multihost
from prima_tpu_torch.runtime.engine import SlotState

F32 = ForwardOptions(matmul_impl="plain", dtype=torch.float32)
DEADLINE = 120.0  # seconds for one world, start to finish


def plan_for(cfg, dp=1, pp=2, tp=1, sp=1, k=1, microbatches=None, seed=0,
             gt=GGMLType.Q4_K, n_resident=None, opts=F32) -> RankPlan:
    """A CPU mesh over the JAX package's synthetic weights (host draws)."""
    return RankPlan({"dp": dp, "pp": pp, "sp": sp, "tp": tp}, init_multihost()[0],
                    ("synth_host", cfg, gt, seed), k_cycles=k, microbatches=microbatches,
                    opts=opts, device="cpu", n_resident=n_resident, timeout=60.0)


def _entry(plan, rank, q, fn, args):
    torch.set_num_threads(1)
    try:
        out = fn(plan, rank, *args)
        if rank == 0:
            q.put(("ok", out))
    except BaseException:  # noqa: BLE001 - reported to the test
        q.put(("err", f"rank {rank}:\n{traceback.format_exc()}"))


def run_world(plan: RankPlan, fn, *args, timeout: float = DEADLINE):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(plan, r, q, fn, args), daemon=True)
             for r in range(plan.world)]
    for p in procs:
        p.start()
    try:
        kind, payload = q.get(timeout=timeout)
    except queue.Empty:
        kind, payload = "err", f"the mesh gave no result within {timeout} s"
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(5)
    if kind == "err":
        raise AssertionError(payload)
    return payload


# -- the pipe forward --------------------------------------------------------------


def passes(plan, rank, batch_per_micro, max_seq, kv_dtype, batches):
    """Each (tokens, positions, cache_pos) of `batches` through one rank's
    pipe forward over one cache; rank 0 returns the logits."""
    mesh, cfg, spec, params, streamer = build_rank(plan, rank)
    try:
        r = PipeRank(cfg, params, spec, mesh, batch_per_micro, max_seq, plan.opts, kv_dtype,
                     streamer)
        outs = []
        for tokens, positions, cache_pos in batches:
            out = r.execute(("pass", tokens, positions, cache_pos, positions, True))
            outs.append(None if out is None else out.float().numpy())
        return outs
    finally:
        mesh.close()


def runner_passes(plan, rank, batch_per_micro, max_seq, batches):
    """The streamed pipe through StreamedPipeRunner (the JAX runner's
    interface: build_streamed_pipe_model, then forward on every rank)."""
    from prima_tpu_torch.models.llama import synth_host_head, synth_host_layer
    from prima_tpu_torch.parallel.mesh import make_mesh
    from prima_tpu_torch.parallel.pipeline import PipeSpec
    from prima_tpu_torch.parallel.streamed_pipe import (StreamedPipeRunner,
                                                        build_streamed_pipe_model)

    s, (_, cfg, gt, seed) = plan.shape, plan.source
    mesh = make_mesh(**s, rank=rank, device="cpu", init_method=plan.init_method, timeout=60.0)
    try:
        spec = PipeSpec.for_model(cfg, s["pp"], s["tp"], s["dp"], plan.k_cycles,
                                  plan.microbatches, s["sp"])
        model = build_streamed_pipe_model(lambda i: synth_host_layer(cfg, i, gt, seed),
                                          synth_host_head(cfg, gt, seed), cfg, spec, mesh,
                                          plan.n_resident)
        runner = StreamedPipeRunner(model, batch_per_micro, max_seq, plan.opts)
        outs = [runner.forward(*b) for b in batches]
        return [None if o is None else o.numpy() for o in outs]
    finally:
        mesh.close()


def sp_attention(plan, rank, q, k0, v0, k_new, v_new, cache_pos, positions, kv_dtype):
    """update_kv_sp + gqa_attention_sp on this rank's block of caches
    k0 / v0 (b, T, kvh, hd); rank 0 returns the attention output and every
    rank's block after the write (dense values)."""
    from prima_tpu_torch.ops.kvquant import KVQ4, KVQ8, update_kv_sp
    from prima_tpu_torch.ops.layers import causal_mask, gqa_attention_sp
    from prima_tpu_torch.parallel.mesh import make_mesh

    s = plan.shape
    mesh = make_mesh(dp=s["dp"], pp=s["pp"], tp=s["tp"], sp=s["sp"], rank=rank,
                     device="cpu", init_method=plan.init_method, timeout=60.0)
    try:
        ax = mesh.axis("sp")
        t_loc = k0.shape[1] // ax.size
        off = ax.index * t_loc
        blocks = []
        for full in (k0, v0):
            part = torch.from_numpy(np.ascontiguousarray(full[:, off:off + t_loc]))
            if kv_dtype in ("q8_0", "q4_0"):
                cls = KVQ8 if kv_dtype == "q8_0" else KVQ4
                qs, sc = cls.quantize(part)
                part = cls(qs.contiguous(), sc.contiguous())
            blocks.append(part)
        cp = torch.as_tensor(cache_pos)
        update_kv_sp(blocks[0], torch.as_tensor(k_new), cp, off)
        update_kv_sp(blocks[1], torch.as_tensor(v_new), cp, off)
        qt = torch.as_tensor(q)
        mask = causal_mask(torch.as_tensor(positions) - off, t_loc)
        out = gqa_attention_sp(qt, blocks[0].to(qt.dtype), blocks[1].to(qt.dtype), mask,
                               1.0 / np.sqrt(q.shape[-1]), ax)
        dense = [b.to(torch.float32).numpy() for b in blocks]
        parts = mesh.gather_obj0(dense)
        return None if parts is None else (out.numpy(), parts)
    finally:
        mesh.close()


# -- engines on rank 0, workers elsewhere -------------------------------------------


def engines(plan, rank, scenario, *args):
    """Rank 0 runs SCENARIOS[scenario](make, *args), where make(**kw)
    builds a DistributedEngine over the mesh; the other ranks serve."""
    mesh, cfg, spec, params, streamer = build_rank(plan, rank)
    try:
        if rank != 0:
            PipeWorker(cfg, params, spec, mesh, streamer).serve()
            return None

        def make(**kw):
            kw.setdefault("opts", plan.opts)
            kw.setdefault("kv_dtype", torch.float32)
            return DistributedEngine(cfg, params, spec, mesh, streamer=streamer, **kw)

        try:
            return SCENARIOS[scenario](make, *args)
        finally:
            mesh.bcast_cmd((-1, "stop"))
    finally:
        mesh.close()


def _drain(eng, slots, fused: bool = False, chunk: int = 4) -> None:
    while any(s.state != SlotState.IDLE for s in slots):
        eng.step_fused(max_chunk=chunk) if fused else eng.step()


def scenario_batching(make):
    """The cases of tests/test_distributed_engine.py on one engine of 2 x 2
    slots: one request alone, staggered joins over the grid, step_fused
    against step, seeded sampling on both paths, two slots through the
    fused loop, and verify_chain's logits."""
    import dataclasses

    from prima_tpu_torch.sampling import Sampler, SamplerParams

    eng = make(batch_per_micro=2, max_seq=64, n_batch=16)
    out = {"alone": eng.run_to_completion([3, 17, 42, 7, 99, 5], n_predict=8)}
    prompts = [[3, 17, 42, 7], [100, 20, 8, 55, 21], [9, 9, 9], [1, 2, 3, 4, 5]]
    slots = [eng.submit(prompts[0], n_predict=6, request_id=0)]
    eng.step()
    slots += [eng.submit(prompts[1], n_predict=6, request_id=1),
              eng.submit(prompts[2], n_predict=6, request_id=2)]
    eng.step()
    slots.append(eng.submit(prompts[3], n_predict=6, request_id=3))
    _drain(eng, slots)
    out["staggered"] = [list(s.generated) for s in slots]
    prompt = [5, 11, 23, 4]
    out["step"] = eng.run_to_completion(prompt, n_predict=10, reuse_prefix=False)
    s = eng.submit(prompt, n_predict=10, reuse_prefix=False)
    _drain(eng, [s], fused=True)
    out["fused"] = list(s.generated)
    p = SamplerParams(temp=0.9, top_k=24, top_p=0.9, seed=13)
    runs = []
    for fused in (True, True, False):
        s = eng.submit([2, 7, 19], sampler=Sampler(dataclasses.replace(p)), n_predict=8,
                       reuse_prefix=False)
        _drain(eng, [s], fused=fused, chunk=3)
        runs.append(list(s.generated))
    out["seeded"] = runs
    two = [eng.submit(q, n_predict=6, request_id=i, reuse_prefix=False)
           for i, q in enumerate(prompts[:2])]
    _drain(eng, two, fused=True)
    out["fused_two"] = [list(s.generated) for s in two]
    # verify a chain after prefilling the prompt (the speculative protocol)
    s = eng.submit([3, 17, 42, 7, 99], n_predict=1, reuse_prefix=False)
    eng.prefill_only(s)
    out["verify"] = eng.verify_chain(s.id, [99, 5, 11, 23])
    out["verify_pos"] = eng.kv.used(s.id)
    launches = eng.kernel_launches()
    out["by_rank"] = len(launches["by_rank"])
    return out


def scenario_pipe_kv(make, shift_n: int):
    """The cases of tests/test_pipe_kv.py, each on an engine of its own."""
    import os
    import tempfile

    from prima_tpu_torch.runtime.state import slot_restore, slot_save

    out = {}
    prompt = [3, 17, 42, 7]
    # context shift past max_seq, and the stop without it
    eng = make(batch_per_micro=1, max_seq=24, n_batch=8, ctx_shift=True, n_keep=2)
    out["shift"] = eng.run_to_completion(prompt, n_predict=shift_n)
    out["shift_reason"], out["shift_used"] = eng.slots[0].stop_reason, eng.kv.used(0)
    eng2 = make(batch_per_micro=1, max_seq=24, n_batch=8)
    eng2.run_to_completion(prompt, n_predict=shift_n)
    out["noshift_reason"] = eng2.slots[0].stop_reason
    # seq_cp clones a row, seq_rm + resubmit re-decodes the same tokens
    eng = make(batch_per_micro=2, max_seq=32, n_batch=8)
    p5 = [3, 17, 42, 7, 9]
    s0 = eng.submit(p5, n_predict=4, request_id=0)
    _drain(eng, [s0])
    first = list(s0.generated)
    eng.kv.seq_cp(1, 0)
    s1 = eng.slots[1]
    s1.prompt, s1.generated = list(p5 + first[:-1]), [first[-1]]
    s1.state, s1.n_predict = SlotState.DECODE, 4
    from prima_tpu_torch.sampling import Sampler, SamplerParams

    s1.sampler = Sampler(SamplerParams(temp=0.0))
    for t in s1.prompt + s1.generated:
        s1.sampler.accept(t, accept_grammar=False)
    _drain(eng, [s1])
    out["cp_first"], out["cp_cont"] = first, list(s1.generated)
    eng.kv.seq_rm(0, p0=len(p5) - 1)
    s0b = eng.submit(p5, n_predict=4, request_id=1)
    out["rm_same_slot"] = s0b is eng.slots[0]
    _drain(eng, [s0b])
    out["rm_again"] = list(s0b.generated)
    # seq_add(move) against re-encoding the kept tokens (layer 0's cells)
    toks = [5, 9, 2, 33, 11, 7]

    def encode(token_list):
        e = make(batch_per_micro=1, max_seq=32, n_batch=8)
        M, S = e.M, len(token_list)
        tokens = np.zeros((M, 1, S), np.int64)
        tokens[0, 0] = token_list
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (M, 1, S)).copy()
        e._pass(tokens, pos, head=False)
        e.kv.cache_pos[0] = S
        return e

    e1 = encode(toks)
    e1.kv.seq_add(0, 4, len(toks), -2)
    kept = toks[:2] + toks[4:]
    e2 = encode(kept)
    out["seq_add"] = (e1.kv.materialize_slot(0, len(kept)),
                      e2.kv.materialize_slot(0, len(kept)))
    # save / restore through slot files
    eng = make(batch_per_micro=1, max_seq=24, n_batch=8)
    out1 = eng.run_to_completion(prompt, n_predict=6)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "slot0.bin")
        n = slot_save(eng, 0, path)
        with open(path, "rb") as f:
            out["slot_file"] = f.read()
        eng2 = make(batch_per_micro=1, max_seq=24, n_batch=8)
        m = slot_restore(eng2, 0, path)
    out["saved"], out["restored"] = n, m
    full = prompt + out1
    out["restore_got"] = eng2.run_to_completion(full, n_predict=3)
    out["restore_want"] = eng.run_to_completion(full, n_predict=3)
    out["save_first"] = out1
    # Self-Extend
    p6 = [3, 17, 42, 7, 99, 5]
    eng = make(batch_per_micro=1, max_seq=64, n_batch=8, grp_attn_n=2, grp_attn_w=8)
    out["se24"] = eng.run_to_completion(p6, n_predict=24)
    sl = eng.slots[0]
    out["se24_state"] = (sl.ga_i, sl.pos_delta, eng.kv.used(0),
                         sl.pos_map[:eng.kv.used(0)].copy())
    plain = make(batch_per_micro=1, max_seq=64, n_batch=8).run_to_completion(prompt,
                                                                             n_predict=6)
    se = make(batch_per_micro=1, max_seq=64, n_batch=8, grp_attn_n=4,
              grp_attn_w=32).run_to_completion(prompt, n_predict=6)
    out["se_prefix"] = (plain, se)
    eng = make(batch_per_micro=1, max_seq=64, n_batch=8, grp_attn_n=2, grp_attn_w=8)
    out["se16"] = eng.run_to_completion(p6, n_predict=16)
    out["se16_delta"] = eng.slots[0].pos_delta
    # quantized caches
    for ctk in ("q8_0", "q4_0"):
        out[ctk] = make(batch_per_micro=1, max_seq=32, n_batch=8,
                        kv_dtype=ctk).run_to_completion(prompt, n_predict=8)
    eng = make(batch_per_micro=1, max_seq=24, n_batch=8, kv_dtype="q8_0", ctx_shift=True,
               n_keep=2)
    out["q8_shift"] = eng.run_to_completion(prompt, n_predict=30)
    out["q8_shift_used"] = eng.kv.used(0)
    return out


def scenario_embed(make, prompt):
    return make(batch_per_micro=1, max_seq=32, n_batch=8).embed(prompt)


def scenario_greedy(make, prompts, n):
    """The prompts at once on a 2 x 2 grid, greedy; every rank's launches."""
    eng = make(batch_per_micro=2, max_seq=64, n_batch=16)
    eng.kernel_launches(reset=True)
    slots = [eng.submit(p, n_predict=n, request_id=i) for i, p in enumerate(prompts)]
    _drain(eng, slots, fused=True)
    return [list(s.generated) for s in slots], eng.kernel_launches()["by_rank"]


SCENARIOS = {"batching": scenario_batching, "pipe_kv": scenario_pipe_kv,
             "embed": scenario_embed, "greedy": scenario_greedy}
