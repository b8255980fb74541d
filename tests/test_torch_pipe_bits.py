"""The port's pipe forward where only pp and dp split the work (tp = sp =
1): the hop carries exact values, so its logits equal, bit for bit in f32,
the port's one-process forward over the same rows (each dp replica's rows
through the layers, then one head over the whole grid). The streamed pipe
(the first W - n_resident layers of each window uploaded per window from
host memory) equals the resident pipe bit for bit."""

import numpy as np
import pytest
import torch

from prima_tpu_torch.gguf.constants import GGMLType
from prima_tpu_torch.models.config import tiny_config
from prima_tpu_torch.models.llama import (forward, init_kv_caches, lm_head, synth_host_head,
                                          synth_host_layer)
from prima_tpu_torch.parallel.sharding import put_shard
from torch_mesh_ranks import F32, passes, plan_for, run_world, runner_passes


def windowed_reference(cfg, dp, batches, B, T, seed=0):
    """Per dp replica and microbatch, the one-process forward over that
    replica's rows (its own caches), the head over the joined grid."""
    head = {k: put_shard(v, "cpu") for k, v in synth_host_head(cfg, GGMLType.Q4_K, seed).items()}
    params = dict(head, layers=[{k: put_shard(v, "cpu") for k, v in
                                 synth_host_layer(cfg, i, GGMLType.Q4_K, seed).items()}
                                for i in range(cfg.n_layers)])
    M, bl = batches[0][0].shape[0], B // dp
    kv = [[init_kv_caches(cfg, bl, T, torch.float32) for _ in range(dp)] for _ in range(M)]
    out = []
    for tokens, positions, cache_pos in batches:
        rows = []
        for m in range(M):
            part = []
            for r in range(dp):
                sl = slice(r * bl, (r + 1) * bl)
                h, _ = forward(params, cfg, torch.as_tensor(tokens[m, sl]),
                               torch.as_tensor(positions[m, sl]), kv[m][r],
                               torch.as_tensor(cache_pos[m, sl]), F32, return_hidden=True)
                part.append(h)
            rows.append(torch.cat(part))
        out.append(lm_head(params, cfg, torch.stack(rows), F32).numpy())
    return out


def two_passes(M, B, S, seed):
    rng = np.random.default_rng(seed)
    first = (rng.integers(0, 256, size=(M, B, S)).astype(np.int64),
             np.broadcast_to(np.arange(S, dtype=np.int32), (M, B, S)).copy(),
             np.zeros((M, B), np.int32))
    second = (rng.integers(0, 256, size=(M, B, 1)).astype(np.int64),
              np.full((M, B, 1), S, np.int32), np.full((M, B), S, np.int32))
    return [first, second]


@pytest.mark.parametrize("dp,pp,k", [(1, 2, 2), (2, 2, 1), (1, 4, 1)])
def test_pipe_equals_the_windowed_forward_bit_for_bit(dp, pp, k):
    cfg = tiny_config(n_layers=4)
    B, T = 2, 16
    batches = two_passes(pp, B, 5, 6)
    got = run_world(plan_for(cfg, dp, pp, 1, k=k), passes, B, T, torch.float32, batches)
    want = windowed_reference(cfg, dp, batches, B, T)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("dp,pp,k,n_res,route", [(1, 2, 2, 1, "engine"), (2, 2, 1, 0, "engine"),
                                                (1, 2, 2, 1, "runner")])
def test_streamed_pipe_equals_resident_bit_for_bit(dp, pp, k, n_res, route):
    """Rank windows of 2 layers (8 layers over pp * k windows), through a
    rank's PipeRank (the engine's route) or StreamedPipeRunner."""
    cfg = tiny_config(n_layers=4 * k * pp // 2)
    B, T = 2, 16
    batches = two_passes(pp, B, 5, 7)
    plan = plan_for(cfg, dp, pp, 1, k=k, n_resident=n_res)
    streamed = (run_world(plan, passes, B, T, torch.float32, batches) if route == "engine"
                else run_world(plan, runner_passes, B, T, batches))
    resident = run_world(plan_for(cfg, dp, pp, 1, k=k), passes, B, T, torch.float32,
                         batches)
    for s, r in zip(streamed, resident):
        assert np.array_equal(s, r)
