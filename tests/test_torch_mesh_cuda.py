"""The mesh and the trainer on the card (the `cuda` marker: skipped without
a GPU). Two ranks of a pp = 2 mesh on one card (gloo, host-staged) give
the one-device Engine's greedy streams on the same weights, and both
launch `qgemv` and `kv_store`; three train steps of the tiny target on
the card follow the CPU's losses. No JAX here, so on the card's machine:

    python -m pytest --noconftest -q tests/test_torch_mesh_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from prima_tpu_torch.gguf.constants import GGMLType
from prima_tpu_torch.models.config import tiny_config
from prima_tpu_torch.models.llama import ForwardOptions, synth_host_head, synth_host_layer
from prima_tpu_torch.parallel.sharding import put_shard
from prima_tpu_torch.runtime.engine import Engine
from torch_mesh_ranks import engines, plan_for, run_world

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def test_pp2_mesh_on_one_card_equals_the_engine(card):
    cfg = tiny_config(n_layers=4, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64, n_ff=512)
    opts = ForwardOptions(dtype=torch.float32)  # the kernels
    plan = dataclasses.replace(plan_for(cfg, 1, 2, 1, k=2, seed=3, opts=opts), device="cuda")
    prompts = [[3, 17, 42, 7], [100, 20, 8, 55, 21], [9, 9, 9], [1, 2, 3, 4, 5]]
    got, by_rank = run_world(plan, engines, "greedy", prompts, 8, timeout=300.0)
    head = {k: put_shard(v, card) for k, v in synth_host_head(cfg, GGMLType.Q4_K, 3).items()}
    params = dict(head, layers=[{k: put_shard(v, card) for k, v in
                                 synth_host_layer(cfg, i, GGMLType.Q4_K, 3).items()}
                                for i in range(4)])
    eng = Engine(cfg, params, n_slots=4, max_seq=64, n_batch=16, opts=opts,
                 kv_dtype=torch.float32, device=card)
    slots = [eng.submit(p, n_predict=8) for p in prompts]
    while any(s.state.name != "IDLE" for s in slots):
        eng.step_fused()
    assert got == [list(s.generated) for s in slots]
    assert all(r["qgemv"] > 0 and r["kv_store"] > 0 for r in by_rank)


def test_train_steps_on_the_card_follow_the_cpu(card):
    from prima_tpu_torch.tools import train_tiny_pair as tool

    cfg = tool.make_cfg(4, 256, 4, 704)
    rng = np.random.default_rng(0)
    xs = [rng.integers(3, tool.N_VOCAB, (4, 65)).astype(np.int64) for _ in range(3)]
    losses = {}
    for dev in (card, torch.device("cpu")):
        p = tool._map(tool.init_params(cfg, 0), lambda t: t.to(dev).requires_grad_(True))
        tr = tool.Trainer(p, cfg, 3e-3, 20, dev)
        losses[dev.type] = [float(tr.step(torch.from_numpy(x).to(dev))) for x in xs]
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b)
