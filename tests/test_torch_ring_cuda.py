"""The ring and weight streaming on the card, against one process on the
same card, bit for bit: streamed layers (pinned host memory, copied up on a
side stream while the compute stream runs) give the resident model's
logits; a ring of two threads on cuda:0 (bf16, the wire's truncation
lossless) gives the logits of the one-process ring over the same row
groups; HostRingExecutor over ["cuda:0", "cuda:0"] gives one forward's.

Every test here needs an NVIDIA GPU and skips without one. The machine with
the card has no JAX, so run this file without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_ring_cuda.py
"""

import os
import socket
import threading

import numpy as np
import pytest
import torch

from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.models.config import ModelConfig
from prima_tpu_torch.models.llama import ForwardOptions, gguf_host_layer, load_params
from prima_tpu_torch.parallel.bootstrap import RingConfig, RingNode
from prima_tpu_torch.parallel.ring_host import HostRingExecutor, RingPlan
from prima_tpu_torch.parallel.ring_tcp import RingContext, TcpRingEngine, TcpRingWorker
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.runtime.streaming import (StreamedRunner, build_streamed_model,
                                               pack_host_layer)

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
PROMPTS = [[1, 84, 104, 101, 32, 113], [1, 79, 110, 99, 101, 32, 117, 112],
           [1, 100, 101, 102], [1, 105, 109, 112, 111, 114, 116, 32, 110]]
DEADLINE = 60.0


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = GGUFModel.open(PAIR)
    return m, ModelConfig.from_gguf(m)


def test_streamed_logits_equal_resident(model):
    m, cfg = model
    dev = torch.device("cuda", 0)
    params = load_params(m, cfg, dev)
    head = {k: v for k, v in params.items() if k != "layers"}
    host = lambda i: gguf_host_layer(m, cfg, i)
    logits = []
    for n_resident in (cfg.n_layers, 1, 0):
        run = StreamedRunner(build_streamed_model(host, head, cfg, n_resident, dev), batch=1,
                             max_seq=64)
        toks = run.greedy_generate(PROMPTS[0], 8)
        logits.append((toks, run.forward(np.asarray([[toks[-1]]]),
                                         np.asarray([[run.cache_pos[0]]]))))
    for toks, lg in logits[1:]:
        assert toks == logits[0][0] and np.array_equal(lg, logits[0][1])


def _nodes(world: int) -> list:
    for _ in range(20):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            base = probe.getsockname()[1]
        nodes = []
        try:
            for r in range(world):
                nodes.append(RingNode(RingConfig(rank=r, world=world, data_port=base)))
        except OSError:
            for n in nodes:
                n.close()
            continue
        for n in nodes:
            n.listener.settimeout(DEADLINE)
        return nodes
    raise RuntimeError("no free ports for a ring")


def _serve(eng, rec: list) -> list:
    head = eng.core.head
    eng.core.head = lambda h: rec.append(head(h).float().cpu()) or rec[-1]
    slots = [eng.submit(p, n_predict=8) for p in PROMPTS]
    while any(s.state.name != "IDLE" for s in slots):
        eng.step()
    return [list(s.generated) for s in slots]


def _rank_params(m, cfg, plan, rank, dev, ngl):
    owned = plan.owned(rank)
    streamed = {i for lo, hi in plan.layer_ranges()[rank] for i in range(lo, hi - ngl)}
    params = load_params(m, cfg, dev, layer_filter=lambda i: i in owned and i not in streamed,
                         with_embedding=rank == 0, with_output=rank == 0)
    host = {i: pack_host_layer(gguf_host_layer(m, cfg, i), pin=True) for i in streamed}
    return params, host or None


def test_thread_ring_equals_one_process_ring(model):
    """world 2, -lw 1,1, k 2, rank 1 streaming one layer of each window,
    4 slots in 2 groups: the same logits bits as the one-process ring over
    the same groups, and the one-process Engine's greedy tokens."""
    m, cfg = model
    dev = torch.device("cuda", 0)
    plan = RingPlan([1, 1], 2)
    kw = dict(n_slots=4, n_groups=2, max_seq=96, n_batch=32, device=dev,
              opts=ForwardOptions(attn_impl="kernel"))
    nodes = _nodes(2)
    threads = [threading.Thread(target=n.connect_ring) for n in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE)
    errs = []

    def worker():
        try:
            params, host = _rank_params(m, cfg, plan, 1, dev, 0)
            TcpRingWorker(RingContext(nodes[1], plan, 1, 2), cfg, params, max_seq=96,
                          opts=kw["opts"], n_slots=4, n_groups=2, streamed_host=host,
                          device=dev).serve(timeout=DEADLINE)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    params, _ = _rank_params(m, cfg, plan, 0, dev, 1)
    eng = TcpRingEngine(RingContext(nodes[0], plan, 0, 2), cfg, params,
                        recv_timeout=DEADLINE, **kw)
    ring_logits = []
    try:
        got = _serve(eng, ring_logits)
    finally:
        eng.stop()
        th.join(DEADLINE)
        for n in nodes:
            n.close()
    assert not errs and not th.is_alive()

    whole = load_params(m, cfg, dev)
    one = TcpRingEngine(RingContext(None, RingPlan([2], 2), 0, 1), cfg, whole, **kw)
    one_logits = []
    assert _serve(one, one_logits) == got
    assert len(one_logits) == len(ring_logits) > 0
    assert all(torch.equal(a, b) for a, b in zip(ring_logits, one_logits))
    eng1 = Engine(cfg, whole, n_slots=4, max_seq=96, n_batch=32, opts=kw["opts"],
                  device=dev)
    assert [eng1.run_to_completion(p, n_predict=8) for p in PROMPTS] == got


def test_host_ring_executor_on_one_card(model):
    m, cfg = model
    params = load_params(m, cfg, "cpu")
    head = {k: v for k, v in params.items() if k != "layers"}
    ex = HostRingExecutor(cfg, RingPlan([1, 1], 2), lambda i: params["layers"][i], head,
                          ["cuda:0", "cuda:0"], max_seq=64)
    assert all(t.device.type == "cuda" for t in ex.kv[1][1])
    dev_params = load_params(m, cfg, torch.device("cuda", 0))
    eng = Engine(cfg, dev_params, n_slots=1, max_seq=64, device="cuda:0")
    assert ex.greedy_generate(PROMPTS[1], 8) == eng.run_to_completion(PROMPTS[1], n_predict=8)
