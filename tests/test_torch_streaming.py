"""Weight streaming on the CPU: StreamedRunner, with 0, 2 or all 4 layers
resident and the rest copied up layer by layer, gives the resident
model's greedy tokens and the same logits bit for bit; what it streams is
exactly the streamed layers' bytes, every forward; the packed host
layers are the device format load_params gives; and only a device that
streams layers dequantizes by slices."""

import os

import numpy as np
import pytest
import torch

from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.models.config import ModelConfig
from prima_tpu_torch.models.llama import ForwardOptions, gguf_host_layer, load_params
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.parallel.ring_host import RingPlan
from prima_tpu_torch.parallel.ring_tcp import RingContext, TcpRingEngine
from prima_tpu_torch.quant import qtensor as qtm
from prima_tpu_torch.runtime.streaming import (STREAM_DEQUANT_WEIGHTS, StreamedRunner,
                                               build_streamed_model, layer_nbytes,
                                               pack_host_layer, tensors_of)
from test_torch_speculative import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
OPTS = ForwardOptions(dtype=torch.float32)
PROMPT = [1, 84, 104, 101, 32, 113]


@pytest.fixture(scope="module")
def model():
    m = GGUFModel.open(PAIR)
    cfg = ModelConfig.from_gguf(m)
    params = load_params(m, cfg, "cpu", dtype=torch.float32)
    eng = Engine(cfg, params, n_slots=1, max_seq=64, opts=OPTS, kv_dtype=torch.float32,
                 device="cpu")
    return m, cfg, params, eng.run_to_completion(PROMPT, n_predict=12)


@pytest.mark.parametrize("n_resident", [0, 2, 4])
def test_streamed_matches_resident(model, n_resident):
    m, cfg, params, want = model
    head = {k: v for k, v in params.items() if k != "layers"}
    sm = build_streamed_model(lambda i: gguf_host_layer(m, cfg, i, torch.float32), head, cfg,
                              n_resident, "cpu")
    assert len(sm.resident) == n_resident and len(sm.streamed_host) == 4 - n_resident
    run = StreamedRunner(sm, batch=1, max_seq=64, opts=OPTS, kv_dtype=torch.float32)
    assert run.greedy_generate(PROMPT, 12) == want
    # every forward streams the streamed layers once, and releases them
    per_step = sum(layer_nbytes(h) for h in sm.streamed_host)
    before = run.uploads.bytes
    logits = run.forward(np.asarray([[want[-1]]]), np.asarray([[run.cache_pos[0]]]))
    assert run.uploads.bytes - before == per_step
    assert all(run._params["layers"][i] is None for i in range(n_resident, 4))
    # the same bits as the resident model at the same position
    ref = StreamedRunner(build_streamed_model(lambda i: params["layers"][i], head, cfg, 4,
                                              "cpu"), batch=1, max_seq=64, opts=OPTS,
                         kv_dtype=torch.float32)
    ref.greedy_generate(PROMPT, 12)
    assert np.array_equal(logits, ref.forward(np.asarray([[want[-1]]]),
                                              np.asarray([[ref.cache_pos[0]]])))


def test_host_layer_is_the_device_format(model):
    m, cfg, params, _ = model
    packed = pack_host_layer(gguf_host_layer(m, cfg, 2, torch.float32), pin=False)
    got, want = tensors_of(packed), tensors_of(params["layers"][2])
    assert len(got) == len(want) > 0
    assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
    assert layer_nbytes(packed) == sum(t.numel() * t.element_size() for t in want)



def test_only_streaming_slices_dequant(model, monkeypatch):
    """The dense dequant keeps one pass on the resident paths (the Engine,
    a ring rank with every layer on the device) and goes by slices of
    STREAM_DEQUANT_WEIGHTS where layers stream (StreamedRunner, a ring rank
    with streamed windows), with the same tokens."""
    m, cfg, params, want = model
    seen = []
    dequant = qtm.dequant
    monkeypatch.setattr(qtm, "dequant", lambda qt, dtype=torch.float32: (
        seen.append(getattr(qtm._slices, "weights", None)) or dequant(qt, dtype)))

    def budgets(run) -> set:
        seen.clear()
        assert run() == want[:3]
        return set(seen)

    head = {k: v for k, v in params.items() if k != "layers"}
    host = {i: pack_host_layer(params["layers"][i], pin=False) for i in (0, 1)}
    ring = lambda streamed: TcpRingEngine(
        RingContext(None, RingPlan([4], 1), 0, 1), cfg,
        dict(params, layers=[None if streamed and i in host else l
                             for i, l in enumerate(params["layers"])]),
        n_slots=1, max_seq=64, opts=OPTS, kv_dtype=torch.float32,
        streamed_host=host if streamed else None, device="cpu")
    eng = Engine(cfg, params, n_slots=1, max_seq=64, opts=OPTS, kv_dtype=torch.float32,
                 device="cpu")
    runner = StreamedRunner(build_streamed_model(lambda i: params["layers"][i], head, cfg,
                                                 2, "cpu"), batch=1, max_seq=64, opts=OPTS,
                            kv_dtype=torch.float32)
    assert budgets(lambda: eng.run_to_completion(PROMPT, n_predict=3)) == {None}
    assert budgets(lambda: ring(False).run_to_completion(PROMPT, n_predict=3)) == {None}
    # the head runs after the layers, outside the streamed forward: one pass
    assert budgets(lambda: runner.greedy_generate(PROMPT, 3)) == {STREAM_DEQUANT_WEIGHTS, None}
    assert budgets(lambda: ring(True).run_to_completion(PROMPT, n_predict=3)) \
        == {STREAM_DEQUANT_WEIGHTS, None}
    assert getattr(qtm._slices, "weights", None) is None
