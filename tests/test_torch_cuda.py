"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips without one. The machine with
the card has no JAX, so run this file without the suite's conftest (which
configures JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from prima_tpu_torch.gguf.constants import GGMLType
from prima_tpu_torch.models.llama import synth_qtensor_device
from prima_tpu_torch.ops import kv_write as kvw
from prima_tpu_torch.quant import qmatmul as qm
from prima_tpu_torch.quant.device_format import SUPPORTED_TYPES, to_device_format
from prima_tpu_torch.quant.qtensor import QTensor

pytestmark = pytest.mark.cuda

# (format, K, scale layout the port picks)
FORMATS = [(GGMLType.Q4_K, 512, "packed"), (GGMLType.Q4_K, 256, "grouped"),
           (GGMLType.Q6_K, 512, "grouped"), (GGMLType.Q8_0, 512, "flat"),
           (GGMLType.Q4_0, 512, "flat"), (GGMLType.Q5_K, 512, "packed")]
GEMV_TOL = 1e-4  # max |kernel - plain| / max |plain| in f32: sums in another order
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _weights(dev, t, n, k, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return synth_qtensor_device(gen, n, k, t, dev)


@pytest.mark.parametrize("n", [48, 259])  # 259: a ragged row count (tiny-pair head)
@pytest.mark.parametrize("b", [1, 4, 31])
@pytest.mark.parametrize("t,k,mode", FORMATS, ids=lambda v: getattr(v, "name", str(v)))
def test_qgemv_matches_plain(dev, t, k, mode, b, n):
    qt = _weights(dev, t, n, k)
    assert qm.scale_mode(qt) == mode
    x = torch.randn(b, k, device=dev)
    before = qm.launches.count
    y = qm.qgemv(x, qt)
    ref = qm.qmatmul_plain(x, qt)
    torch.cuda.synchronize()
    assert qm.launches.count == before + 1
    assert (y - ref).abs().max().item() <= GEMV_TOL * ref.abs().max().item()


@pytest.mark.parametrize("b", [1, 4, 31])
@pytest.mark.parametrize("t", sorted(SUPPORTED_TYPES, key=int), ids=lambda t: t.name)
def test_qgemv_on_gguf_blocks(dev, t, b):
    """Every format load_params routes to the GEMV, from real GGUF block
    bytes through to_device_format and QTensor.from_host, as a model file
    loads them (37 rows: a ragged row count)."""
    g = np.load(os.path.join(GOLDEN, f"dequant_{t.name.lower()}.npz"))
    k = int(g["n_per_row"]) // 4
    raw = np.tile(g["raw"].reshape(4, -1), (10, 1))[:37]
    qt = QTensor.from_host(to_device_format(raw, t, k), dev)
    x = torch.randn(b, k, generator=torch.Generator().manual_seed(b)).to(dev)
    before = qm.launches.count
    y = qm.qgemv(x, qt)
    ref = qm.qmatmul_plain(x, qt)
    torch.cuda.synchronize()
    assert qm.launches.count == before + 1
    assert (y - ref).abs().max().item() <= GEMV_TOL * ref.abs().max().item()


def test_qmatmul_routes_wide_inputs_to_plain(dev):
    qt = _weights(dev, GGMLType.Q4_K, 64, 512)
    before = qm.launches.count
    y = qm.qmatmul(torch.randn(40, 512, device=dev, dtype=torch.bfloat16), qt)
    assert y.shape == (40, 64) and y.dtype == torch.bfloat16
    assert qm.launches.count == before  # B >= 32: dequantize + matmul
    qm.qmatmul(torch.randn(2, 3, 512, device=dev), qt)
    assert qm.launches.count == before + 1


def test_qgemv_rejects_what_it_cannot_take(dev):
    qt = _weights(dev, GGMLType.Q8_0, 64, 512)
    with pytest.raises(ValueError):
        qm.qgemv(torch.randn(4, 512, device=dev, dtype=torch.bfloat16), qt)
    with pytest.raises(ValueError):
        qm.qgemv(torch.randn(33, 512, device=dev), qt)
    with pytest.raises(ValueError):
        qm.qgemv(torch.randn(512, 4, device=dev).t(), qt)


KV_CASES = [(4, 1, 2048, 1024, [5, 700, 2047, 1300]), (1, 128, 2048, 1024, [256]),
            (4, 8, 64, 1024, [60, 0, 3000, 17]), (4, 1, 512, 256, [0, 1, 2, 511]),
            (4, 1, 512, 128, [3, 9, 27, 81]), (2, 3, 16, 24, [1, 14])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("b,s,t,p,pos", KV_CASES)
def test_kv_write_matches_plain(dev, b, s, t, p, pos, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cache = (torch.randn((b, t, p), generator=gen, device=dev) * 20).to(dtype)
    new = (torch.randn((b, s, p), generator=gen, device=dev) * 20).to(dtype)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = kvw.launches.count
    got = kvw.kv_write(cache.clone(), new, pos_t)
    want = kvw.kv_write_plain(cache.clone(), new, pos_t)
    torch.cuda.synchronize()
    assert kvw.launches.count == before + 1
    assert torch.equal(got, want)


def test_kv_write_on_a_slot_row_view(dev):
    """The engine's prefill writes one slot's row of a wider cache."""
    big = torch.zeros((3, 32, 4, 64), dtype=torch.bfloat16, device=dev)
    new = torch.randn((1, 5, 4, 64), device=dev).to(torch.bfloat16)
    pos = torch.tensor([30], dtype=torch.int32, device=dev)
    kvw.kv_write(big[1:2], new, pos)
    want = kvw.kv_write_plain(torch.zeros_like(big[1:2]), new, pos)
    torch.cuda.synchronize()
    assert torch.equal(big[1:2], want)
    assert not big[0].any() and not big[2].any()


def test_kv_write_rejects_host_positions_and_dtype_mismatch(dev):
    cache = torch.zeros((2, 16, 8), device=dev)
    new = torch.ones((2, 1, 8), device=dev)
    with pytest.raises(ValueError):
        kvw.kv_write(cache, new, torch.tensor([0, 1], dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        kvw.kv_write(cache, new.half(), torch.tensor([0, 1], dtype=torch.int32, device=dev))
