"""Quantized matmul of the port against the JAX package.

On the CPU the port's qmatmul takes the plain versions of the GEMV kernel
(fewer than 32 rows) and of the wide path (dequantize + one matmul); both
must match JAX's qmatmul_pallas (in interpret mode) and qmatmul_xla within
max |d| <= 1e-5 * max |y| in f32 (the sums run in another order).
tests/test_torch_cuda.py holds the CUDA kernel against its plain version
on the GPU."""

import numpy as np
import pytest
import torch

from prima_tpu.gguf.constants import GGMLType
from prima_tpu.quant.dequant_jax import QTensor as JQTensor
from prima_tpu.quant.dequant_jax import qmatmul_xla
from prima_tpu.quant.device_format import to_device_format as jto_device_format
from prima_tpu.quant.pallas.qmatmul import qmatmul_pallas
from prima_tpu.quant.quantize_np import quantize
from prima_tpu_torch.quant import qmatmul as qm
from prima_tpu_torch.quant.device_format import to_device_format
from prima_tpu_torch.quant.qtensor import QTensor, qmatmul_plain

N = 48
# (format, K, expected port scale layout)
CASES = [(GGMLType.Q4_K, 512, "packed"), (GGMLType.Q4_K, 256, "grouped"),
         (GGMLType.Q6_K, 512, "grouped"), (GGMLType.Q8_0, 512, "flat"),
         (GGMLType.Q4_0, 512, "flat"), (GGMLType.Q5_K, 512, "packed")]
TOL = 1e-5


def _weights(t, k, seed=0):
    w = np.random.default_rng(seed).standard_normal((N, k)).astype(np.float32) * 0.05
    return quantize(w, t)


@pytest.mark.parametrize("b", [1, 4, 40])
@pytest.mark.parametrize("t,k,mode", CASES, ids=lambda v: getattr(v, "name", str(v)))
def test_port_matches_jax(t, k, mode, b):
    raw = _weights(t, k)
    qt = QTensor.from_host(to_device_format(raw, t, k), "cpu")
    assert qm.scale_mode(qt) == mode
    jqt = JQTensor.from_host(jto_device_format(raw, t, k))
    x = np.random.default_rng(b).standard_normal((b, k)).astype(np.float32)
    want_pallas = np.asarray(qmatmul_pallas(x, jqt))
    want_xla = np.asarray(qmatmul_xla(x, jqt))
    for got in (qm.qmatmul(torch.from_numpy(x), qt), qmatmul_plain(torch.from_numpy(x), qt)):
        got = got.numpy()
        scale = np.abs(want_xla).max()
        assert np.abs(got - want_pallas).max() <= TOL * scale
        assert np.abs(got - want_xla).max() <= TOL * scale


@pytest.mark.parametrize("b", [1, 4, 8, 31])
@pytest.mark.parametrize("t,k,mode", CASES, ids=lambda v: getattr(v, "name", str(v)))
def test_factored_gemv_matches_jax(t, k, mode, b):
    """The kernel's arithmetic in plain PyTorch, sc * sum(q x) + bias * X_s
    with the sums of x taken once per sub-block, against the JAX package's
    qmatmul within 1e-5 * max |y| (the sums run in another order)."""
    raw = _weights(t, k)
    qt = QTensor.from_host(to_device_format(raw, t, k), "cpu")
    jqt = JQTensor.from_host(jto_device_format(raw, t, k))
    x = np.random.default_rng(100 + b).standard_normal((b, k)).astype(np.float32)
    want = np.asarray(qmatmul_xla(x, jqt))
    got = qm.qmatmul_factored_plain(torch.from_numpy(x), qt).numpy()
    assert got.shape == (b, N)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("n,row_bytes,b,layout,want", [
    (4096, 2048, 4, "nib4", (4, 512)),      # wq/wo: 32 row blocks x 4 slices
    (1024, 2048, 4, "nib4", (16, 128)),     # wk/wv: the narrow N, one stage a slice
    (14336, 2048, 4, "nib4", (2, 1024)),    # gate/up: the x staging area bounds the slice
    (4096, 7168, 4, "nib4", (7, 1024)),     # down: the same bound
    (128256, 2048, 4, "nib4", (2, 1024)),   # head: the x staging area bounds the slice
    (128256, 2048, 1, "nib4", (2, 1024)),   # nib4 stages 4 batch rows even at B = 1
    (4096, 7168, 8, "nib4", (14, 512)),     # B = 8 halves the slice
    (256, 256, 4, "int8", (2, 128)),        # the tiny pair
    (4096, 4096, 1, "int8", (4, 1024)),     # an 8-bit wq/wo
    (128256, 4096, 1, "int8", (4, 1024)),   # an 8-bit head: the scale words bound the slice
], ids=["wq", "wk", "gate", "down", "head", "head-b1", "down-b8", "tiny", "wq-int8",
        "head-int8"])
def test_gemv_split_is_a_pure_function_of_the_shapes(n, row_bytes, b, layout, want):
    ksplit, ksb = qm.gemv_split(n, row_bytes, b, layout)
    assert (ksplit, ksb) == want
    assert ksb % qm.STAGE_BYTES == 0 and (ksplit - 1) * ksb < row_bytes <= ksplit * ksb
    if layout == "nib4":  # both nibble halves, 4 or 8 batch rows (high and low parts)
        halves, nb = 2, 4 if b <= 4 else 8
    else:
        halves, nb = 1, min(8, 1 << (b - 1).bit_length())
    assert halves * nb * ksb <= qm.X_STAGE_FLOATS  # the staged slice of x fits
    assert ksb <= qm.MAX_SLICE_BYTES


def test_leading_dims_and_dtype():
    t, k = GGMLType.Q8_0, 256
    qt = QTensor.from_host(to_device_format(_weights(t, k), t, k), "cpu")
    x = torch.randn(2, 3, k, dtype=torch.bfloat16)
    y = qm.qmatmul(x, qt)
    assert y.shape == (2, 3, N) and y.dtype == torch.bfloat16


def test_cpu_tensor_takes_the_plain_version():
    """A CPU tensor never reaches the kernel: the plain version answers
    and no launch is counted. (On a CUDA tensor the wrapper launches or
    raises.)"""
    t, k = GGMLType.Q8_0, 256
    qt = QTensor.from_host(to_device_format(_weights(t, k), t, k), "cpu")
    x = torch.randn(3, k)
    before = qm.launches.count
    assert torch.equal(qm.qgemv(x, qt), qm.qmatmul_plain(x, qt))
    assert qm.launches.count == before
