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
