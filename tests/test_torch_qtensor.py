"""prima_tpu_torch.quant.qtensor against the JAX package: dequantization is
bit-exact in f32 for every format the llama path loads, and JAX QTensors
(sigma-permuted, packed) carry across unchanged through params_from_numpy."""

import os

import numpy as np
import pytest
import torch

from prima_tpu.quant.dequant_jax import QTensor as JQTensor
from prima_tpu.quant.dequant_jax import dequant as jdequant
from prima_tpu.quant.device_format import SUPPORTED_TYPES, dequant_uq_np
from prima_tpu.quant.device_format import to_device_format as jto_device_format
from prima_tpu_torch.models.llama import params_from_numpy
from prima_tpu_torch.quant.device_format import to_device_format
from prima_tpu_torch.quant.qtensor import QTensor, dequant, dequant_rows

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TYPES = sorted(SUPPORTED_TYPES, key=int)


def _golden(t):
    g = np.load(os.path.join(GOLDEN, f"dequant_{t.name.lower()}.npz"))
    n = int(g["n_per_row"])
    return g["raw"].reshape(4, -1), g["expected"].reshape(4, n // 4)


def jqt_to_dict(qt) -> dict:
    """A JAX QTensor as plain numpy fields + metadata (what the port's
    params_from_numpy takes)."""
    arr = lambda a: None if a is None else np.asarray(a)
    return {"qs": arr(qt.qs), "scales": arr(qt.scales), "mins": arr(qt.mins),
            "d": arr(qt.d), "dmin": arr(qt.dmin), "sub": qt.sub, "layout": qt.layout,
            "q_offset": qt.q_offset, "shape": qt.shape, "kperm": qt.kperm,
            "gsub": qt.gsub, "packed": qt.packed}


@pytest.mark.parametrize("t", TYPES, ids=lambda t: t.name)
def test_dequant_bitexact(t):
    raw, expected = _golden(t)
    k = expected.shape[1]
    uq = to_device_format(raw, t, k)
    juq = jto_device_format(raw, t, k)
    for a, b in zip((uq.qs, uq.scales, uq.mins, uq.d, uq.dmin),
                    (juq.qs, juq.scales, juq.mins, juq.d, juq.dmin)):
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
    qt = QTensor.from_host(uq, "cpu")
    got = dequant(qt).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, expected)
    assert np.array_equal(got, dequant_uq_np(juq))
    assert np.array_equal(got, np.asarray(jdequant(JQTensor.from_host(juq))))


@pytest.mark.parametrize("t", TYPES, ids=lambda t: t.name)
def test_dequant_rows_bitexact(t):
    raw, expected = _golden(t)
    qt = QTensor.from_host(to_device_format(raw, t, expected.shape[1]), "cpu")
    ids = torch.tensor([[3, 0], [1, 3]])
    got = dequant_rows(qt, ids).numpy()
    assert np.array_equal(got, expected[ids.numpy()])


def test_q4_k_packs_to_native_footprint():
    """Q4_K at S % 16 == 0 packs to 4.5 bits per weight; at S % 16 != 0 it
    keeps int8 codes with f32 bases (4.75 bits per weight)."""
    from prima_tpu.gguf.constants import GGMLType
    from prima_tpu.quant.quantize_np import quantize

    rng = np.random.default_rng(0)
    for k, packed, bpw in ((4096, True, 4.5), (256, False, 4.75)):
        x = rng.standard_normal((8, k)).astype(np.float32)
        qt = QTensor.from_host(to_device_format(quantize(x, GGMLType.Q4_K),
                                                GGMLType.Q4_K, k), "cpu")
        assert qt.packed is packed
        assert qt.nbytes * 8 / qt.qs.shape[0] / k == bpw


@pytest.mark.parametrize("pallas", [True, False], ids=["kperm", "natural"])
@pytest.mark.parametrize("t", TYPES, ids=lambda t: t.name)
def test_params_from_numpy_roundtrip(t, pallas):
    """A JAX QTensor (sigma order and packed codes where the JAX package
    chooses them) crosses as numpy and dequantizes to the same matrix."""
    raw, expected = _golden(t)
    jqt = JQTensor.from_host(jto_device_format(raw, t, expected.shape[1]), pallas=pallas)
    qt = params_from_numpy({"w": jqt_to_dict(jqt)}, "cpu")["w"]
    assert isinstance(qt, QTensor)
    assert np.array_equal(dequant(qt).numpy(), np.asarray(jdequant(jqt)))


def test_params_from_numpy_kperm_narrow_q4_k():
    """Width 256: sigma-permuted but not packed in the JAX package."""
    from prima_tpu.gguf.constants import GGMLType
    from prima_tpu.quant.quantize_np import quantize

    x = np.random.default_rng(1).standard_normal((16, 256)).astype(np.float32)
    jqt = JQTensor.from_host(jto_device_format(quantize(x, GGMLType.Q4_K),
                                               GGMLType.Q4_K, 256))
    assert jqt.kperm and not jqt.packed
    qt = params_from_numpy(jqt_to_dict(jqt), "cpu")
    assert np.array_equal(dequant(qt).numpy(), np.asarray(jdequant(jqt)))


@pytest.mark.parametrize("fmt", ["Q4_K", "Q8_0", "Q6_K", "Q4_0", "Q5_K"])
def test_dequant_by_row_slices_equals_one_pass(fmt, monkeypatch):
    """Inside dequant_slices, dequant() works through slices of rows to
    bound its temporaries, with the bits of one pass over the whole
    matrix; outside it, dequant() is one pass."""
    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.models.llama import synth_qtensor_device
    from prima_tpu_torch.quant import qtensor as qtm

    gen = torch.Generator()
    gen.manual_seed(5)
    qt = synth_qtensor_device(gen, 300, 512, GGMLType[fmt], "cpu")
    passes = []
    one_pass = qtm._dequant_any
    monkeypatch.setattr(qtm, "_dequant_any", lambda *a: passes.append(1) or one_pass(*a))
    with qtm.dequant_slices(512 * 7):  # 7 rows a slice, a ragged last
        sliced = [qtm.dequant(qt, dt) for dt in (torch.float32, torch.bfloat16)]
    assert len(passes) == 2 * 43
    passes.clear()
    whole = [qtm.dequant(qt, dt) for dt in (torch.float32, torch.bfloat16)]
    assert len(passes) == 2
    assert all(torch.equal(a, b) for a, b in zip(sliced, whole))
