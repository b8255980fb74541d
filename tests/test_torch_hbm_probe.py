"""The port's device-memory read probe (utils/hbm_probe.py). On the CPU
its wrapper takes the plain version; tests/test_torch_cuda.py holds the
kernel against it on the card."""

import numpy as np
import pytest
import torch

from prima_tpu_torch.utils import hbm_probe


@pytest.mark.parametrize("n", [4, 1000, 1 << 16])
def test_plain_sum_is_the_exact_int64_sum_of_the_words(n):
    words = np.random.default_rng(n).integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
    x = torch.from_numpy(words.astype(np.int32))
    assert int(hbm_probe.read_sum_plain(x)) == int(words.sum())
    # any dtype: the bytes are taken as int32 words
    assert int(hbm_probe.read_sum_plain(x.view(torch.uint8))) == int(words.sum())


def test_cpu_tensor_takes_the_plain_version():
    x = torch.arange(64, dtype=torch.int32)
    before = hbm_probe.launches.count
    assert int(hbm_probe.read_sum(x)) == 2016
    assert hbm_probe.launches.count == before


def test_measure_needs_the_card():
    with pytest.raises(ValueError):
        hbm_probe.measure(device="cpu", nbytes=1 << 10)
