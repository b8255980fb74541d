"""The port's device profiler against the JAX package's: a DeviceProfile
crosses between the packages through to_dict / from_dict with every field
equal (the format the ring's bootstrap gathers), and the CPU profile has
the JAX package's fields, filled."""

import dataclasses

import pytest

from prima_tpu.profiler.device import DeviceProfile as JDeviceProfile
from prima_tpu_torch import resolve_device
from prima_tpu_torch.profiler import device as pdev
from prima_tpu_torch.profiler.device import DeviceProfile, print_device_props, profile_device
from test_torch_speculative import torch_one_thread  # noqa: F401


def _sample() -> DeviceProfile:
    names = [f.name for f in dataclasses.fields(DeviceProfile)]
    kw = {}
    for i, f in enumerate(dataclasses.fields(DeviceProfile)):
        kw[f.name] = {str: f"v{i}", int: 1000 + i, float: 0.5 + i}[type(f.default)]
    assert len(kw) == len(names)
    return DeviceProfile(**kw)


def test_profile_crosses_packages():
    p = _sample()
    j = JDeviceProfile.from_dict(p.to_dict())
    assert j.to_dict() == p.to_dict()
    back = DeviceProfile.from_dict(j.to_dict())
    assert back == p
    assert [f.name for f in dataclasses.fields(DeviceProfile)] == \
        [f.name for f in dataclasses.fields(JDeviceProfile)]
    # unknown keys from a newer peer are dropped, as the JAX package drops them
    assert DeviceProfile.from_dict(dict(p.to_dict(), extra=1)) == p


def test_cpu_profile_has_the_jax_fields(monkeypatch):
    monkeypatch.setattr(pdev, "_bench_host_ram_bw", lambda mb=512: 7.0)
    p = profile_device(device="cpu", full=False)
    assert set(p.to_dict()) == set(JDeviceProfile().to_dict())
    assert p.platform == "cpu" and p.n_devices == 1
    assert p.flops_bf16 > 0 and p.flops_f32 > 0
    assert p.hbm_total >= p.hbm_free > 0 and p.host_ram_total > 0
    assert p.ici_hop_gbs == p.ici_hop_lat_s == 0.0
    assert "TCP hop" in print_device_props(p)


def test_full_cpu_benches(monkeypatch):
    """The benches `full` adds, at small sizes: the Q4_K GEMV's plain
    version, the read probe's, the TCP hop."""
    cpu = resolve_device("cpu")
    assert pdev._bench_qmm_flops(cpu, 256, 256, inner=2) > 0
    assert pdev._bench_hbm_bw(cpu, mb=4) > 0
    gbs, lat = pdev._bench_tcp_hop(payload_mb=1)
    assert gbs > 0 and 0 < lat < 1.0


def test_profile_needs_a_device_unless_asked_for_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_device(full=False)
