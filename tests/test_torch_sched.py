"""The port's copy of the layer-window solver and the model cost against
the JAX package: the same w, n, k and removed devices (and the same
failures) for the cases of tests/test_scheduler.py, and the same
model_cost_from_gguf on a tiny GGUF."""

import dataclasses

import pytest

from prima_tpu.gguf.reader import GGUFModel as JGGUFModel
from prima_tpu.profiler.device import DeviceProfile as JDeviceProfile
from prima_tpu.profiler.model_cost import ModelCost as JModelCost
from prima_tpu.profiler.model_cost import model_cost_from_gguf as jmodel_cost
from prima_tpu.sched import InfeasibleError as JInfeasible
from prima_tpu.sched import assign_layers as jassign
from prima_tpu.sched import assign_layers_and_select_devices as jselect
from prima_tpu.tools.make_tiny_gguf import make_tiny_gguf
from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.profiler.device import DeviceProfile
from prima_tpu_torch.profiler.model_cost import ModelCost, model_cost_from_gguf
from prima_tpu_torch.sched import InfeasibleError, assign_layers, assign_layers_and_select_devices

GiB = 1 << 30


def _prof(tflops=100.0, hbm_bw=800.0, hbm_free=16 * GiB, h2d=5.0, ram=64 * GiB, disk=1.0,
          **kw):
    return DeviceProfile(platform="cuda", flops_bf16=tflops, flops_f32=tflops / 2,
                         flops_q4k_dequant=tflops / 2, hbm_bw=hbm_bw, h2d_bw=h2d,
                         host_ram_bw=50.0, disk_seq_bw=disk, disk_rand_bw=disk / 10,
                         hbm_total=hbm_free, hbm_free=hbm_free, host_ram_total=ram,
                         host_ram_avail=ram, dispatch_latency_s=1e-4, **kw)


def _cost(n_layers=32, layer_mb=170, head_mb=800):
    return ModelCost(n_layers=n_layers, layer_flops={12: 2 * 200e6},
                     head_flops={12: 2 * 500e6}, layer_bytes=layer_mb * 2**20,
                     head_bytes=head_mb * 2**20, largest_tensor_bytes=60 * 2**20,
                     n_params=8_000_000_000, n_embd_k_gqa=1024, n_embd_v_gqa=1024)


AWFUL = dict(tflops=0.01, hbm_bw=0.5, h2d=0.001, hbm_free=GiB // 16, ram=1 * GiB, disk=0.01)
# (name, profiles, cost, keyword arguments, select devices)
CASES = [
    ("homogeneous", [_prof() for _ in range(4)], _cost(32), {"n_ctx": 4096}, False),
    ("single", [_prof()], _cost(32), {"n_ctx": 4096}, False),
    ("fast_slow", [_prof(hbm_bw=1600.0, tflops=200.0), _prof(hbm_bw=200.0, tflops=25.0)],
     _cost(32), {"n_ctx": 4096}, False),
    ("hbm_forces_streaming", [_prof(hbm_free=1 * GiB)], _cost(32), {"n_ctx": 512}, False),
    ("weak_removed", [_prof(), _prof(**AWFUL)], _cost(32), {"n_ctx": 1024}, True),
    ("weak_master_kept", [_prof(tflops=0.05, hbm_bw=2.0, h2d=0.01, hbm_free=GiB,
                                ram=4 * GiB), _prof()], _cost(32), {"n_ctx": 1024}, True),
    ("force_k", [_prof(), _prof()], _cost(32), {"n_ctx": 1024, "force_k": 4}, False),
    ("force_k_15", [_prof(), _prof()], _cost(30), {"n_ctx": 512, "force_k": 15}, False),
    ("master_priority_pull", [_prof(), _prof()], _cost(32),
     {"n_ctx": 512, "master_priority": 10.0}, False),
    ("master_priority_push", [_prof(), _prof()], _cost(32),
     {"n_ctx": 512, "master_priority": 0.1}, False),
    ("overload_fit", [_prof(), _prof(tflops=50, hbm_bw=400, h2d=5.0, hbm_free=8 * GiB,
                                     ram=GiB // 2, disk=0.5)], _cost(32), {"n_ctx": 512},
     False),
    ("hop_cost_fast", [_prof(hbm_free=4 * GiB, tcp_hop_gbs=10.0, tcp_hop_lat_s=20e-6)
                       for _ in range(4)], _cost(32, layer_mb=400), {"n_ctx": 2048}, False),
    ("hop_cost_slow", [_prof(hbm_free=4 * GiB, tcp_hop_gbs=0.001, tcp_hop_lat_s=0.25)
                       for _ in range(4)], _cost(32, layer_mb=400), {"n_ctx": 2048}, False),
    ("darwin_disk", [dataclasses.replace(_prof(disk=2.0, hbm_free=2 * GiB), os="Darwin"),
                     _prof(disk=2.0, hbm_free=2 * GiB)], _cost(32), {"n_ctx": 2048}, True),
]


def _jax_side(profiles, cost):
    return ([JDeviceProfile.from_dict(p.to_dict()) for p in profiles],
            JModelCost(**dataclasses.asdict(cost)))


@pytest.mark.parametrize("name,profiles,cost,kw,select", CASES, ids=[c[0] for c in CASES])
def test_schedule_matches_jax(name, profiles, cost, kw, select):
    jprofiles, jcost = _jax_side(profiles, cost)
    fn, jfn = (assign_layers_and_select_devices, jselect) if select else (assign_layers,
                                                                          jassign)
    got, want = fn(profiles, cost, **kw), jfn(jprofiles, jcost, **kw)
    assert (got.w, got.n, got.k) == (want.w, want.n, want.k)
    assert got.device_class == want.device_class
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert sum(got.w) * got.k == cost.n_layers
    if name == "weak_removed":
        assert got.w[1] == 0  # removed, as the JAX package removes it
    if name == "hbm_forces_streaming":
        assert got.n[0] < got.w[0]
    if name == "hop_cost_slow":
        assert got.k == 1


def test_infeasible_raises_in_both():
    p = _prof(hbm_free=1 * 2**20, ram=2 * 2**20, disk=0.0, h2d=0.0)
    jprofiles, jcost = _jax_side([p], _cost(32))
    with pytest.raises(InfeasibleError):
        assign_layers([p], _cost(32), n_ctx=4096, force_k=1)
    with pytest.raises(JInfeasible):
        jassign(jprofiles, jcost, n_ctx=4096, force_k=1)


def test_model_cost_from_gguf_matches_jax(tmp_path):
    path = make_tiny_gguf(str(tmp_path / "tiny.gguf"), n_layers=3, seed=1)
    got = model_cost_from_gguf(GGUFModel.open(path))
    want = jmodel_cost(JGGUFModel.open(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_bytes > 0 and got.compute_buf_bytes(512) == want.compute_buf_bytes(512)
