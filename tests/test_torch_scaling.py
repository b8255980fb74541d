"""The port's copy of profiler/scaling.py against the JAX package's: every
projection function gives the same dict on a grid of inputs."""

import pytest

from prima_tpu.profiler import scaling as jscaling
from prima_tpu_torch.profiler import scaling

HOPS = [dict(gbs=45.0, lat_s=1e-6, name="ici"), dict(gbs=0.01, lat_s=5e-3, name="slow"),
        dict(gbs=1e9, lat_s=0.0, name="free")]


@pytest.mark.parametrize("hop", HOPS, ids=[h["name"] for h in HOPS])
def test_projections_equal_the_jax_package(hop):
    h, jh = scaling.HopProfile(**hop), jscaling.HopProfile(**hop)
    assert h.seconds(8192) == jh.seconds(8192)
    for n in (1, 2, 4, 8):
        for act in (8192, 1 << 20):
            assert scaling.pipeline_projection(0.012, n, h, act) == \
                jscaling.pipeline_projection(0.012, n, jh, act)
            assert scaling.pipeline_projection(0.012, n, h, act, hbm_fit=False) == \
                jscaling.pipeline_projection(0.012, n, jh, act, hbm_fit=False)
            assert scaling.ring_allreduce_seconds(act, n, h) == \
                jscaling.ring_allreduce_seconds(act, n, jh)
            assert scaling.tp_projection(0.012, n, h, act, 32) == \
                jscaling.tp_projection(0.012, n, jh, act, 32)
        assert scaling.capacity_projection(16e9, n, 13e9, 819.0, 10.0) == \
            jscaling.capacity_projection(16e9, n, 13e9, 819.0, 10.0)


@pytest.mark.parametrize("baseline", [None, 12.5])
def test_project_all_equals_the_jax_package(baseline):
    dcn = dict(gbs=12.0, lat_s=2e-5, name="dcn")
    got = scaling.project_all(11.9, 4096, 32, 4.6, batch=2, dcn=scaling.HopProfile(**dcn),
                              baseline_ms_tok=baseline)
    want = jscaling.project_all(11.9, 4096, 32, 4.6, batch=2,
                                dcn=jscaling.HopProfile(**dcn), baseline_ms_tok=baseline)
    assert got == want
    assert scaling.ICI_V5E_NOMINAL.__dict__ == jscaling.ICI_V5E_NOMINAL.__dict__
