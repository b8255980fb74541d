"""prima_tpu_torch.ops.layers against prima_tpu.ops.layers on the same
inputs, within 1e-6 in f32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.models.config import RopeScaling as JRopeScaling
from prima_tpu.models.config import tiny_config as jtiny_config
from prima_tpu.ops import layers as J
from prima_tpu_torch.models.config import RopeScaling, tiny_config
from prima_tpu_torch.ops import layers as P

ATOL = 1e-6
rng = np.random.default_rng(0)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_rms_norm():
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(P.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           J.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


SCALINGS = {
    "none": {},
    "linear": dict(kind="linear", factor=4.0),
    "yarn": dict(kind="yarn", factor=4.0, orig_ctx=64, ext_factor=1.0, attn_factor=1.0),
    "yarn-noext": dict(kind="yarn", factor=2.0, orig_ctx=64, ext_factor=0.0),
}


def _cfgs(scaling: str, **kw):
    s = SCALINGS[scaling]
    return (tiny_config(rope_scaling=RopeScaling(**s), **kw),
            jtiny_config(rope_scaling=JRopeScaling(**s), **kw))


@pytest.mark.parametrize("scaling", list(SCALINGS))
def test_rope_freqs(scaling):
    cfg, jcfg = _cfgs(scaling, rope_dim=32, head_dim=32, rope_base=500000.0)
    inv, m = P.rope_freqs(cfg)
    jinv, jm = J.rope_freqs(jcfg)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6, atol=0)
    assert m == pytest.approx(jm, rel=1e-7)


@pytest.mark.parametrize("rope_type", ["norm", "neox"])
@pytest.mark.parametrize("rope_dim", [16, 8])  # 8 = partial rotary
def test_apply_rope(rope_type, rope_dim):
    cfg, jcfg = _cfgs("yarn", rope_dim=rope_dim, head_dim=16)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 200, size=(2, 5)).astype(np.int32)
    inv, m = P.rope_freqs(cfg)
    jinv, jm = J.rope_freqs(jcfg)
    got = P.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), inv, rope_type, m)
    want = J.apply_rope(jnp.asarray(x), jnp.asarray(pos), jinv, rope_type, jm)
    _close(got, want, atol=4 * ATOL)  # |x| up to ~4: a few ulps of cos/sin


@pytest.mark.parametrize("weight,bias", [(True, True), (True, False), (False, False)])
def test_layer_norm(weight, bias):
    """LayerNorm, parametric or not (OLMo's norm has neither weight nor bias)."""
    x = (rng.standard_normal((2, 3, 64)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32) if weight else None
    b = rng.standard_normal(64).astype(np.float32) if bias else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    _close(P.layer_norm(torch.from_numpy(x), t(w), t(b), 1e-5),
           J.layer_norm(jnp.asarray(x), j(w), j(b), 1e-5), atol=4 * ATOL)


@pytest.mark.parametrize("n_heads", [4, 6, 12])  # 6, 12: the second slope regime
def test_alibi_slopes(n_heads):
    np.testing.assert_array_equal(P.alibi_slopes(n_heads, 8.0).numpy(),
                                  J.alibi_slopes(n_heads, 8.0))


def test_alibi_mask():
    pos = np.array([[3, 4, 5], [0, 1, 9]], np.int32)
    np.testing.assert_array_equal(P.alibi_mask(torch.from_numpy(pos), 12).numpy(),
                                  np.asarray(J.alibi_mask(jnp.asarray(pos), 12)))


@pytest.mark.parametrize("with_lens", [False, True])
def test_causal_mask(with_lens):
    pos = np.array([[3, 4, 5], [0, 1, 9]], np.int32)
    lens = np.array([5, 8], np.int32) if with_lens else None
    got = P.causal_mask(torch.from_numpy(pos), 12,
                        None if lens is None else torch.from_numpy(lens))
    want = J.causal_mask(jnp.asarray(pos), 12, None if lens is None else jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_lens,swa", [(False, 3), (True, 4)])
def test_sliding_window_mask(with_lens, swa):
    """gemma2's KQ_mask_swa: slots older than the window are hidden too."""
    pos = np.array([[3, 4, 5], [0, 1, 9]], np.int32)
    lens = np.array([5, 8], np.int32) if with_lens else None
    got = P.causal_mask(torch.from_numpy(pos), 12,
                        None if lens is None else torch.from_numpy(lens), swa_window=swa)
    want = J.causal_mask(jnp.asarray(pos), 12, None if lens is None else jnp.asarray(lens),
                         swa_window=swa)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("softcap,alibi", [(0.5, False), (0.0, True), (30.0, True)])
def test_gqa_attention_softcap_and_alibi(softcap, alibi):
    """gemma2's softcapped scores; ALiBi's per-head slopes over the
    distance mask."""
    b, s, t, n_heads, n_kv, hd = 2, 3, 10, 8, 2, 16
    q = rng.standard_normal((b, s, n_heads, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, n_kv, hd)).astype(np.float32)
    pos = np.array([[6, 7, 8], [2, 3, 4]], np.int32)
    mask = (J.alibi_mask if alibi else J.causal_mask)(jnp.asarray(pos), t)
    slopes = J.alibi_slopes(n_heads, 8.0) if alibi else None
    got = P.gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(np.array(mask)), 0.25, softcap,
                          None if slopes is None else torch.from_numpy(slopes))
    want = J.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, 0.25,
                           softcap, None if slopes is None else jnp.asarray(slopes))
    _close(got, want, atol=2 * ATOL)


@pytest.mark.parametrize("n_heads,n_kv,s", [(4, 2, 3), (8, 8, 1), (8, 1, 4)])
def test_gqa_attention(n_heads, n_kv, s):
    b, t, hd = 2, 10, 16
    q = rng.standard_normal((b, s, n_heads, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, n_kv, hd)).astype(np.float32)
    pos = np.array([[6 + i for i in range(s)], [2 + i for i in range(s)]], np.int32)
    mask = J.causal_mask(jnp.asarray(pos), t)
    got = P.gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(np.array(mask)), 0.25)
    want = J.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, 0.25)
    _close(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_gated_act(act):
    g = rng.standard_normal((3, 40)).astype(np.float32)
    u = rng.standard_normal((3, 40)).astype(np.float32)
    _close(P.gated_act(torch.from_numpy(g), torch.from_numpy(u), act),
           J.gated_act(jnp.asarray(g), jnp.asarray(u), act))


def test_config_copy_is_the_same_dataclass_shape():
    """The port's ModelConfig copy carries the JAX package's fields."""
    from prima_tpu.models.config import ModelConfig as JModelConfig
    from prima_tpu_torch.models.config import ModelConfig

    assert ([f.name for f in dataclasses.fields(ModelConfig)]
            == [f.name for f in dataclasses.fields(JModelConfig)])
