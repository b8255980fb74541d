"""The port's forward(taps=) against the JAX package's, in f32 on the same
seeded tokens: the same key set, the same row counts, and each per-column
sum of x^2 within 1e-5 of its largest value. The models: the trained tiny
llama (models_tiny_pair/target.gguf) loaded by each package's loader, the
same with fuse=True (the fused gate/up branch returns before the
ffn_down tap, so a fused layer has no ffn_down key), and the same weights
carried from the JAX params by params_from_numpy; tiny GGUFs of Mixtral
(no expert, router or shared-expert key), arctic (its dense FFN is
tapped), gemma2 and bitnet (tied embeddings; bitnet taps after its
sub-norms). A layer window or return_hidden gives no output.weight key,
taps accumulate over the calls that share the dict, and the kernel route
equals plain bit for bit on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.gguf.reader import GGUFModel as JGGUFModel
from prima_tpu.models.config import ModelConfig as JModelConfig
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import forward as jforward
from prima_tpu.models.llama import init_kv_caches as jinit_kv
from prima_tpu.models.llama import load_params as jload_params
from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.models.config import ModelConfig
from prima_tpu_torch.models.llama import (ForwardOptions, forward, init_kv_caches,
                                          load_params, params_from_numpy)
from test_torch_archs import F32, write_model
from test_torch_model import _flatten_jax
from test_torch_speculative import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
JOPTS = JOpts(matmul_impl="xla", dtype=jnp.float32)
OPTS = ForwardOptions(dtype=torch.float32)
TOL = 1e-5  # of the key's largest sum
B, S = 2, 7

PER_LAYER = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down")


def _keys(n_layers: int, drop=(), head: bool = True) -> set:
    keys = {f"blk.{i}.{n}.weight" for i in range(n_layers) for n in PER_LAYER if n not in drop}
    return keys | ({"output.weight"} if head else set())


def _load(path: str, fuse: bool = False, carry: bool = False) -> dict:
    jm = JGGUFModel.open(path)
    jcfg = JModelConfig.from_gguf(jm)
    jparams = jload_params(jm, jcfg, dtype=jnp.float32, fuse=fuse)
    pm = GGUFModel.open(path)
    cfg = ModelConfig.from_gguf(pm)
    params = (params_from_numpy(_flatten_jax(jparams), "cpu") if carry
              else load_params(pm, cfg, "cpu", dtype=torch.float32, fuse=fuse))
    return {"jcfg": jcfg, "jparams": jparams, "cfg": cfg, "params": params}


def _tokens(cfg, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.n_vocab, (B, S)).astype(np.int32)


def _jax_taps(m, toks, **kw) -> dict:
    def run(params):
        taps: dict = {}
        kv = jinit_kv(m["jcfg"], B, S, jnp.float32)
        jforward(params, m["jcfg"], toks, np.tile(np.arange(S, dtype=np.int32), (B, 1)), kv,
                 np.zeros(B, np.int32), JOPTS, taps=taps, **kw)
        return taps

    return {k: (np.asarray(s), int(c)) for k, (s, c) in
            jax.device_get(jax.jit(run)(m["jparams"])).items()}


def _port_taps(m, toks, opts=OPTS, taps=None, **kw) -> dict:
    taps = {} if taps is None else taps
    kv = init_kv_caches(m["cfg"], B, S, torch.float32, "cpu")
    with torch.no_grad():
        forward(m["params"], m["cfg"], torch.from_numpy(toks).long(),
                torch.arange(S, dtype=torch.int32).repeat(B, 1), kv,
                torch.zeros(B, dtype=torch.int32), opts, taps=taps, **kw)
    return taps


def _assert_same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, (ssq, cnt) in want.items():
        g, c = got[k]
        assert isinstance(c, int) and c == cnt, k
        g = g.numpy()
        assert g.shape == ssq.shape and g.dtype == np.float32, k
        assert np.abs(g - ssq).max() <= TOL * np.abs(ssq).max(), k


CASES = {
    # name: (loader kwargs or arch of write_model, per-layer keys absent)
    "llama": ({}, ()),
    "llama-fused": ({"fuse": True}, ("ffn_down",)),
    "llama-carried": ({"carry": True}, ()),
    "mixtral": ("mixtral", ("ffn_gate", "ffn_up", "ffn_down")),
    "arctic": ("arctic", ()),
    "gemma2": ("gemma2", ()),
    "bitnet": ("bitnet", ()),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    src, drop = CASES[request.param]
    if isinstance(src, dict):
        m = _load(TARGET, **src)
    else:
        m = _load(write_model(tmp_path_factory.mktemp(src) / f"{src}.gguf", src, F32))
    return request.param, m, drop


def test_taps_match_jax(case):
    name, m, drop = case
    toks = _tokens(m["cfg"])
    want = _jax_taps(m, toks)
    got = _port_taps(m, toks)
    assert set(got) == _keys(m["cfg"].n_layers, drop)
    _assert_same(got, want)
    assert all(c == B * S for _, c in got.values())
    layer = m["params"]["layers"][0]
    if name == "llama-fused":
        assert "wqkv" in layer and "w_gateup" in layer
    if name == "bitnet":
        assert layer.get("attn_sub_norm") is not None and layer.get("ffn_sub_norm") is not None
    if name in ("gemma2", "bitnet"):
        assert m["params"].get("output") is None  # tied: the head reads tok_embd


def test_kernel_route_equals_plain(case):
    _, m, _ = case
    toks = _tokens(m["cfg"], seed=5)
    plain = _port_taps(m, toks, ForwardOptions(matmul_impl="plain", dtype=torch.float32))
    kern = _port_taps(m, toks, ForwardOptions(matmul_impl="kernel", dtype=torch.float32))
    assert sorted(plain) == sorted(kern)
    for k in plain:
        assert kern[k][1] == plain[k][1] and torch.equal(kern[k][0], plain[k][0]), k


@pytest.fixture(scope="module")
def llama():
    return _load(TARGET)


def test_window_and_hidden_have_no_output_key(llama):
    m = llama
    n = m["cfg"].n_layers
    toks = _tokens(m["cfg"], seed=7)
    want = _jax_taps(m, toks, return_hidden=True)
    got = _port_taps(m, toks, return_hidden=True)
    assert set(got) == _keys(n, head=False)
    _assert_same(got, want)
    # the first half as a window: its layers' keys only
    kv = init_kv_caches(m["cfg"], B, S, torch.float32, "cpu")
    taps: dict = {}
    with torch.no_grad():
        forward(m["params"], m["cfg"], torch.from_numpy(toks).long(),
                torch.arange(S, dtype=torch.int32).repeat(B, 1), kv,
                torch.zeros(B, dtype=torch.int32), OPTS, layer_range=(0, n // 2), taps=taps)
    assert set(taps) == {k for k in _keys(n // 2, head=False)}
    for k in taps:
        assert torch.equal(taps[k][0], got[k][0]) and taps[k][1] == got[k][1], k


def test_taps_accumulate_over_calls(llama):
    m = llama
    a, b = _tokens(m["cfg"], seed=8), _tokens(m["cfg"], seed=9)
    taps = _port_taps(m, a)
    _port_taps(m, b, taps=taps)
    one, two = _port_taps(m, a), _port_taps(m, b)
    for k, (ssq, cnt) in taps.items():
        assert cnt == 2 * B * S
        assert torch.allclose(ssq, one[k][0] + two[k][0], rtol=1e-6, atol=0), k
