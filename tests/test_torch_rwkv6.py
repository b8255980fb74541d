"""RWKV-6 (models/rwkv6.py) in the port against the JAX package's runtime
on the same tiny GGUFs (converted from an RWKV-6 checkpoint with a world
vocabulary): teacher-forced logits within 1e-4 * max |logit| (f32, and
Q8_0) and equal greedy streams, with and without rescale_every; token-by-
token decode with the carried state equal to the full forward;
params_from_numpy of the JAX params; the CLIs' stdout; no silent CPU
fallback."""

import functools

import jax
import numpy as np
import pytest
import torch

import prima_tpu.models.rwkv6 as jrw
import prima_tpu_torch.models.rwkv6 as rw
from prima_tpu.gguf.reader import GGUFModel
from prima_tpu.tools.cli import main as jcli
from prima_tpu.tools.convert_hf import convert_hf_to_gguf
from prima_tpu.tools.quantize import quantize_gguf
from prima_tpu_torch.models.llama import params_from_numpy
from prima_tpu_torch.tools.cli import main as cli
from torch_families import convert, hf_rwkv6, rel_err

TOL = 1e-4  # f32: the same expressions, sums in another order
TOKENS = [[3, 11, 25, 7, 42, 5], [9, 17, 60, 2, 33, 12]]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rwkv6")
    rescale = convert(convert_hf_to_gguf, hf_rwkv6(str(d / "hf"), rescale_every=2, n_layers=4),
                      str(d / "rwkv6.gguf"))
    plain = convert(convert_hf_to_gguf, hf_rwkv6(str(d / "hf0"), rescale_every=0),
                    str(d / "rwkv6_0.gguf"))
    q8 = str(d / "rwkv6_q8.gguf")
    with open(str(d / "q.log"), "w") as log:
        quantize_gguf(rescale, q8, "Q8_0", logfile=log)
    return {"rescale2": rescale, "no_rescale": plain, "q8_0": q8}


@functools.lru_cache(maxsize=None)
def _pair(path):
    return jrw.Rwkv6Runtime.load(path), rw.Rwkv6Runtime.load(path, device="cpu")


@pytest.mark.parametrize("name", ["rescale2", "no_rescale", "q8_0"])
def test_logits_and_greedy_match_jax(files, name):
    jrt, prt = _pair(files[name])
    assert vars(prt.cfg) == vars(jrt.cfg)
    assert prt.cfg.rescale_every == (0 if name == "no_rescale" else 2)
    toks = np.asarray(TOKENS, np.int32)
    want, _ = jrw.rwkv6_forward(jrt.params, jrt.cfg, toks)
    with torch.no_grad():
        got, state = rw.rwkv6_forward(prt.params, prt.cfg, toks)
    assert rel_err(got.numpy(), np.asarray(want)) <= TOL
    assert tuple(state[0]["wkv"].shape) == (2, 4, 8, 8)
    prompt = [3, 11, 25]
    stream = prt.generate(prompt, n_predict=16)
    assert stream == jrt.generate(prompt, n_predict=16) and len(set(stream)) > 3


def test_rescale_halves_the_stream(files):
    """rescale_every 2 over 4 layers halves the residual after layer 2: the
    logits differ from the same weights without it."""
    _, prt = _pair(files["rescale2"])
    cfg = rw.Rwkv6Config(**dict(vars(prt.cfg), rescale_every=0))
    with torch.no_grad():
        a, _ = rw.rwkv6_forward(prt.params, prt.cfg, TOKENS)
        b, _ = rw.rwkv6_forward(prt.params, cfg, TOKENS)
    assert rel_err(a.numpy(), b.numpy()) > 1e-3


@pytest.mark.parametrize("name", ["rescale2", "no_rescale"])
def test_stateful_decode_equals_full_forward(files, name):
    _, prt = _pair(files[name])
    toks = [3, 11, 25, 7, 42, 5, 9, 17]
    with torch.no_grad():
        full, _ = rw.rwkv6_forward(prt.params, prt.cfg, [toks])
        state = rw.init_rwkv6_state(prt.cfg, 1)
        steps = []
        for t in toks:
            lg, state = rw.rwkv6_forward(prt.params, prt.cfg, [[t]], state)
            steps.append(lg[0, 0])
    assert rel_err(torch.stack(steps).numpy(), full[0].numpy()) <= TOL


def test_params_from_numpy_carries_jax_params(files):
    m = GGUFModel.open(files["rescale2"])
    cfg = jrw.Rwkv6Config.from_gguf(m)
    jparams = jrw.load_rwkv6_params(m, cfg)
    m.close()
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    assert tuple(params["layers"][0]["first"].shape) == (4, 8)
    toks = np.asarray(TOKENS, np.int32)
    want, _ = jrw.rwkv6_forward(jparams, cfg, toks)
    with torch.no_grad():
        got, _ = rw.rwkv6_forward(params, rw.Rwkv6Config(**vars(cfg)), toks)
    assert rel_err(got.numpy(), np.asarray(want)) <= TOL


def test_cli_prints_jax_text(files, capsys):
    args = ["-m", files["rescale2"], "-p", "hello there", "-n", "12"]
    assert jcli(args) == 0
    want = capsys.readouterr().out
    assert cli(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello there") and len(got) > len("hello there")


def test_cuda_asked_without_gpu_raises(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rw.Rwkv6Runtime.load(files["rescale2"])
