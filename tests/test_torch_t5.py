"""T5 (models/t5.py) in the port against the JAX package's runtime on the
same tiny GGUFs: encoder hidden states and teacher-forced decoder logits
within 1e-4 * max |logit| (f32, and Q8_0) and equal greedy streams, for a
ReLU T5 with tied embeddings (the d_model^-0.5 head scale) and a gated-GELU
T5 with its own head; params_from_numpy of the JAX params (None rel_b past
block 0, None w_gate for ReLU); the CLIs' stdout; no silent CPU
fallback."""

import functools

import jax
import numpy as np
import pytest
import torch

import prima_tpu.models.t5 as jt5
import prima_tpu_torch.models.t5 as t5
from prima_tpu.gguf.reader import GGUFModel
from prima_tpu.tools.cli import main as jcli
from prima_tpu.tools.convert_hf import convert_hf_to_gguf
from prima_tpu.tools.quantize import quantize_gguf
from prima_tpu_torch.models.llama import params_from_numpy
from prima_tpu_torch.tools.cli import main as cli
from torch_families import convert, hf_t5, rel_err

TOL = 1e-4  # f32: the same expressions, sums in another order
INPUT = [[3, 11, 25, 7, 42, 5, 60], [9, 17, 60, 2, 33, 12, 4]]
DEC = [[0, 5, 9, 14], [0, 21, 8, 3]]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("t5")
    relu = convert(convert_hf_to_gguf, hf_t5(str(d / "hf"), gated=False, tied=True),
                   str(d / "t5.gguf"))
    gated = convert(convert_hf_to_gguf, hf_t5(str(d / "hfg"), gated=True, tied=False),
                    str(d / "t5g.gguf"))
    q8 = str(d / "t5g_q8.gguf")
    with open(str(d / "q.log"), "w") as log:
        quantize_gguf(gated, q8, "Q8_0", logfile=log)
    return {"relu_tied": relu, "gated_untied": gated, "q8_0": q8}


@functools.lru_cache(maxsize=None)
def _pair(path):
    return jt5.T5Runtime.load(path), t5.T5Runtime.load(path, device="cpu")


@pytest.mark.parametrize("name", ["relu_tied", "gated_untied", "q8_0"])
def test_encoder_decoder_and_greedy_match_jax(files, name):
    jrt, prt = _pair(files[name])
    assert vars(prt.cfg) == vars(jrt.cfg)
    assert (prt.cfg.ffn_gated, prt.cfg.tie_embeddings) == (
        (False, True) if name == "relu_tied" else (True, False))
    inp, dec = np.asarray(INPUT, np.int32), np.asarray(DEC, np.int32)
    jenc = jt5.t5_encode(jrt.params, jrt.cfg, inp)
    want = jt5.t5_decode(jrt.params, jrt.cfg, dec, jenc)
    with torch.no_grad():
        enc = t5.t5_encode(prt.params, prt.cfg, inp)
        got = t5.t5_decode(prt.params, prt.cfg, dec, enc)
    assert rel_err(enc.numpy(), np.asarray(jenc)) <= TOL
    assert rel_err(got.numpy(), np.asarray(want)) <= TOL
    prompt = [3, 11, 25, 7, 2]
    assert prt.generate(prompt, n_predict=10) == jrt.generate(prompt, n_predict=10)


def test_params_from_numpy_carries_jax_params(files):
    m = GGUFModel.open(files["relu_tied"])
    cfg = jt5.T5Config.from_gguf(m)
    jparams = jt5.load_t5_params(m, cfg)
    m.close()
    host = jax.device_get(jparams)
    assert host["output"] is None and host["dec"][1]["rel_b"] is None
    assert host["enc"][0]["w_gate"] is None
    params = params_from_numpy(host, "cpu")
    assert params["dec"][1]["rel_b"] is None and params["dec"][0]["rel_b"] is not None
    inp, dec = np.asarray(INPUT, np.int32), np.asarray(DEC, np.int32)
    want = jt5.t5_decode(jparams, cfg, dec, jt5.t5_encode(jparams, cfg, inp))
    pcfg = t5.T5Config(**vars(cfg))
    with torch.no_grad():
        got = t5.t5_decode(params, pcfg, dec, t5.t5_encode(params, pcfg, inp))
    assert rel_err(got.numpy(), np.asarray(want)) <= TOL


def test_rel_bucket_is_the_jax_packages(files):
    rel = np.arange(-200, 200)[None, :] - np.arange(0, 7)[:, None]
    for bidir in (True, False):
        assert np.array_equal(t5._rel_bucket(rel, bidir, 32, 128),
                              jt5._rel_bucket(rel, bidir, 32, 128))


@pytest.mark.parametrize("name", ["relu_tied", "gated_untied"])
def test_cli_prints_jax_text(files, name, capsys):
    args = ["-m", files[name], "-p", "hello there", "-n", "8"]
    assert jcli(args) == 0
    want = capsys.readouterr().out
    assert cli(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello there")


def test_cuda_asked_without_gpu_raises(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t5.T5Runtime.load(files["relu_tied"])
