"""Mamba and Falcon-Mamba (models/mamba.py) in the port against the JAX
package's runtime on the same tiny GGUFs: teacher-forced logits within
1e-4 * max |logit| (f32, and Q8_0) and equal greedy streams of 16 tokens;
token-by-token decode with the carried state equal to the full forward;
params_from_numpy of the JAX params; the CLIs' stdout, greedy, sampled at
--temp 0.8 -s 42 and one-shot under -cnv; -ngl 0 fails as the JAX CLI
fails; no silent CPU fallback."""

import functools

import jax
import numpy as np
import pytest
import torch

import prima_tpu.models.mamba as jmb
import prima_tpu_torch.models.mamba as mb
from prima_tpu.gguf.reader import GGUFModel
from prima_tpu.tools.cli import main as jcli
from prima_tpu.tools.convert_hf import convert_hf_to_gguf
from prima_tpu.tools.quantize import quantize_gguf
from prima_tpu_torch.models.llama import params_from_numpy
from prima_tpu_torch.tools.cli import main as cli
from torch_families import convert, hf_mamba, rel_err, rewrite_gguf

TOL = 1e-4  # f32: the same expressions, sums in another order
TOKENS = [[3, 11, 25, 7, 42, 5], [9, 17, 60, 2, 33, 12]]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mamba")
    f32 = convert(convert_hf_to_gguf, hf_mamba(str(d / "hf")), str(d / "mamba.gguf"))
    q8 = str(d / "mamba_q8.gguf")
    with open(str(d / "q.log"), "w") as log:
        quantize_gguf(f32, q8, "Q8_0", logfile=log)
    # Falcon-Mamba: the same tensors with dt, B and C RMS-normalized
    falcon = rewrite_gguf(f32, str(d / "falcon.gguf"), {"mamba.ssm.dt_b_c_rms": True})
    return {"f32": f32, "q8_0": q8, "falcon": falcon}


@functools.lru_cache(maxsize=None)
def _pair(path):
    return jmb.MambaRuntime.load(path), mb.MambaRuntime.load(path, device="cpu")


@pytest.mark.parametrize("name", ["f32", "q8_0", "falcon"])
def test_logits_and_greedy_match_jax(files, name):
    jrt, prt = _pair(files[name])
    assert vars(prt.cfg) == vars(jrt.cfg) and prt.cfg.dt_b_c_rms == (name == "falcon")
    toks = np.asarray(TOKENS, np.int32)
    want, _ = jmb.mamba_forward(jrt.params, jrt.cfg, toks)
    with torch.no_grad():
        got, states = mb.mamba_forward(prt.params, prt.cfg, toks)
    assert rel_err(got.numpy(), np.asarray(want)) <= TOL
    assert [tuple(s.shape) for s in states[0]] == [(2, 64, 3), (2, 64, 8)]
    prompt = [3, 11, 25]
    stream = prt.generate(prompt, n_predict=16)
    assert stream == jrt.generate(prompt, n_predict=16) and len(set(stream)) > 3


@pytest.mark.parametrize("name", ["f32", "falcon"])
def test_stateful_decode_equals_full_forward(files, name):
    _, prt = _pair(files[name])
    toks = [3, 11, 25, 7, 42, 5, 9, 17]
    with torch.no_grad():
        full, _ = mb.mamba_forward(prt.params, prt.cfg, [toks])
        states = mb.init_mamba_state(prt.cfg, 1)
        steps = []
        for t in toks:
            lg, states = mb.mamba_forward(prt.params, prt.cfg, [[t]], states)
            steps.append(lg[0, 0])
    assert rel_err(torch.stack(steps).numpy(), full[0].numpy()) <= TOL


def test_params_from_numpy_carries_jax_params(files):
    m = GGUFModel.open(files["f32"])
    cfg = jmb.MambaConfig.from_gguf(m)
    jparams = jmb.load_mamba_params(m, cfg)
    m.close()
    host = jax.device_get(jparams)
    assert host["output"] is None  # tied embeddings
    params = params_from_numpy(host, "cpu")
    toks = np.asarray(TOKENS, np.int32)
    want, _ = jmb.mamba_forward(jparams, cfg, toks)
    with torch.no_grad():
        got, _ = mb.mamba_forward(params, mb.MambaConfig(**vars(cfg)), toks)
    assert rel_err(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("sampling", [["--temp", "0"], ["--temp", "0.8", "-s", "42"],
                                      ["--temp", "0", "-cnv"]],
                         ids=["greedy", "temp0.8", "cnv_one_shot"])
def test_cli_prints_jax_text(files, sampling, capsys):
    """Greedy, and sampled through the host Sampler: the port's sampling/ is
    the JAX package's numpy with the same seeded generator; -cnv warns and
    runs one-shot in both CLIs."""
    args = ["-m", files["f32"], "-p", "hello there", "-n", "12"] + sampling
    assert jcli(args) == 0
    want = capsys.readouterr()
    assert cli(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.out.startswith("hello there")
    assert len(got.out) > len("hello there")
    warned = ["-cnv is not supported" in c.err for c in (want, got)]
    assert warned == [("-cnv" in sampling)] * 2


def _outcome(main, args):
    try:
        return "rc", main(args)
    except Exception as e:  # noqa: BLE001 - the failure itself is compared
        return type(e).__name__, str(e)


def test_ngl_routes_to_the_ring_first_as_in_jax(files):
    """-ngl 0 goes to the one-rank ring before the arch probe in both CLIs,
    whose decoder loader refuses a mamba GGUF alike."""
    args = ["-m", files["f32"], "-p", "hi", "-n", "4", "-ngl", "0"]
    want = _outcome(jcli, args)
    assert want[0] == "NotImplementedError"
    assert _outcome(cli, args + ["--device", "cpu"]) == want


def test_cuda_asked_without_gpu_raises(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.MambaRuntime.load(files["f32"])
