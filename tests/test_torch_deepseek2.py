"""DeepSeek-V2 and MiniCPM3 (models/deepseek2.py) in the port against the
JAX package's runtime on the same tiny GGUFs: teacher-forced logits within
1e-4 * max |logit| (f32) and equal greedy streams, with q_lora_rank > 0 and
0 (Lite), Q8_0, YaRN keys written by hand (the converter writes none),
MiniCPM3 inside and past rope_orig_ctx (LongRoPE factors switch mid-stream);
the MoE sum in ascending expert id; params_from_numpy of the JAX params
(f32 and bf16); the CLIs' stdout; no silent CPU fallback."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prima_tpu.models.deepseek2 as jds
import prima_tpu_torch.models.deepseek2 as ds
from prima_tpu.gguf.reader import GGUFModel
from prima_tpu.tools.cli import main as jcli
from prima_tpu.tools.convert_hf import convert_hf_to_gguf
from prima_tpu.tools.quantize import quantize_gguf
from prima_tpu_torch.models.llama import params_from_numpy
from prima_tpu_torch.tools.cli import main as cli
from torch_families import convert, hf_deepseek2, hf_minicpm3, rel_err, rewrite_gguf

TOL = 1e-4  # f32: the same expressions, sums in another order
BF16_TOL = 2e-2  # bf16 weights: activations rounded to bf16 in both packages
TOKENS = [[3, 11, 25, 7, 42, 5], [9, 17, 60, 2, 33, 12]]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds2")
    ds2 = convert(convert_hf_to_gguf, hf_deepseek2(str(d / "hf")), str(d / "ds2.gguf"))
    lite = convert(convert_hf_to_gguf, hf_deepseek2(str(d / "hf_lite"), None),
                   str(d / "lite.gguf"))
    q8 = str(d / "ds2_q8.gguf")
    with open(str(d / "q.log"), "w") as log:
        quantize_gguf(ds2, q8, "Q8_0", logfile=log)
    yarn = rewrite_gguf(ds2, str(d / "yarn.gguf"), {
        "deepseek2.rope.scaling.type": "yarn", "deepseek2.rope.scaling.factor": 4.0,
        "deepseek2.rope.scaling.original_context_length": 16,
        "deepseek2.rope.scaling.yarn_log_multiplier": 0.0707})
    m3 = convert(convert_hf_to_gguf, hf_minicpm3(str(d / "hf_m3")), str(d / "m3.gguf"))
    m3 = rewrite_gguf(m3, str(d / "m3_orig8.gguf"),
                      {"minicpm3.rope.scaling.original_context_length": 8})
    return {"ds2": ds2, "lite": lite, "q8_0": q8, "yarn": yarn, "minicpm3": m3}


@functools.lru_cache(maxsize=None)
def _pair(path):
    """Both runtimes on one file, kept across tests so the JAX jit compiles
    each shape once."""
    return jds.DeepseekV2Runtime.load(path), ds.DeepseekV2Runtime.load(path, device="cpu")


def _logits(prt, toks):
    with torch.no_grad():
        return ds.deepseek2_forward(prt.params, prt.cfg, toks).numpy()


@pytest.mark.parametrize("name", ["ds2", "lite", "q8_0", "yarn"])
def test_logits_and_greedy_match_jax(files, name):
    jrt, prt = _pair(files[name])
    assert vars(prt.cfg) == vars(jrt.cfg)
    assert bool(prt.cfg.q_lora_rank) == (name != "lite")
    if name == "yarn":
        assert prt.cfg.rope_scaling == "yarn" and prt.cfg.rope_factor == 4.0
        inv, mscale, kq = ds._rope_params(prt.cfg)
        jinv, jmscale, jkq = jds._rope_params(jrt.cfg)
        assert inv.tobytes() == np.asarray(jinv).tobytes() and (mscale, kq) == (jmscale, jkq)
    toks = np.asarray(TOKENS, np.int32)
    fwd = jrt._fwd if name != "yarn" else (
        lambda p, t: jds.deepseek2_forward(p, jrt.cfg, t))  # eager: see below
    want = np.asarray(fwd(jrt.params, toks))
    assert rel_err(_logits(prt, toks), want) <= TOL
    prompt = [3, 11, 25, 7]
    if name != "yarn":
        assert prt.generate(prompt, n_predict=8) == jrt.generate(prompt, n_predict=8)
        return
    # the JAX runtime's jit traces _rope_params, whose np.asarray of the
    # YaRN ramp cannot take a tracer: its generate fails on any YaRN GGUF.
    # The port computes the constants on the host and generates; each of
    # its greedy tokens is the argmax of the JAX forward, run eagerly once
    # over the whole stream (a recompute step's logits are the full
    # forward's at that position)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jrt.generate(prompt, n_predict=1)
    got = prt.generate(prompt, n_predict=8)
    seq = np.asarray([prompt + got[:-1]], np.int32)
    lg = np.asarray(jds.deepseek2_forward(jrt.params, jrt.cfg, seq))[0, len(prompt) - 1:]
    assert lg.argmax(-1).tolist() == got and len(got) > 1


@pytest.mark.parametrize("s", [6, 12], ids=["inside_orig_ctx", "past_orig_ctx"])
def test_minicpm3_longrope_matches_jax(files, s):
    jrt, prt = _pair(files["minicpm3"])
    assert prt.cfg.rope_orig_ctx == 8 and prt.params["rope_long"] is not None
    toks = np.asarray([[(7 * i + 3) % 128 for i in range(s)]], np.int32)
    want = np.asarray(jrt._fwd(jrt.params, toks))
    assert rel_err(_logits(prt, toks), want) <= TOL


def test_minicpm3_greedy_crosses_orig_ctx(files):
    """A 6-token prompt and 8 greedy tokens: the recomputed sequence passes
    rope_orig_ctx 8 at the third token, where both packages switch from the
    short to the long LongRoPE factors."""
    jrt, prt = _pair(files["minicpm3"])
    prompt = [3, 11, 25, 7, 42, 5]
    got = prt.generate(prompt, n_predict=8)
    assert got == jrt.generate(prompt, n_predict=8)
    # the switch matters: the logits past it differ from short factors'
    seq = np.asarray([prompt + got], np.int32)
    short = dict(prt.params, rope_long=prt.params["rope_short"])
    with torch.no_grad():
        a = ds.deepseek2_forward(prt.params, prt.cfg, seq).numpy()
        b = ds.deepseek2_forward(short, prt.cfg, seq).numpy()
    assert rel_err(a, b) > 1e-3


def test_moe_sums_experts_in_ascending_id(files):
    """The routed experts are summed one by one in ascending expert id over
    every expert, the shared expert last: bit for bit the reference's
    expression written out here."""
    _, prt = _pair(files["ds2"])
    layer, cfg = prt.params["layers"][1], prt.cfg
    assert "gate_inp" in layer and cfg.n_expert == 4
    fin = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 5, 64)).astype(
        np.float32))
    got = ds._moe(layer, cfg, fin)
    pr = torch.softmax(fin @ layer["gate_inp"].T, dim=-1)
    w, ids = torch.topk(pr, cfg.n_expert_used, dim=-1)
    mlp = lambda x, g, u, d: (torch.nn.functional.silu(x @ g.T) * (x @ u.T)) @ d.T
    want = torch.zeros_like(fin)
    for e in range(cfg.n_expert):
        sel = torch.where(ids == e, w, 0.0).sum(-1)
        want = want + sel[..., None] * mlp(fin, layer["ffn_gate_exps"][e],
                                           layer["ffn_up_exps"][e], layer["ffn_down_exps"][e])
    want = want + mlp(fin, layer["gate_shexp"], layer["up_shexp"], layer["down_shexp"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_params_from_numpy_carries_jax_params(files, dtype):
    """The JAX params tree (with None leaves: deepseek2 has no LongRoPE
    factors) carried into the port gives the JAX logits; with bf16 weights
    both packages turn the residual stream f32 at the first add."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    m = GGUFModel.open(files["ds2"])
    cfg = jds.DeepseekV2Config.from_gguf(m)
    jparams = jds.load_deepseek2_params(m, cfg, jdt)
    m.close()
    host = jax.device_get(jparams)
    assert host["rope_long"] is None and host["rope_short"] is None
    params = params_from_numpy(host, "cpu")
    assert params["layers"][1]["ffn_up_exps"].dtype == (
        torch.float32 if dtype == "f32" else torch.bfloat16)
    assert params["rope_long"] is None
    toks = np.asarray(TOKENS, np.int32)
    want = np.asarray(jds.deepseek2_forward(jparams, cfg, toks), np.float32)
    with torch.no_grad():
        got = ds.deepseek2_forward(params, ds.DeepseekV2Config(**vars(cfg)), toks)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= (TOL if dtype == "f32" else BF16_TOL)
    if dtype == "f32":  # dtype= carries f32 arrays into bf16 tensors
        narrowed = params_from_numpy(host, "cpu", torch.bfloat16)
        assert narrowed["layers"][0]["wq_a"].dtype == torch.bfloat16
        assert torch.equal(narrowed["tok_embd"], params["tok_embd"].to(torch.bfloat16))


def _streamed(tok, ids: list) -> str:
    """Token ids as the port's CLI streams them: bytes that do not yet
    close a UTF-8 character wait for the next token, and are dropped at
    the end."""
    buf, out = b"", ""
    for t in ids:
        buf += tok.decode_token_bytes(t)
        try:
            out, buf = out + buf.decode("utf-8"), b""
        except UnicodeDecodeError:
            continue
    return out


@pytest.mark.parametrize("name", ["ds2", "minicpm3"])
def test_cli_prints_jax_text(files, name, capsys):
    """minicpm3 runs on the recompute runtime in both CLIs: the same text.
    The port's CLI serves deepseek2 through Engine, streaming its text,
    where the JAX CLI runs its recompute runtime: both greedy, the port
    prints the JAX runtime's tokens as it streams them."""
    args = ["-m", files[name], "-p", "hello there", "-n", "8"]
    if name == "ds2":
        from prima_tpu_torch.gguf.reader import GGUFModel as PortGGUFModel
        from prima_tpu_torch.tokenizer import Tokenizer

        jrt, _ = _pair(files[name])
        m = PortGGUFModel.open(files[name])
        tok = Tokenizer.from_gguf(m)
        m.close()
        ids = tok.encode("hello there", add_special=True, parse_special=True)
        want = "hello there" + _streamed(tok, jrt.generate(ids, n_predict=8)) + "\n"
        args += ["--temp", "0"]  # the JAX runtime is greedy whatever --temp says
    else:
        assert jcli(args) == 0
        want = capsys.readouterr().out
    assert cli(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello there") and len(got) > len("hello there")


def test_cuda_asked_without_gpu_raises(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.DeepseekV2Runtime.load(files["ds2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["-m", files["minicpm3"], "-p", "x", "-n", "2"])
