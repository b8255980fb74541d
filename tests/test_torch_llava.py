"""The port's multimodal path against the JAX package's on the CPU:
forward(inputs_embeds=) bit for bit equal to the token path in the port
(a llama) and within 1e-5 of max |logit| of the JAX forward(inputs_embeds=)
on archs whose token path adds more than the embedding (gemma2's scale,
gpt2's learned positions, bloom's embedding norm); LlavaRuntime's greedy
tokens after an image splice equal to the JAX runtime's in f32 (f32
options and caches set on both runtimes). llava_cli.main against the JAX
tool is in test_torch_llava_cli.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import forward as jforward
from prima_tpu.models.llama import init_kv_caches as jinit_kv
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.sampling import Sampler as JSampler
from prima_tpu.sampling import SamplerParams as JSamplerParams
from prima_tpu.tools import llava_cli as jllava_cli
from prima_tpu_torch.models.clip import ClipModel
from prima_tpu_torch.models.llama import ForwardOptions, embed, forward, init_kv_caches
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.sampling import Sampler, SamplerParams
from prima_tpu_torch.tools import llava_cli
from test_torch_archs import write_model
from test_torch_clip import write_mmproj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
OPTS = ForwardOptions(dtype=torch.float32)
JOPTS = JOpts(matmul_impl="xla", dtype=jnp.float32)


def _port_logits(m, toks=None, embeds=None, opts=OPTS):
    b, s = (toks if toks is not None else embeds).shape[:2]
    kv = init_kv_caches(m.cfg, b, 32, torch.float32, "cpu")
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    t = toks if toks is not None else torch.zeros((b, s), dtype=torch.int64)
    with torch.no_grad():
        logits, _ = forward(m.params, m.cfg, t, pos, kv, torch.zeros(b, dtype=torch.int32),
                            opts, inputs_embeds=embeds)
    return logits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_inputs_embeds_equal_token_path(dtype):
    m = load_model(TARGET, device="cpu", dtype=torch.float32)
    opts = dataclasses.replace(OPTS, dtype=dtype)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, m.cfg.n_vocab, (2, 9)))
    want = _port_logits(m, toks=toks, opts=opts)
    got = _port_logits(m, embeds=embed(m.params["tok_embd"], toks, torch.float32), opts=opts)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["target", "gemma2", "gpt2", "bloom"])
def test_inputs_embeds_match_jax(tmp_path, name):
    path = TARGET if name == "target" else write_model(tmp_path / f"{name}.gguf", name)
    m = load_model(path, device="cpu", dtype=torch.float32)
    jm = jload_model(path, dtype=jnp.float32)
    x = (np.random.default_rng(1).standard_normal((2, 7, m.cfg.n_embd)) * 0.5).astype(np.float32)
    got = _port_logits(m, embeds=torch.from_numpy(x)).numpy()
    jkv = jinit_kv(jm.cfg, 2, 32, jnp.float32)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1))
    want, _ = jforward(jm.params, jm.cfg, jnp.zeros((2, 7), jnp.int32), jnp.asarray(pos), jkv,
                       jnp.zeros(2, jnp.int32), JOPTS, inputs_embeds=jnp.asarray(x))
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.fixture(scope="module")
def mmproj(tmp_path_factory):
    d = tmp_path_factory.mktemp("mm")
    return {"flat": write_mmproj(d / "flat.gguf", out=256),
            "minicpmv": write_mmproj(d / "cpmv.gguf", minicpmv=2, out=256, image_size=448,
                                     patch=14)}


def test_llava_runtime_greedy_matches_jax(mmproj):
    m = load_model(TARGET, device="cpu")
    jm = jload_model(TARGET)
    img = np.random.default_rng(2).integers(0, 255, (24, 40, 3), dtype=np.uint8)
    emb = ClipModel.load(mmproj["flat"], device="cpu").encode(img)
    pre = m.tokenizer.encode("USER: ", add_special=True)
    post = m.tokenizer.encode(" what is it? ASSISTANT:", add_special=False)
    rt = llava_cli.LlavaRuntime(m, max_seq=128, device="cpu")
    rt.opts = OPTS
    rt.kv = init_kv_caches(m.cfg, 1, 128, torch.float32, "cpu")
    jrt = jllava_cli.LlavaRuntime(jm, max_seq=128, matmul_impl="xla")
    jrt.opts = JOPTS
    jrt.kv = jinit_kv(jm.cfg, 1, 128, jnp.float32)
    outs = []
    for r, sampler in ((rt, Sampler(SamplerParams(temp=0.0))),
                       (jrt, JSampler(JSamplerParams(temp=0.0)))):
        r.eval_tokens(pre)
        r.eval_embeds(emb)
        logits = r.eval_tokens(post)
        outs.append((logits, r.generate(sampler, 8, logits, m.eog_ids), r.pos))
    (logits, toks, pos), (jlogits, jtoks, jpos) = outs
    assert np.abs(logits - jlogits).max() <= 1e-5 * np.abs(jlogits).max()
    assert toks == jtoks and pos == jpos and len(toks) > 0


def test_load_image_passthrough(tmp_path):
    f = str(tmp_path / "x.npy")
    np.save(f, np.asarray([[[300.0, -5.0, 7.6]]]))
    assert np.array_equal(llava_cli.load_image(f), jllava_cli.load_image(f))
    assert llava_cli.load_image(f).dtype == np.uint8


def test_llava_cli_raises_without_cuda(mmproj, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llava_cli.main(["-m", TARGET, "--mmproj", mmproj["flat"], "--image", "x.npy"])
