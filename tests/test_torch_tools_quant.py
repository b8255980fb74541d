"""The port's activation and quantize tools against the JAX package's,
each through its main on the trained tiny pair (models_tiny_pair): imatrix
(the same keys and call counts; values within 1e-5 of each key's largest
with f32 activations and caches, 1e-2 with the tools' bf16), eval_callback
(the same table and top tokens, numbers within 1e-5), cvector_generator
(each layer's direction at cosine >= 0.9999, the file loading as the
port's control vector), quantize (the same GGUF bytes), quantize_stats
(the same lines), export_lora (the merged tensors within 1e-6; the merged
model's logits those of the runtime LoRA within 1e-3 of max |logit|, as
the merged weights are stored in f16), gguf_split and its merge (the same
bytes), gguf_hash, tokenize and gbnf_validator (the same stdout). The
three tools that run the model raise for --device cuda without a GPU."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.models import llama as jllama
from prima_tpu.tools import cvector_generator as jcvector_generator
from prima_tpu.tools import eval_callback as jeval_callback
from prima_tpu.tools import export_lora as jexport_lora
from prima_tpu.tools import gbnf_validator as jgbnf_validator
from prima_tpu.tools import gguf_hash as jgguf_hash
from prima_tpu.tools import gguf_split as jgguf_split
from prima_tpu.tools import imatrix as jimatrix
from prima_tpu.tools import quantize as jquantize
from prima_tpu.tools import quantize_stats as jquantize_stats
from prima_tpu.tools import tokenize as jtokenize
from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.models import adapters as ad
from prima_tpu_torch.models import llama
from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.quant.dequant_np import dequantize_tensor
from prima_tpu_torch.quant.quantize_imatrix import load_imatrix
from prima_tpu_torch.tools import (cvector_generator, eval_callback, export_lora,
                                   gbnf_validator, gguf_hash, gguf_split, imatrix, quantize,
                                   quantize_stats, tokenize)
from test_torch_adapters import write_lora
from test_torch_cli import f32  # noqa: F401
from test_torch_speculative import torch_one_thread  # noqa: F401
from test_torch_tools import both, run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
CORPUS = ("Once upon a time there was a little fox. The fox ran to the river. "
          "Once upon a time there was a little bird. The bird flew to the river. ") * 4
F32_TOL = 1e-5
BF16_TOL = 1e-2
MERGED_F16_TOL = 1e-3  # of max |logit|: two f16 roundings of a weight


@pytest.fixture
def f32_cache(monkeypatch):
    """The bf16 caches the tools ask for are f32 in both packages (a cache
    row rounded to bf16 can differ where its f32 value differs in the last
    bit)."""
    for mod, bf16, f32_ in ((jllama, jnp.bfloat16, jnp.float32),
                            (llama, torch.bfloat16, torch.float32)):
        init = mod.init_kv_caches

        def init_f32(cfg, batch, max_seq, dtype=bf16, *a, init=init, bf16=bf16, f32_=f32_,
                     **kw):
            return init(cfg, batch, max_seq, f32_ if dtype == bf16 else dtype, *a, **kw)

        monkeypatch.setattr(mod, "init_kv_caches", init_f32)


def _corpus(tmp_path) -> str:
    p = tmp_path / "calib.txt"
    p.write_text(CORPUS)
    return str(p)


def _same_numbers(a: str, b: str, tol: float = F32_TOL) -> bool:
    """Equal text, the decimal numbers in it within tol (relative, and
    absolute under 1)."""
    num = re.compile(r"-?\d+\.\d+")
    if num.sub("#", a) != num.sub("#", b):
        return False
    return all(abs(float(x) - float(y)) <= tol * max(1.0, abs(float(y)))
               for x, y in zip(num.findall(a), num.findall(b)))


def _imatrix_pair(tmp_path, capsys) -> tuple[dict, dict, str, str]:
    corpus = _corpus(tmp_path)
    jout, out = str(tmp_path / "jax.imatrix"), str(tmp_path / "port.imatrix")
    args = ["-m", TARGET, "-f", corpus, "-c", "32", "--chunks", "2"]
    _, jerr = run(jimatrix.main, args + ["-o", jout, "--matmul", "xla"], capsys)
    _, err = run(imatrix.main, args + ["-o", out, "--device", "cpu"], capsys)
    return load_imatrix(jout), load_imatrix(out), jerr, err


def _assert_imatrix_close(want: dict, got: dict, tol: float) -> None:
    assert sorted(got) == sorted(want) and len(got) == 7 * 4 + 1
    for k, v in want.items():
        assert got[k].shape == v.shape and np.all(got[k] > 0), k
        assert np.abs(got[k] - v).max() <= tol * np.abs(v).max(), k


def test_imatrix_matches_jax_f32(f32, f32_cache, tmp_path, capsys):
    want, got, jerr, err = _imatrix_pair(tmp_path, capsys)
    _assert_imatrix_close(want, got, F32_TOL)
    line = "stored 29 entries (2 chunks) in "
    assert line in jerr and line in err


def test_imatrix_matches_jax_bf16(tmp_path, capsys):
    want, got, _, _ = _imatrix_pair(tmp_path, capsys)
    _assert_imatrix_close(want, got, BF16_TOL)


def test_imatrix_file_header_matches_jax(f32, f32_cache, tmp_path, capsys):
    """The same entry names, call counts, last call and dataset in both files."""
    import struct

    _imatrix_pair(tmp_path, capsys)

    def header(path):
        data = open(path, "rb").read()
        (n,), off, out = struct.unpack_from("<i", data), 4, {}
        for _ in range(n):
            (ln,) = struct.unpack_from("<i", data, off)
            name = data[off + 4:off + 4 + ln].decode()
            ncall, nval = struct.unpack_from("<ii", data, off + 4 + ln)
            out[name] = (ncall, nval)
            off += 12 + ln + 4 * nval
        return out, data[off:]

    (jh, jtail), (h, tail) = (header(str(tmp_path / f"{w}.imatrix")) for w in ("jax", "port"))
    assert h == jh and tail == jtail


def test_eval_callback_matches_jax(f32, capsys):
    want, got = both(jeval_callback.main, eval_callback.main,
                     ["-m", TARGET, "-p", "Once upon a time", "--top", "5"], capsys)
    assert _same_numbers(got, want), (got, want)
    rows = [ln for ln in got.splitlines() if ln.startswith(("blk.", "output."))]
    assert len(rows) == 29 and rows[0].startswith("blk.0.attn_k.weight")
    assert rows[-1].startswith("output.weight")


def test_cvector_matches_jax_and_loads(f32, tmp_path, capsys):
    pos, neg = tmp_path / "pos.txt", tmp_path / "neg.txt"
    # the pairs differ in their last word, so the last token's hidden state
    # differs at every layer; prompts of one length trace the JAX forward once
    pos.write_text("The fox was happy\nThe cat felt calm\n")
    neg.write_text("The fox was angry\nThe cat felt fear\n")
    jpath, path = str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")
    args = ["-m", TARGET, "--positive-file", str(pos), "--negative-file", str(neg)]
    run(jcvector_generator.main, args + ["-o", jpath, "--matmul", "xla"], capsys)
    _, err = run(cvector_generator.main, args + ["-o", path, "--device", "cpu"], capsys)
    assert f"wrote 4 directions -> {path}" in err
    jm, m = GGUFModel.open(jpath), GGUFModel.open(path)
    assert sorted(m.tensors) == sorted(jm.tensors) == [f"direction.{i}" for i in range(1, 5)]
    assert m.metadata == jm.metadata
    for name in m.tensors:
        a, b = dequantize_tensor(m.tensors[name]), dequantize_tensor(jm.tensors[name])
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos >= 0.9999, (name, cos)
    model = load_model(TARGET, device="cpu", dtype=torch.float32)
    cvec = ad.load_control_vector(path, strength=2.0, device="cpu")
    params = ad.apply_control_vector(model.params, cvec)
    assert all(params["layers"][i]["cvec"].shape == (model.cfg.n_embd,) for i in range(4))


def test_quantize_main_matches_jax(tmp_path, capsys):
    """quantize through main, with the imatrix the port's tool wrote: the
    same GGUF bytes and the same summary line."""
    corpus = _corpus(tmp_path)
    im = str(tmp_path / "t.imatrix")
    run(imatrix.main, ["-m", TARGET, "-f", corpus, "-c", "32", "--chunks", "2", "-o", im,
                       "--device", "cpu"], capsys)
    outs = []
    for main, name in ((jquantize.main, "jax"), (quantize.main, "port")):
        dst = str(tmp_path / f"{name}.gguf")
        out, err = run(main, [TARGET, dst, "Q4_K_M", "--imatrix", im], capsys)
        assert "loaded 29 imatrix entries" in err
        outs.append((re.sub(r"in [0-9.]+s", "in #s", out), open(dst, "rb").read()))
    assert outs[0] == outs[1]
    assert outs[1][0].startswith("quantized 39 tensors: ")


def test_quantize_stats_matches_jax(capsys):
    args = ["-m", TARGET, "--type", "q4_K", "--type", "q8_0", "--type", "iq4_nl",
            "-l", "blk\\.[01]\\.", "-p"]
    want, _ = run(jquantize_stats.main, args, capsys)
    got, _ = run(quantize_stats.main, args, capsys)
    assert _same_numbers(got, want)
    assert got.count(" total: ") == 3


@pytest.fixture
def lora(tmp_path):
    cfg = load_model(TARGET, device="cpu").cfg
    return write_lora(str(tmp_path / "lora.gguf"), cfg, seed=5)


def test_export_lora_matches_jax_and_runtime(f32, tmp_path, capsys, lora):
    jmerged, merged = str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")
    run(jexport_lora.main, ["-m", TARGET, "--lora-scaled", lora, "0.5", "-o", jmerged], capsys)
    _, err = run(export_lora.main, ["-m", TARGET, "--lora-scaled", lora, "0.5", "-o", merged,
                                    "-v"], capsys)
    assert f"merged 28 tensors with lora adapters -> {merged}" in err
    jm, m = GGUFModel.open(jmerged), GGUFModel.open(merged)
    assert list(m.tensors) == list(jm.tensors) and list(m.metadata) == list(jm.metadata)
    for name, ti in m.tensors.items():
        assert ti.ggml_type == jm.tensors[name].ggml_type, name
        a, b = dequantize_tensor(ti), dequantize_tensor(jm.tensors[name])
        assert np.abs(a - b).max() <= 1e-6, name

    # the merged model against the base model with the adapter at run time
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, 259, (1, 12)))

    def logits(params, cfg):
        kv = init_kv_caches(cfg, 1, 12, torch.float32, "cpu")
        with torch.no_grad():
            out, _ = forward(params, cfg, toks, torch.arange(12, dtype=torch.int32)[None], kv,
                             torch.zeros(1, dtype=torch.int32), ForwardOptions(
                                 dtype=torch.float32))
        return out.numpy()

    base = load_model(TARGET, device="cpu", dtype=torch.float32)
    adapter = ad.load_lora_gguf(lora, dtype=torch.float32, device="cpu")
    want = logits(ad.apply_lora(base.params, adapter, scale=0.5), base.cfg)
    mm = load_model(merged, device="cpu", dtype=torch.float32)
    got = logits(mm.params, mm.cfg)
    # the merged tensors are stored as f16 (export-lora.cpp:181), each
    # weight rounded to 2^-11 of itself: 3e-4 of max |logit| here
    assert np.abs(got - want).max() <= MERGED_F16_TOL * np.abs(want).max()
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_gguf_split_merge_bytes_equal(tmp_path, capsys):
    outs = {}
    for main, name in ((jgguf_split.main, "jax"), (gguf_split.main, "port")):
        d = tmp_path / name
        d.mkdir()
        out, _ = run(main, ["split", TARGET, str(d / "t"), "--split-max-tensors", "10"], capsys)
        shards = out.split()
        merged, _ = run(main, ["merge", shards[0], str(d / "merged.gguf")], capsys)
        outs[name] = (out.replace(str(d), "D"), merged.replace(str(d), "D"),
                      [open(s, "rb").read() for s in shards],
                      open(d / "merged.gguf", "rb").read())
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][2]) == 4 and outs["port"][1] == "merged 39 tensors -> D/merged.gguf\n"


@pytest.mark.parametrize("flags", [[], ["--all"]], ids=["sha256", "all"])
def test_gguf_hash_matches_jax(flags, capsys):
    want, _ = run(jgguf_hash.main, [TARGET] + flags, capsys)
    got, _ = run(gguf_hash.main, [TARGET] + flags, capsys)
    assert got == want and got.count("\n") == (40 if not flags else 120)


@pytest.mark.parametrize("flags", [["--show-count"], ["--ids", "--no-bos"]],
                         ids=["pieces", "ids"])
def test_tokenize_matches_jax(flags, capsys):
    args = ["-m", TARGET, "-p", "Once upon a time, the fox ran.\n"] + flags
    want, _ = run(jtokenize.main, args, capsys)
    got, _ = run(tokenize.main, args, capsys)
    assert got == want and got.strip()


@pytest.mark.parametrize("text,rc", [('{"a": [1, 2]}', 0), ('{"a": [1, 2}', 1)],
                         ids=["valid", "invalid"])
def test_gbnf_validator_matches_jax(tmp_path, capsys, text, rc):
    grammar = tmp_path / "g.gbnf"
    grammar.write_text('root ::= "{" ws "\\"a\\":" ws arr ws "}"\n'
                       'arr ::= "[" ws num (ws "," ws num)* ws "]"\n'
                       'num ::= [0-9]+\nws ::= [ ]*\n')
    inp = tmp_path / "in.txt"
    inp.write_text(text)
    want, _ = run(jgbnf_validator.main, [str(grammar), str(inp)], capsys, rc)
    got, _ = run(gbnf_validator.main, [str(grammar), str(inp)], capsys, rc)
    assert got == want and ("invalid" in got) == bool(rc)


@pytest.mark.parametrize("main,args", [
    (imatrix.main, ["-f", "unused.txt"]),
    (eval_callback.main, []),
    (cvector_generator.main, []),
], ids=["imatrix", "eval_callback", "cvector_generator"])
def test_device_tools_raise_without_gpu(main, args):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-m", TARGET] + args)
