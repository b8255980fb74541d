"""The port's host tools against their JAX-package twins on inputs written
here: convert_hf / convert_extra give byte-identical GGUFs on the same tiny
Hugging Face directories (llama, mamba, t5, deepseek2, minicpm3, rwkv6; F32
and Q8_0), and so do convert_llama2c, convert_image_encoder and
make_tiny_gguf; extract_codebooks writes equal .npy files from a header
written here; pydantic_to_grammar prints equal text; gen_docs lists the
port's modules; utils/log and utils/perf behave the same."""

import inspect
import io
import os
import re
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch
import transformers

import prima_tpu.tools.convert_extra as jextra
import prima_tpu.tools.convert_hf as jhf
import prima_tpu_torch.tools.convert_extra as extra
import prima_tpu_torch.tools.convert_hf as hf
from test_convert_llama2c import _write_llama2c, _write_tokenizer_bin
from torch_families import (convert, hf_deepseek2, hf_llama, hf_mamba, hf_minicpm3, hf_rwkv6,
                            hf_t5)

BUILDERS = {"llama": hf_llama, "mamba": hf_mamba, "t5": lambda d: hf_t5(d, True, False),
            "deepseek2": hf_deepseek2, "minicpm3": hf_minicpm3, "rwkv6": hf_rwkv6}


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf")
    return {arch: build(str(d / arch)) for arch, build in BUILDERS.items()}


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("ftype", ["F32", "Q8_0"])
@pytest.mark.parametrize("arch", list(BUILDERS))
def test_convert_hf_bytes_equal(hf_dirs, tmp_path, arch, ftype):
    want = convert(jhf.convert_hf_to_gguf, hf_dirs[arch], str(tmp_path / "jax.gguf"), ftype)
    got = convert(hf.convert_hf_to_gguf, hf_dirs[arch], str(tmp_path / "port.gguf"), ftype)
    assert _bytes(got) == _bytes(want)


def test_convert_extra_covers_the_same_archs():
    assert sorted(extra._SPECS) == sorted(jextra._SPECS)
    assert {"MiniCPM3ForCausalLM", "Rwkv6ForCausalLM"} <= set(extra._SPECS)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "own_head"])
def test_convert_llama2c_bytes_equal(tmp_path, shared):
    from prima_tpu.tools.convert_llama2c import convert as jconvert
    from prima_tpu_torch.tools.convert_llama2c import convert as pconvert

    ckpt, tokb = str(tmp_path / "model.bin"), str(tmp_path / "tokenizer.bin")
    _write_llama2c(ckpt, shared, np.random.default_rng(7))
    _write_tokenizer_bin(tokb)
    jconvert(ckpt, tokb, str(tmp_path / "jax.gguf"))
    pconvert(ckpt, tokb, str(tmp_path / "port.gguf"))
    assert _bytes(str(tmp_path / "port.gguf")) == _bytes(str(tmp_path / "jax.gguf"))


def test_convert_image_encoder_bytes_equal(tmp_path):
    from prima_tpu.tools.convert_image_encoder import convert as jconvert
    from prima_tpu_torch.tools.convert_image_encoder import convert as pconvert

    cfg = transformers.CLIPVisionConfig(hidden_size=32, intermediate_size=48,
                                        num_hidden_layers=3, num_attention_heads=4,
                                        image_size=32, patch_size=8, projection_dim=16)
    torch.manual_seed(5)
    model = transformers.CLIPVisionModel(cfg).eval()
    rng = np.random.default_rng(6)
    proj = {"mm.0.weight": rng.standard_normal((24, 32)), "mm.0.bias": rng.standard_normal(24),
            "mm.2.weight": rng.standard_normal((24, 24)), "mm.2.bias": rng.standard_normal(24)}
    kw = dict(projector=proj, use_gelu=True, image_grid_pinpoints=[[32, 64], [64, 32]],
              mm_patch_merge_type="spatial_unpad")
    with redirect_stderr(io.StringIO()):
        jconvert(model, str(tmp_path / "jax.gguf"), **kw)
        pconvert(model, str(tmp_path / "port.gguf"), **kw)
    assert _bytes(str(tmp_path / "port.gguf")) == _bytes(str(tmp_path / "jax.gguf"))


@pytest.mark.parametrize("ftype", ["Q4_K", "Q8_0"])
def test_make_tiny_gguf_bytes_equal(tmp_path, ftype):
    from prima_tpu.gguf.constants import GGMLType as JGGMLType
    from prima_tpu.tools.make_tiny_gguf import make_tiny_gguf as jmake
    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.tools.make_tiny_gguf import make_tiny_gguf as pmake

    kw = dict(vocab_from=None, n_layers=2, n_embd=256, seed=3)
    jmake(str(tmp_path / "jax.gguf"), ftype=JGGMLType[ftype], **kw)
    pmake(str(tmp_path / "port.gguf"), ftype=GGMLType[ftype], **kw)
    assert _bytes(str(tmp_path / "port.gguf")) == _bytes(str(tmp_path / "jax.gguf"))


HEADER = """
#define GGML_TABLE_BEGIN(type, name, size) static const type name[size] = {
#define GGML_TABLE_END() };
GGML_TABLE_BEGIN(uint64_t, iq2xxs_grid, 4)
    0x0808080808080808, 0x080808080808082b, 0x0808080808081919, 0x0808080808082b08,
GGML_TABLE_END()
GGML_TABLE_BEGIN(uint8_t, ksigns_iq2xs, 8)
    0, 129, 130, 3, 132, 5, 6, 135,
GGML_TABLE_END()
GGML_TABLE_BEGIN(uint32_t, iq3s_grid, 3)
    0x01010101, 0x01010103, 0x0101010f,
GGML_TABLE_END()
GGML_TABLE_BEGIN(uint16_t, not_a_codebook, 2)
    1, 2,
GGML_TABLE_END()
"""


def test_extract_codebooks_writes_equal_npy(tmp_path):
    from prima_tpu.tools.extract_codebooks import extract as jextract
    from prima_tpu_torch.tools.extract_codebooks import extract as pextract

    header = tmp_path / "ggml-common.h"
    header.write_text(HEADER)
    outs = []
    for fn, name in ((jextract, "jax"), (pextract, "port")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            fn(str(header), str(tmp_path / name))
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "3 tables from header" in outs[1]
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        "iq2xxs_grid.npy", "iq3s_grid.npy", "ksigns_iq2xs.npy", "kvalues_iq4nl.npy"]
    for f in files:
        assert _bytes(str(tmp_path / "port" / f)) == _bytes(str(tmp_path / "jax" / f))


MODELS = '''
from pydantic import BaseModel, Field


class Weather(BaseModel):
    """A forecast."""
    city: str = Field(description="where")
    days: int
    rain: bool = False


class Reply(BaseModel):
    text: str
    score: float | None = None
'''


@pytest.mark.parametrize("args", [["Weather"], ["Weather", "Reply", "--docs"],
                                  ["Reply", "--schema"]], ids=["one", "two_docs", "schema"])
def test_pydantic_to_grammar_prints_equal_text(tmp_path, args):
    from prima_tpu.tools.pydantic_to_grammar import main as jmain
    from prima_tpu_torch.tools.pydantic_to_grammar import main as pmain

    mod = tmp_path / "models.py"
    mod.write_text(MODELS)
    outs = []
    for main in (jmain, pmain):
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            assert main([str(mod)] + args) == 0
        outs.append((out.getvalue(), err.getvalue()))
    assert outs[0] == outs[1] and outs[1][0].strip()


def test_gen_docs_lists_the_ports_modules(tmp_path):
    from prima_tpu_torch.tools import gen_docs

    with redirect_stderr(io.StringIO()):
        assert gen_docs.main(["-o", str(tmp_path)]) == 0
    index = (tmp_path / "README.md").read_text()
    assert "python -m prima_tpu_torch.tools.gen_docs" in index
    # every tool with a main (cli_distributed is a library of cli's ring
    # branch in both packages) and the server
    shown = sorted(f[:-3] for f in os.listdir(tmp_path) if f != "README.md")
    assert shown == sorted([t for t in gen_docs.TOOLS if t != "cli_distributed"] + ["server"])
    for tool in shown:
        doc = (tmp_path / f"{tool}.md").read_text()
        mod = "prima_tpu_torch.server" if tool == "server" else f"prima_tpu_torch.tools.{tool}"
        assert doc.startswith(f"# `python -m {mod}`") and "usage:" in doc, tool
        assert f"[{tool}]({tool}.md)" in index
    assert "prima_tpu." not in index.replace("prima_tpu_torch.", "")
    # its default output directory is not the JAX package's docs/cli
    assert 'default="docs/cli_torch"' in inspect.getsource(gen_docs.main)


def _log_lines(mod, monkeypatch) -> list[str]:
    monkeypatch.setattr(mod, "_colors", False)
    monkeypatch.setattr(mod, "_file", None)
    err = io.StringIO()
    with redirect_stderr(err):
        mod.set_level("info")
        mod.debug("hidden %d", 1)
        mod.info("shown %d and %s", 2, "x")
        mod.warn("careful")
        mod.set_level("error")
        mod.warn("hidden too")
        mod.error("bad %s", "thing")
        mod.set_level("info")
    # the timestamp is the one field that may differ
    return [re.sub(r"^\[\s*[0-9.]+\]", "[t]", ln) for ln in err.getvalue().splitlines()]


def test_log_behaves_the_same(monkeypatch):
    import prima_tpu.utils.log as jlog
    import prima_tpu_torch.utils.log as plog

    got = _log_lines(plog, monkeypatch)
    assert got == _log_lines(jlog, monkeypatch)
    assert got == ["[t] [info ] shown 2 and x", "[t] [warn ] careful", "[t] [error] bad thing"]


def test_perf_timers_behave_the_same(monkeypatch):
    import prima_tpu.utils.perf as jperf
    import prima_tpu_torch.utils.perf as pperf

    shapes = []
    for mod in (jperf, pperf):
        assert mod.ENABLED == (os.environ.get("PRIMA_TIMER", "0") == "1")
        monkeypatch.setattr(mod, "ENABLED", True)
        monkeypatch.setattr(mod, "_totals", type(mod._totals)(float))
        monkeypatch.setattr(mod, "_counts", type(mod._counts)(int))
        for name in ("load", "step", "step"):
            with mod.timer(name):
                pass
        out = io.StringIO()
        mod.report(file=out)
        shapes.append(sorted(re.sub(r"[0-9]+\.[0-9]+", "T", ln)
                             for ln in out.getvalue().splitlines()))
        monkeypatch.setattr(mod, "ENABLED", False)
        with mod.timer("off"):
            pass
        assert "off" not in mod._totals
    assert shapes[0] == shapes[1] and len(shapes[1]) == 2
    assert any("calls      2" in ln for ln in shapes[1])
