"""The port's CLI (prima_tpu_torch.tools.cli) against the JAX package's on
the trained tiny pair: the same greedy text for a plain prompt, under a
GBNF grammar and a JSON schema, and with the draft model (-md), f32
activations and KV on both sides; and the family runtimes' branches fail
on keyless GGUFs as the JAX CLI's do."""

import dataclasses
import os

import jax.numpy as jnp
import pytest
import torch

import prima_tpu.models.llama as jllama
import prima_tpu_torch.models.llama as llama
from prima_tpu.gguf.writer import GGUFWriter
from prima_tpu.tools.cli import main as jcli
from prima_tpu_torch.tools.cli import main as cli
from test_torch_speculative import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
DRAFT = os.path.join(ROOT, "models_tiny_pair", "draft.gguf")
COMMON = ["-m", TARGET, "-p", "Once upon a time", "-n", "20", "--temp", "0",
          "--no-display-prompt", "-ctk", "f32", "-c", "256"]


@pytest.fixture
def f32(monkeypatch):
    """Both CLIs build ForwardOptions(matmul_impl=...): default them to f32."""
    for mod, dt in ((jllama, jnp.float32), (llama, torch.float32)):
        base = mod.ForwardOptions
        monkeypatch.setattr(mod, "ForwardOptions",
                            lambda *a, base=base, dt=dt, **kw: dataclasses.replace(
                                base(*a, **kw), dtype=dt))


def _run(main, args, capsys) -> str:
    assert main(args) == 0
    return capsys.readouterr().out


def _both(args, capsys) -> tuple[str, str]:
    return (_run(jcli, COMMON + ["--matmul", "xla"] + args, capsys),
            _run(cli, COMMON + ["--device", "cpu"] + args, capsys))


def test_cli_greedy_text_matches_jax(f32, capsys):
    want, got = _both([], capsys)
    assert got == want and len(got.strip()) > 8


@pytest.mark.parametrize("constraint", [
    ["--grammar", 'root ::= ("yes" | "no" | "maybe") " " [a-z]+ "."'],
    ["--json-schema", '{"type":"object","properties":{"a":{"type":"integer"}},'
                      '"required":["a"]}'],
], ids=["grammar", "json-schema"])
def test_cli_constrained_text_matches_jax(f32, capsys, constraint):
    want, got = _both(constraint, capsys)
    assert got == want and len(got.strip()) > 2


def test_cli_draft_model_text_matches_jax(f32, capsys, monkeypatch):
    plain = _run(cli, COMMON + ["--device", "cpu"], capsys)
    # the JAX side through its host decoder (PRIMA_SPEC_FUSED=0); both are
    # lossless, so both give the plain text (the -md branch detokenizes the whole output, which drops the leading
    # space that the streamed plain output keeps)
    monkeypatch.setenv("PRIMA_SPEC_FUSED", "0")
    want = _run(jcli, COMMON + ["--matmul", "xla", "-md", DRAFT], capsys)
    assert want.strip() == plain.strip()
    for fused in ("0", "1"):
        monkeypatch.setenv("PRIMA_SPEC_FUSED", fused)
        assert _run(cli, COMMON + ["--device", "cpu", "-md", DRAFT], capsys) == want


@pytest.fixture(scope="module")
def arch_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("archs")
    out = {}
    for arch in ("t5", "rwkv6", "deepseek2", "mamba"):
        out[arch] = str(d / f"{arch}.gguf")
        GGUFWriter(out[arch], arch=arch).write()
    return out


def _outcome(main, args):
    try:
        return "rc", main(args)
    except Exception as e:  # noqa: BLE001 - the failure itself is compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("args", ["t5", "rwkv6", "deepseek2", "mamba"])
def test_cli_keyless_family_files_fail_like_jax(args, arch_files):
    """A GGUF of the arch with no keys reaches the family runtime's config
    in both CLIs, which fail alike."""
    want = _outcome(jcli, ["-m", arch_files[args], "-p", "x", "-n", "2"])
    got = _outcome(cli, ["-m", arch_files[args], "--device", "cpu", "-p", "x", "-n", "2"])
    assert got == want and want[0] != "rc"
