"""The PyTorch port stands alone: no module of prima_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package (prima_tpu)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "prima_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "prima_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_prima_tpu_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_matcher_is_whole_module_name():
    assert _forbidden("prima_tpu.models.llama")
    assert _forbidden("jax.numpy")
    assert not _forbidden("prima_tpu_torch.models.llama")
    assert not _forbidden("jaxtyping_like_name")


def _all_sources():
    """Every source file of the port (Python, C++, CUDA) and chip_smoke.py."""
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files
                if f.endswith((".py", ".cpp", ".cu", ".cuh", ".h"))]
    return sorted(out)


@pytest.mark.parametrize("path", _all_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_native_library(path):
    """The port builds its own native library from its own sources: none
    names the JAX package's native directory or its library."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert not [s for s in ("prima_tpu/native", "libprima_native") if s in text]
