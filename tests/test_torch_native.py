"""prima_tpu_torch.native: the C++ GGUF block converter against the port's
numpy route (to_device_format + pack_scales_np) bit for bit, its unpacked
fields against the JAX package's converter, the loader's three quantized
sites (plain, fused rows, split rows) natively against PRIMA_NO_NATIVE=1
and against the JAX forward, the numpy oracle (models/ref_numpy.py) against
the port's forward, and how the library builds (on first use, a compile
error raised, two processes building at once)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import param_leaves
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import forward as jforward
from prima_tpu.models.llama import init_kv_caches as jinit_kv
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.native import get_lib as jget_lib
from prima_tpu.native import native_convert as jnative_convert
from prima_tpu_torch import native
from prima_tpu_torch.gguf.constants import GGMLType
from prima_tpu_torch.gguf.writer import GGUFWriter
from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.models.ref_numpy import forward_np
from prima_tpu_torch.quant.dequant_np import dequantize
from prima_tpu_torch.quant.device_format import to_device_format
from prima_tpu_torch.quant.qtensor import QTensor, pack_scales_np, qtensor_from_raw
from prima_tpu_torch.quant.quantize_np import quantize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q4_K, Q4_0, Q5_K, Q6_K, Q8_0 = (GGMLType.Q4_K, GGMLType.Q4_0, GGMLType.Q5_K,
                                GGMLType.Q6_K, GGMLType.Q8_0)
NATIVE = [Q4_K, Q4_0, Q6_K, Q8_0]
# more rows than the converter's most threads (32) times its 4 rows a
# thread, so every thread converts rows; 1 row takes the one-thread path
MANY_ROWS = 4 * 32 + 3
FIELDS = ("qs", "scales", "mins", "d", "dmin")
META = ("sub", "layout", "q_offset", "shape", "gsub", "packed")
TOL = 1e-4  # logits vs the JAX forward, of max |logit| (test_torch_model.py)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="no g++")


def _raw(t, rows: int, k: int, seed: int = 0) -> np.ndarray:
    x = (np.random.default_rng(seed).standard_normal((rows, k)) * 0.07).astype(np.float32)
    return quantize(x, t)


def _same(a, b, what: str) -> None:
    assert (a is None) == (b is None), what
    if a is not None:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)


# K = 512: S = 16 sub-blocks, Q4_K packs; K = 768: S = 24, it stays grouped
@pytest.mark.parametrize("rows,k", [(1, 512), (1, 768), (MANY_ROWS, 512), (MANY_ROWS, 768)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("t", NATIVE, ids=lambda t: t.name)
def test_convert_matches_numpy(t, rows, k):
    raw = _raw(t, rows, k)
    uq = to_device_format(raw, t, k)
    scales, mins, d, dmin, packed = pack_scales_np(uq.scales, uq.mins, uq.d, uq.dmin, uq.gsub)
    assert packed == (t == Q4_K and k == 512)
    got = native.native_convert(raw, t, k, packed)
    for name, a, b in zip(FIELDS, got, (uq.qs, scales, mins, d, dmin)):
        _same(a, b, f"{t.name} {name}")


@pytest.mark.parametrize("k", [512, 768])
@pytest.mark.parametrize("t", NATIVE, ids=lambda t: t.name)
def test_unpacked_matches_jax_native(t, k):
    """Natural order, unpacked: the JAX converter's kperm=False output."""
    if jget_lib() is None:
        pytest.skip("the JAX package's native library did not build")
    raw = _raw(t, MANY_ROWS, k, seed=1)
    want = jnative_convert(raw, t, k, False)
    got = native.native_convert(raw, t, k, False)
    for name, a, b in zip(FIELDS, got, want):
        _same(a, b, f"{t.name} {name}")


@pytest.mark.parametrize("k", [512, 768])
@pytest.mark.parametrize("t", NATIVE + [Q5_K], ids=lambda t: t.name)
def test_qtensor_from_raw_equals_from_host(t, k):
    """The five arrays and the metadata QTensor.from_host gives; Q5_K has
    no converter, so None (the caller takes the numpy route) and no count."""
    raw = _raw(t, 40, k, seed=2)
    before = native.CONVERTED.count
    got = qtensor_from_raw(raw, t, (40, k), "cpu")
    if t == Q5_K:
        assert got is None and native.CONVERTED.count == before
        return
    assert native.CONVERTED.count == before + 1
    want = QTensor.from_host(to_device_format(raw, t, k), "cpu")
    for f in FIELDS:
        _same(getattr(got, f), getattr(want, f), f)
    assert [getattr(got, m) for m in META] == [getattr(want, m) for m in META]


def test_no_native_takes_numpy(monkeypatch):
    raw = _raw(Q4_K, 8, 512)
    monkeypatch.setenv("PRIMA_NO_NATIVE", "1")
    before = native.CONVERTED.count
    assert native.get_lib() is None
    assert native.native_convert(raw, Q4_K, 512, True) is None
    assert qtensor_from_raw(raw, Q4_K, (8, 512), "cpu") is None
    assert native.CONVERTED.count == before
    monkeypatch.delenv("PRIMA_NO_NATIVE")
    assert native.get_lib() is not None


# ---------------------------------------------------------------------------
# the loader's sites
# ---------------------------------------------------------------------------

# per-tensor types of the tiny models: every native type, Q4_K packed
# (K = n_embd = 512) and grouped (K = n_ff = 768)
LAYER_TYPES = [
    {"attn_q": Q4_K, "attn_k": Q4_0, "attn_v": Q6_K, "attn_output": Q8_0,
     "ffn_gate": Q4_K, "ffn_up": Q6_K, "ffn_down": Q4_K},
    # the same type for q / k / v and for gate / up, so fuse=True joins them
    {"attn_q": Q4_K, "attn_k": Q4_K, "attn_v": Q4_K, "attn_output": Q4_0,
     "ffn_gate": Q8_0, "ffn_up": Q8_0, "ffn_down": Q6_K},
]


def write_gguf(path: str, arch: str = "llama", n_vocab: int = 256, n_embd: int = 512,
               n_heads: int = 8, n_kv: int = 4, n_ff: int = 768, seed: int = 0) -> dict:
    """A 2-layer GGUF of LAYER_TYPES written by the port's writer; phi3
    stores attn_qkv and gate + up (ffn_up) as one tensor each. Returns the
    dense f32 weights by GGUF name (the numpy oracle's input)."""
    rng = np.random.default_rng(seed)
    hd = n_embd // n_heads
    w = GGUFWriter(path, arch=arch)
    for key, val in {"block_count": len(LAYER_TYPES), "embedding_length": n_embd,
                     "attention.head_count": n_heads, "attention.head_count_kv": n_kv,
                     "feed_forward_length": n_ff, "context_length": 512,
                     "attention.layer_norm_rms_epsilon": 1e-5, "rope.freq_base": 10000.0,
                     "rope.dimension_count": hd}.items():
        w.add_kv(f"{arch}.{key}", val)
    w.add_kv("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(n_vocab)])
    dense = {}

    def mat(name, rows, cols, t):
        x = (rng.standard_normal((rows, cols)) * 0.05).astype(np.float32)
        raw = quantize(x, t)
        w.add_tensor(name, raw, ne=(cols, rows), ggml_type=t)
        dense[name] = dequantize(raw, t, cols).reshape(rows, cols)

    def vec(name, n, around=1.0):
        dense[name] = (around + rng.standard_normal(n) * 0.05).astype(np.float32)
        w.add_tensor(name, dense[name])

    mat("token_embd.weight", n_vocab, n_embd, Q4_K)
    for i, types in enumerate(LAYER_TYPES):
        p = f"blk.{i}."
        vec(p + "attn_norm.weight", n_embd)
        nq, nk = n_heads * hd, n_kv * hd
        if arch == "phi3":
            mat(p + "attn_qkv.weight", nq + 2 * nk, n_embd, types["attn_q"])
        else:
            for t, n in (("q", nq), ("k", nk), ("v", nk)):
                mat(p + f"attn_{t}.weight", n, n_embd, types[f"attn_{t}"])
                if arch == "qwen2":
                    vec(p + f"attn_{t}.bias", n, around=0.0)
        mat(p + "attn_output.weight", n_embd, nq, types["attn_output"])
        vec(p + "ffn_norm.weight", n_embd)
        if arch == "phi3":
            mat(p + "ffn_up.weight", 2 * n_ff, n_embd, types["ffn_gate"])
        else:
            mat(p + "ffn_gate.weight", n_ff, n_embd, types["ffn_gate"])
            mat(p + "ffn_up.weight", n_ff, n_embd, types["ffn_up"])
        mat(p + "ffn_down.weight", n_embd, n_ff, types["ffn_down"])
    vec("output_norm.weight", n_embd)
    mat("output.weight", n_vocab, n_embd, Q6_K)
    w.write()
    return dense


def _port_logits(params, cfg, toks: np.ndarray) -> torch.Tensor:
    b, s = toks.shape
    kv = init_kv_caches(cfg, b, 16, torch.float32, "cpu")
    pos = torch.from_numpy(np.tile(np.arange(s, dtype=np.int32), (b, 1)))
    with torch.no_grad():
        logits, _ = forward(params, cfg, torch.from_numpy(toks).long(), pos, kv,
                            torch.zeros(b, dtype=torch.int32), ForwardOptions(dtype=torch.float32))
    return logits


# (arch, fuse, the conversions a load makes): 9 quantized tensors a llama
# layer, 2 outside; fuse joins q / k / v and gate / up of layer 1 (3 + 2
# tensors into 2); phi3 splits attn_qkv into 3 and ffn_up into 2
LOADS = [("llama", False, 2 + 2 * 7), ("llama", True, 2 + 7 + 4), ("phi3", False, 2 + 2 * 7)]


@pytest.mark.parametrize("arch,fuse,n_conv", LOADS,
                         ids=["llama", "llama-fused", "phi3-split"])
def test_load_model_native_equals_numpy(tmp_path, monkeypatch, arch, fuse, n_conv):
    path = str(tmp_path / f"{arch}.gguf")
    write_gguf(path, arch)
    before = native.CONVERTED.count
    nat = load_model(path, device="cpu", dtype=torch.float32, fuse=fuse)
    assert native.CONVERTED.count - before == n_conv
    assert ("wqkv" in nat.params["layers"][1]) == fuse
    monkeypatch.setenv("PRIMA_NO_NATIVE", "1")
    ref = load_model(path, device="cpu", dtype=torch.float32, fuse=fuse)
    assert native.CONVERTED.count - before == n_conv
    monkeypatch.delenv("PRIMA_NO_NATIVE")

    got, want = dict(param_leaves(nat.params)), dict(param_leaves(ref.params))
    assert got.keys() == want.keys()
    assert sum(isinstance(v, QTensor) for v in got.values()) == n_conv
    for key, a in got.items():
        b = want[key]
        if isinstance(a, QTensor):
            for f in FIELDS:
                _same(None if getattr(a, f) is None else getattr(a, f).numpy(),
                      None if getattr(b, f) is None else getattr(b, f).numpy(), f"{key}.{f}")
            assert [getattr(a, m) for m in META] == [getattr(b, m) for m in META], key
        else:
            assert torch.equal(a, b), key

    toks = np.random.default_rng(1).integers(0, nat.cfg.n_vocab, (2, 9)).astype(np.int32)
    logits = _port_logits(nat.params, nat.cfg, toks)
    assert torch.equal(logits, _port_logits(ref.params, ref.cfg, toks))

    jm = jload_model(path, dtype=jnp.float32)
    kv = jinit_kv(jm.cfg, 2, 16, jnp.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    jl, _ = jforward(jm.params, jm.cfg, toks, pos, kv, np.zeros(2, np.int32),
                     JOpts(matmul_impl="xla", dtype=jnp.float32))
    jl = np.asarray(jl)
    assert np.abs(logits.numpy() - jl).max() <= TOL * np.abs(jl).max()


@pytest.mark.parametrize("arch", ["llama", "qwen2"])
def test_forward_matches_numpy_oracle(tmp_path, arch):
    """The port's forward against models/ref_numpy.py's independent numpy
    forward on the dequantized weights, at tests/test_model_forward.py's
    tolerance."""
    path = str(tmp_path / f"{arch}.gguf")
    dense = write_gguf(path, arch, seed=3)
    m = load_model(path, device="cpu", dtype=torch.float32)
    assert m.cfg.arch == arch
    toks = np.random.default_rng(4).integers(0, m.cfg.n_vocab, (2, 7)).astype(np.int32)
    want = forward_np(dense, m.cfg, toks)
    np.testing.assert_allclose(_port_logits(m.params, m.cfg, toks).numpy(), want,
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_compile_error_raises(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int prima_broken( { return 0; }\n')
    out = tmp_path / "lib"
    with pytest.raises(RuntimeError, match=r"g\+\+ failed") as e:
        native.build([str(src)], str(out))
    assert "error" in str(e.value)  # the compiler's stderr
    assert not [f for f in os.listdir(out) if f.endswith((".so", ".tmp"))]


_LOAD = """
import ctypes, sys
from prima_tpu_torch import native
path = native.build(native.SOURCES, sys.argv[1])
lib = native._bind(ctypes.CDLL(path))
print(path)
"""


def test_two_processes_build_one_library(tmp_path):
    out = str(tmp_path / "lib")
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, out], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    results = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in results]
    paths = {stdout.strip() for stdout, _ in results}
    assert len(paths) == 1
    files = sorted(os.listdir(out))
    assert [f for f in files if f.endswith(".so")] == [os.path.basename(paths.pop())]
    assert not [f for f in files if f.endswith(".tmp")]


def test_prebuilt_library(tmp_path, monkeypatch):
    """PRIMA_TORCH_NATIVE_LIB loads a prebuilt library; one that is not a
    build of the port's sources, such as a library exporting the JAX
    package's converter symbols, is refused."""
    path = native.build()
    monkeypatch.setenv("PRIMA_TORCH_NATIVE_LIB", path)
    monkeypatch.setattr(native, "_lib", None)
    assert native.get_lib()._name == path
    raw = _raw(Q8_0, 3, 64)
    _same(native.native_convert(raw, Q8_0, 64)[0], to_device_format(raw, Q8_0, 64).qs, "qs")

    src = tmp_path / "other.cpp"
    src.write_text('extern "C" void prima_conv_q4k(const void*, long, long, void*, void*, '
                   'void*, void*, float*, int, int) {}\n')
    monkeypatch.setenv("PRIMA_TORCH_NATIVE_LIB", native.build([str(src)], str(tmp_path / "o")))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="is not a build of"):
        native.get_lib()


def test_import_builds_nothing():
    code = ("import prima_tpu_torch.native as n, prima_tpu_torch.models.loader, "
            "prima_tpu_torch.tokenizer.native; print(n._lib)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "None"


def test_malformed_blocks_raise():
    raw = _raw(Q4_K, 4, 512)
    with pytest.raises(ValueError, match="Q4_K"):
        native.native_convert(raw[:, :-1], Q4_K, 512)  # a row short of its last byte
    with pytest.raises(ValueError, match="Q8_0"):
        native.native_convert(raw.view(np.int8), Q8_0, 512)
