"""The port's quantize toolchain against the JAX package's, byte for byte:
every encoder of QUANTIZE_FNS on seeded rows; the imatrix-weighted
encoders (Q4_K, Q5_K, Q6_K, IQ4_XS and the IQ1-IQ3 codebook searches);
the per-tensor type planner on the cases of tests/test_type_rules.py and
on every ftype over a Llama-3-8B tensor stream; imatrix files written and
read by either package; and quantize_gguf of one tiny GGUF to Q4_K_M (with
and without an imatrix), Q8_0, IQ4_XS, TQ2_0 and BF16, each result also
loaded by the port and decoded."""

import os

import numpy as np
import pytest
import torch

from prima_tpu.gguf.constants import GGMLType as JGGMLType
from prima_tpu.quant import quantize_imatrix as jqi
from prima_tpu.quant import quantize_np as jqnp
from prima_tpu.quant import type_rules as jrules
from prima_tpu.tools import quantize as jquantize
from prima_tpu.tools.make_tiny_gguf import make_tiny_gguf
from prima_tpu_torch.gguf.constants import GGMLType
from prima_tpu_torch.models.llama import ForwardOptions
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.quant import quantize_imatrix as qi
from prima_tpu_torch.quant import quantize_np as qnp
from prima_tpu_torch.quant import type_rules as rules
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.tools import quantize
from test_torch_speculative import torch_one_thread  # noqa: F401

ROWS, K = 4, 1024


def _rows(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((ROWS, K)) * 0.05).astype(np.float32)
    x[1] *= 20.0  # rows of other scales
    x[2, :64] = 0.0  # an all-zero block
    qw = (np.abs(rng.standard_normal(K)) + 0.1).astype(np.float32)
    qw[: K // 4] *= 50.0  # importance skewed to a quarter of the columns
    return x, qw


@pytest.mark.parametrize("t", sorted(qnp.QUANTIZE_FNS, key=int), ids=lambda t: t.name)
def test_quantize_bytes_equal(t):
    x, _ = _rows()
    assert sorted(int(k) for k in qnp.QUANTIZE_FNS) == sorted(int(k) for k in jqnp.QUANTIZE_FNS)
    got = np.asarray(qnp.quantize(x, t))
    want = np.asarray(jqnp.quantize(x, JGGMLType(int(t))))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


WEIGHTED = ["Q4_K", "Q5_K", "Q6_K", "IQ4_XS", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS",
            "IQ3_S", "IQ1_S", "IQ1_M"]


@pytest.mark.parametrize("name", WEIGHTED)
def test_quantize_weighted_bytes_equal(name):
    x, qw = _rows(seed=1)
    got = np.asarray(qi.quantize_weighted(x, GGMLType[name], qw))
    want = np.asarray(jqi.quantize_weighted(x, JGGMLType[name], qw))
    assert got.tobytes() == want.tobytes()
    # without an imatrix row: the unweighted encoder (IQ1-IQ3 have none)
    if GGMLType[name] in qnp.QUANTIZE_FNS:
        assert (np.asarray(qi.quantize_weighted(x, GGMLType[name], None)).tobytes()
                == np.asarray(qnp.quantize(x, GGMLType[name])).tobytes())


def _llama8b_stream() -> list:
    out = [("token_embd.weight", (128256, 4096))]
    for i in range(32):
        out += [(f"blk.{i}.attn_q.weight", (4096, 4096)),
                (f"blk.{i}.attn_k.weight", (1024, 4096)),
                (f"blk.{i}.attn_v.weight", (1024, 4096)),
                (f"blk.{i}.attn_output.weight", (4096, 4096)),
                (f"blk.{i}.ffn_gate.weight", (14336, 4096)),
                (f"blk.{i}.ffn_up.weight", (14336, 4096)),
                (f"blk.{i}.ffn_down.weight", (4096, 14336))]
    return out + [("output.weight", (128256, 4096))]


def _plans(ftype: str, stream: list, **kw) -> tuple[list, list]:
    """The port's and the JAX planner's types, tensor by tensor."""
    args = dict(n_layer=32, n_gqa=4, n_expert=0, arch="llama", n_attention_wv=32,
                n_ffn_down=32)
    args.update(kw)
    p, jp = rules.QuantPlanner(ftype=ftype, **args), jrules.QuantPlanner(ftype=ftype, **args)
    return ([p.get_type(n, s).name for n, s in stream],
            [jp.get_type(n, s).name for n, s in stream])


# the cases of tests/test_type_rules.py, as (ftype, stream edit, planner kwargs)
PLANNER_CASES = {
    "q4_k_m": ("Q4_K_M", None, {}),
    "q4_k_s": ("Q4_K_S", None, {}),
    "q3_k_m": ("Q3_K_M", None, {}),
    "q3_k_l": ("Q3_K_L", None, {}),
    "q3_k_s": ("Q3_K_S", None, {}),
    "q2_k": ("Q2_K", None, {}),
    "q2_k_nogqa": ("Q2_K", None, {"n_gqa": 1}),
    "q2_k_s": ("Q2_K_S", None, {}),
    "q5_k_m": ("Q5_K_M", None, {}),
    "tied": ("Q4_K_M", "tied", {"has_output": False}),
    "row_size": ("Q4_K_M", "row_size", {"n_layer": 2, "n_gqa": 1}),
    "row_size_q6": ("Q4_K_M", "row_size", {"n_layer": 8, "n_gqa": 1}),
    "attn_qkv": ("Q4_K_M", "qkv", {"n_layer": 2, "n_gqa": 1}),
    "attn_qkv_q5": ("Q5_K_M", "qkv", {"n_layer": 2, "n_gqa": 1}),
    "moe8": ("Q4_K_M", None, {"n_expert": 8}),
    "iq2_xs": ("IQ2_XS", None, {}),
    "imatrix": ("IQ2_XXS", None, {"has_imatrix": True}),
}
STREAM_EDITS = {
    "tied": lambda s: [t for t in s if t[0] != "output.weight"],
    "row_size": lambda s: [("blk.0.ffn_gate.weight", (64, 4000)),
                           ("output.weight", (100, 4000)),
                           ("blk.0.attn_v.weight", (64, 4000))],
    "qkv": lambda s: [("blk.0.attn_qkv.weight", (768, 4096)),
                      ("blk.1.attn_qkv.weight", (768, 4096))],
}


@pytest.mark.parametrize("case", list(PLANNER_CASES))
def test_planner_cases_match_jax(case):
    ftype, edit, kw = PLANNER_CASES[case]
    stream = _llama8b_stream()
    if edit:
        stream = STREAM_EDITS[edit](stream)
    got, want = _plans(ftype, stream, **kw)
    assert got == want


def test_planner_every_ftype_matches_jax():
    assert rules.FTYPE_DEFAULT.keys() == jrules.FTYPE_DEFAULT.keys()
    assert all(int(v) == int(jrules.FTYPE_DEFAULT[k]) for k, v in rules.FTYPE_DEFAULT.items())
    for ftype in rules.FTYPE_DEFAULT:
        got, want = _plans(ftype, _llama8b_stream())
        assert got == want, ftype
    assert ([rules.use_more_bits(i, n) for n in (8, 32, 80) for i in range(n)]
            == [jrules.use_more_bits(i, n) for n in (8, 32, 80) for i in range(n)])


def _stats(seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return {f"blk.{i}.{n}.weight": ((np.abs(rng.standard_normal(64)) * 3).astype(np.float32), 3)
            for i in range(2) for n in ("attn_q", "ffn_down")} | {
        "output.weight": (np.abs(rng.standard_normal(32)).astype(np.float32), 3)}


def test_imatrix_files_cross_both_ways(tmp_path):
    stats = _stats()
    mine, theirs = str(tmp_path / "port.imatrix"), str(tmp_path / "jax.imatrix")
    qi.save_imatrix(mine, stats, 3, dataset="calib.txt")
    jqi.save_imatrix(theirs, stats, 3, dataset="calib.txt")
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    for got in (qi.load_imatrix(theirs), jqi.load_imatrix(mine)):
        assert list(got) == list(stats)
        for k, (vals, ncall) in stats.items():
            assert got[k].dtype == np.float32
            assert got[k].tobytes() == (vals / ncall).astype(np.float32).tobytes()


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    d = tmp_path_factory.mktemp("quant")
    src = make_tiny_gguf(str(d / "tiny.gguf"), vocab_from=None, n_layers=1, n_ff=256, seed=3)
    rng = np.random.default_rng(4)
    stats = {}
    for name in ("blk.0.attn_q.weight", "blk.0.attn_k.weight", "blk.0.attn_v.weight",
                 "blk.0.attn_output.weight", "blk.0.ffn_gate.weight", "blk.0.ffn_up.weight",
                 "blk.0.ffn_down.weight", "output.weight"):
        k = 256
        stats[name] = ((np.abs(rng.standard_normal(k)) + 0.05).astype(np.float32) * 2, 2)
    im = str(d / "tiny.imatrix")
    qi.save_imatrix(im, stats, 2)
    return d, src, im


@pytest.mark.parametrize("ftype,with_imatrix", [
    ("Q4_K_M", False), ("Q4_K_M", True), ("Q8_0", False), ("IQ4_XS", False),
    ("TQ2_0", False), ("BF16", False)], ids=lambda v: str(v))
def test_quantize_gguf_bytes_equal_and_decodes(source, ftype, with_imatrix):
    d, src, im = source
    mine, theirs = str(d / f"port.{ftype}.gguf"), str(d / f"jax.{ftype}.gguf")
    null = open(os.devnull, "w")
    stats = quantize.quantize_gguf(src, mine, ftype, logfile=null,
                                   imatrix=qi.load_imatrix(im) if with_imatrix else None)
    jstats = jquantize.quantize_gguf(src, theirs, ftype, logfile=null,
                                     imatrix=jqi.load_imatrix(im) if with_imatrix else None)
    null.close()
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert {k: v for k, v in stats.items() if k != "seconds"} == \
        {k: v for k, v in jstats.items() if k != "seconds"}
    m = load_model(mine, device="cpu", dtype=torch.float32)
    eng = Engine(m.cfg, m.params, n_slots=1, max_seq=64, device="cpu",
                 opts=ForwardOptions(dtype=torch.float32))
    out = eng.run_to_completion([3, 5, 7], n_predict=4)
    assert len(out) == 4 and all(0 <= t < m.cfg.n_vocab for t in out)


def test_quantize_gguf_weighs_with_the_imatrix(source):
    """The imatrix changes the bytes of the weighted tensors and of no other."""
    d, src, im = source
    from prima_tpu_torch.gguf.reader import GGUFModel

    null = open(os.devnull, "w")
    a, b = str(d / "plain.gguf"), str(d / "weighted.gguf")
    quantize.quantize_gguf(src, a, "Q4_K_M", logfile=null)
    quantize.quantize_gguf(src, b, "Q4_K_M", logfile=null, imatrix=qi.load_imatrix(im))
    null.close()
    ma, mb = GGUFModel.open(a), GGUFModel.open(b)
    differ = {n for n in ma.tensors
              if ma.tensors[n].data.tobytes() != mb.tensors[n].data.tobytes()}
    assert differ and differ <= set(qi.load_imatrix(im))
    ma.close()
    mb.close()
