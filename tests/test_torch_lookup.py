"""The port's n-gram cache and lookup decoding against the JAX package's:
update, draft, save, load and merge give the JAX module's results and the
cache files are byte-equal both ways; LookupDecoder on the trained tiny
target (f32 activations and KV) gives the JAX decoder's tokens and
LookupStats and equals plain greedy; the lookup tool's create, merge,
stats and run print the JAX tool's lines, and each tool reads the other's
cache files."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.runtime import ngram_cache as jnc
from prima_tpu.runtime.engine import Engine as JEngine
from prima_tpu.sampling import Sampler as JSampler
from prima_tpu.sampling import SamplerParams as JSamplerParams
from prima_tpu.tools import lookup as jlookup
from prima_tpu_torch.models.llama import ForwardOptions
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.runtime import ngram_cache as nc
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.sampling import Sampler, SamplerParams
from prima_tpu_torch.tools import lookup
from test_torch_cli import f32  # noqa: F401
from test_torch_speculative import torch_one_thread  # noqa: F401
from test_torch_tools import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
CORPUS = ("Once upon a time there was a little fox. The fox ran to the river. "
          "Once upon a time there was a little bird. The bird flew to the river. ") * 6


def _seqs():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 40, 24).tolist()
    return [[5, 6, 7, 8] * 6, list(range(50)), base + base[:10] + [1, 2, 3] + base,
            [1, 2, 3, 1, 2, 3, 1, 2]]


@pytest.mark.parametrize("lo,hi", [(1, 4), (2, 2), (1, 2)])
def test_update_matches_jax(lo, hi):
    for toks in _seqs():
        got, want = {}, {}
        nc.update(got, lo, hi, toks, len(toks))
        jnc.update(want, lo, hi, toks, len(toks))
        assert got == want
        inc = {}  # incremental update equals the batch update
        nc.update(inc, lo, hi, toks[:5], 5)
        nc.update(inc, lo, hi, toks, len(toks) - 5)
        assert inc == got


def test_draft_matches_jax():
    seqs = _seqs()
    static, jstatic, dynamic = {}, {}, {}
    nc.update(static, nc.NGRAM_STATIC, nc.NGRAM_STATIC, seqs[2], len(seqs[2]))
    jnc.update(jstatic, 2, 2, seqs[2], len(seqs[2]))
    nc.update(dynamic, 2, 2, seqs[0], len(seqs[0]))
    for toks in seqs:
        for n_draft in (1, 4, 8):
            for cut in range(2, len(toks)):
                ctx = {}
                nc.update(ctx, nc.NGRAM_MIN, nc.NGRAM_MAX, toks[:cut], cut)
                got, want = [toks[cut - 1]], [toks[cut - 1]]
                nc.draft(toks[:cut], got, n_draft, 1, 4, ctx, dynamic, static)
                jnc.draft(toks[:cut], want, n_draft, 1, 4, ctx, dynamic, jstatic)
                assert got == want
    chain = [8]
    ctx = {}
    nc.update(ctx, 1, 4, seqs[0], len(seqs[0]))
    nc.draft(seqs[0], chain, 4, 1, 4, ctx, {}, {})
    assert chain[1:] == [5, 6, 7, 8]


def test_save_load_merge_cross_packages(tmp_path):
    c1, c2 = {}, {}
    nc.update(c1, 2, 2, [1, 2, 3, 1, 2, 3], 6)
    nc.update(c2, 1, 4, _seqs()[2], len(_seqs()[2]))
    for name, c in (("a", c1), ("b", c2)):
        nc.save(c, str(tmp_path / f"{name}.port"))
        jnc.save(c, str(tmp_path / f"{name}.jax"))
        port, jax_ = tmp_path / f"{name}.port", tmp_path / f"{name}.jax"
        assert port.read_bytes() == jax_.read_bytes()
        assert nc.load(str(jax_)) == jnc.load(str(port)) == c
    merged, jmerged = nc.load(str(tmp_path / "a.port")), jnc.load(str(tmp_path / "a.jax"))
    nc.merge(merged, nc.load(str(tmp_path / "b.jax")))
    jnc.merge(jmerged, jnc.load(str(tmp_path / "b.port")))
    assert merged == jmerged
    assert merged[(1, 2, -1, -1)][3] == c1[(1, 2, -1, -1)][3] + c2.get(
        (1, 2, -1, -1), {}).get(3, 0)


# -- LookupDecoder on the tiny target -------------------------------------------


@pytest.fixture(scope="module")
def target():
    return {"port": load_model(TARGET, device="cpu"), "jax": jload_model(TARGET)}


def _engine(m):
    return Engine(m.cfg, m.params, n_slots=1, max_seq=256, n_batch=32,
                  opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                  eog_ids=m.eog_ids, device="cpu")


def _jengine(m):
    return JEngine(m.cfg, m.params, n_slots=1, max_seq=256, n_batch=32,
                   opts=JOpts(matmul_impl="xla", dtype=jnp.float32), kv_dtype=jnp.float32,
                   eog_ids=m.eog_ids, scan=False)


@pytest.mark.parametrize("text,n_draft,static", [
    ("Once upon a time there was a little fox. Once upon a time", 8, False),
    ("The fox ran to the river.", 4, True)], ids=["context", "static"])
def test_lookup_decoder_matches_jax(target, text, n_draft, static):
    m = target["port"]
    prompt = m.tokenizer.encode(text, add_special=True)
    nc_static = {}
    if static:
        toks = m.tokenizer.encode(CORPUS, add_special=True)
        nc.update(nc_static, 2, 2, toks, len(toks))
    dec = nc.LookupDecoder(_engine(m), n_draft=n_draft, nc_static=dict(nc_static))
    got, stats = dec.generate(prompt, Sampler(SamplerParams(temp=0.0)), n_predict=24)
    jdec = jnc.LookupDecoder(_jengine(target["jax"]), n_draft=n_draft,
                             nc_static=dict(nc_static))
    want, jstats = jdec.generate(prompt, JSampler(JSamplerParams(temp=0.0)), n_predict=24)
    assert got == want
    assert (stats.n_target_calls, stats.n_drafted, stats.n_accepted) == \
        (jstats.n_target_calls, jstats.n_drafted, jstats.n_accepted)
    assert stats.n_drafted > 0 and stats.n_target_calls < 24
    assert dec.nc_dynamic == jdec.nc_dynamic != {}
    assert got == _engine(m).run_to_completion(prompt, n_predict=24)


# -- the lookup tool -----------------------------------------------------------


def test_lookup_tool_matches_jax(f32, capsys, tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(CORPUS)
    c = {side: str(tmp_path / f"static.{side}") for side in ("port", "jax")}
    for side, main, extra in (("port", lookup.main, ["--device", "cpu"]),
                              ("jax", jlookup.main, ["--matmul", "xla"])):
        run(main, ["create", "-m", TARGET, "-f", str(corpus), "-o", c[side]] + extra, capsys)
    assert open(c["port"], "rb").read() == open(c["jax"], "rb").read()
    merged = {side: str(tmp_path / f"merged.{side}") for side in c}
    run(lookup.main, ["merge", c["jax"], c["port"], "-o", merged["port"]], capsys)
    run(jlookup.main, ["merge", c["port"], c["jax"], "-o", merged["jax"]], capsys)
    assert open(merged["port"], "rb").read() == open(merged["jax"], "rb").read()

    stats = ["stats", "-m", TARGET, "-f", str(corpus), "-c", "64"]
    want, _ = run(jlookup.main, stats + ["-lcs", c["port"], "--matmul", "xla"], capsys)
    got, _ = run(lookup.main, stats + ["-lcs", c["jax"], "--device", "cpu"], capsys)
    assert got == want and "n_accepted" in got

    gen = ["run", "-m", TARGET, "-p", "Once upon a time there was", "-n", "24"]
    want, _ = run(jlookup.main, gen + ["-lcs", c["port"], "--matmul", "xla"], capsys)
    got, err = run(lookup.main, gen + ["-lcs", c["jax"], "--device", "cpu"], capsys)
    assert got == want and "target calls" in err
