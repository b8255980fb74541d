"""The port's perplexity tool against the JAX package's on the trained tiny
pair, f32 activations on both sides: the chunked perplexity within 1e-4
relative (as a function and through main), and the cases of
tests/test_perplexity_modes.py — HellaSwag (the same accuracy, and gold
detection is deterministic), the WinoGrande CSV parser (the same tasks)
and its score, the multiple-choice file round trip and its score, KL of a
model against its own base file near 0 and against another model's
clearly positive. The KL base files cross packages both ways, and for the
same log-prob rows the two writers give the same bytes."""

import io
import math
import os
import re
import struct

import numpy as np
import pytest

from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.tools import perplexity as jppl
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.tools import perplexity as ppl
from test_torch_cli import f32  # noqa: F401
from test_torch_speculative import torch_one_thread  # noqa: F401
from test_torch_tools import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
DRAFT = os.path.join(ROOT, "models_tiny_pair", "draft.gguf")
TEXT = "the quick brown fox jumps over the lazy dog. " * 8
REL = 1e-4
N_CTX = 64


def _quiet():
    return io.StringIO()


@pytest.fixture(scope="module")
def models():
    return {"port": load_model(TARGET, device="cpu"), "jax": jload_model(TARGET)}


def test_perplexity_matches_jax(f32, models, tmp_path):
    want, n_want = jppl.compute_perplexity(models["jax"], TEXT, n_ctx=N_CTX, matmul="xla",
                                           max_chunks=2, logfile=_quiet())
    got, n_got = ppl.compute_perplexity(models["port"], TEXT, n_ctx=N_CTX, max_chunks=2,
                                        logfile=_quiet(), device="cpu")
    assert n_got == n_want == 2 * (N_CTX - 1 - N_CTX // 2)
    assert math.isfinite(got) and got > 1.0
    assert abs(got - want) <= REL * want


def test_perplexity_main_matches_jax(f32, capsys, tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(TEXT)
    args = ["-m", TARGET, "-f", str(corpus), "-c", str(N_CTX), "--chunks", "2"]
    jout, _ = run(jppl.main, args + ["--matmul", "xla"], capsys)
    out, _ = run(ppl.main, args + ["--device", "cpu"], capsys)
    pat = r"final ppl = ([0-9.]+) over (\d+) tokens"
    (w, wn), (g, gn) = re.search(pat, jout).groups(), re.search(pat, out).groups()
    assert gn == wn and abs(float(g) - float(w)) <= REL * float(w) + 1e-4


def test_hellaswag_matches_jax(f32, models):
    tasks = []
    for i in range(3):
        tasks += [f"Activity {i}: someone is doing something", str(i % 4),
                  "and then it continues one way", "and then it continues another way",
                  "and then something else entirely happens", "and then it just ends"]
    want = jppl.hellaswag_score(models["jax"], "\n".join(tasks), n_tasks=0, matmul="xla",
                                logfile=_quiet())
    got = ppl.hellaswag_score(models["port"], "\n".join(tasks), n_tasks=0,
                              logfile=_quiet(), device="cpu")
    assert got == want and got[1] == 3


def test_hellaswag_gold_detection(models):
    lines = ["ctx: the cat sat", "1", "zzz qqq xxx", "on the mat", "zzz zzz zzz",
             "qqq qqq qqq"]
    a1 = ppl.hellaswag_score(models["port"], "\n".join(lines), n_tasks=0, logfile=_quiet(),
                             device="cpu")
    a2 = ppl.hellaswag_score(models["port"], "\n".join(lines), n_tasks=0, logfile=_quiet(),
                             device="cpu")
    assert a1 == a2 and a1[1] == 1


WINO = ('0,Sarah was a much better surgeon than Maria so _ always got the easier cases.,'
        'Sarah,Maria,2\n'
        '1,"The box, heavy as it was, fit in the _.",car,bag,1\n'
        '2,Alice gave Bob the book because _ was done reading.,Alice,Bob,1\n')


def test_winogrande_csv_parser():
    tasks = ppl._parse_winogrande_csv(WINO)
    assert tasks == jppl._parse_winogrande_csv(WINO)
    assert len(tasks) == 3 and tasks[0]["choices"] == ["Sarah", "Maria"]
    assert tasks[1]["first"] == "The box, heavy as it was, fit in the "


def test_winogrande_matches_jax(f32, models):
    want = jppl.winogrande_score(models["jax"], WINO, matmul="xla", logfile=_quiet())
    got = ppl.winogrande_score(models["port"], WINO, logfile=_quiet(), device="cpu")
    assert got == want and got[1] == 3


def _mc_blob(tasks):
    """Tasks in the reference's binary multiple-choice format."""
    def s(x: str) -> bytes:
        b = x.encode()
        return struct.pack("<I", len(b)) + b

    def answers(ans, labels):
        return (struct.pack("<I", len(ans)) + b"".join(s(a) for a in ans)
                + struct.pack(f"<{len(labels)}i", *labels))

    bodies = [s(q) + answers(ans, labels) + answers(["x"], [0]) for q, ans, labels in tasks]
    blob = struct.pack("<I", len(tasks))
    pos = 4 + 4 * len(tasks)
    for b in bodies:
        blob += struct.pack("<I", pos)
        pos += len(b)
    return blob + b"".join(bodies)


def test_multiple_choice_roundtrip_matches_jax(f32, models):
    blob = _mc_blob([("What color is the sky?", ["blue", "green", "loud"], [1, 0, 0]),
                     ("Two plus two is", ["four", "fish"], [1, 0])])
    parsed = ppl._read_mc_tasks(blob)
    assert parsed == jppl._read_mc_tasks(blob)
    assert parsed[0]["answers"] == ["blue", "green", "loud"] and parsed[0]["labels"] == [1, 0, 0]
    want = jppl.multiple_choice_score(models["jax"], blob, matmul="xla", logfile=_quiet())
    got = ppl.multiple_choice_score(models["port"], blob, logfile=_quiet(), device="cpu")
    assert got == want and got[1] == 2


def test_kl_self_is_zero_and_files_cross_packages(f32, models, tmp_path):
    """Each package's base file read by itself and by the other: KLD near
    0, ppl ratio near 1, the same top token everywhere."""
    files = {"port": str(tmp_path / "port.logits"), "jax": str(tmp_path / "jax.logits")}
    ppl.compute_perplexity(models["port"], TEXT, n_ctx=N_CTX, max_chunks=2, logfile=_quiet(),
                           logits_file=files["port"], device="cpu")
    jppl.compute_perplexity(models["jax"], TEXT, n_ctx=N_CTX, matmul="xla", max_chunks=2,
                            logfile=_quiet(), logits_file=files["jax"])
    head = [open(f, "rb").read(20 + 4 * 2 * N_CTX) for f in files.values()]
    assert head[0] == head[1]  # magic, n_ctx, n_vocab, n_chunk and the tokens
    assert os.path.getsize(files["port"]) == os.path.getsize(files["jax"])
    for reader, base in (("port", "port"), ("port", "jax"), ("jax", "port")):
        if reader == "port":
            out = ppl.kl_divergence(models["port"], files[base], logfile=_quiet(),
                                    device="cpu")
        else:
            out = jppl.kl_divergence(models["jax"], files[base], matmul="xla",
                                     logfile=_quiet())
        assert out["mean_kld"] < 1e-3, (reader, base)
        assert abs(out["ppl_ratio"] - 1.0) < 1e-2
        assert out["same_top_p"] == 100.0
        assert out["count"] == 2 * (N_CTX - 1 - N_CTX // 2)


def test_kl_detects_difference(models, tmp_path, capsys):
    base = str(tmp_path / "base.logits")
    ppl.compute_perplexity(models["port"], TEXT, n_ctx=N_CTX, max_chunks=1, logfile=_quiet(),
                           logits_file=base, device="cpu")
    out, _ = run(ppl.main, ["-m", DRAFT, "-f", base, "--kl-divergence", "--logits-file", base,
                            "--device", "cpu"], capsys)
    kld = float(re.search(r"final mean KLD = ([0-9.]+)", out).group(1))
    assert kld > 0.01


def test_logprob_writer_bytes_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 259)).astype(np.float32) * 4
    logits[1, :200] = -60.0  # rows with codes clipped at the -16 floor
    rows = logits - np.log(np.exp(logits.astype(np.float64)).sum(-1, keepdims=True))
    rows = rows.astype(np.float32)
    got, want = io.BytesIO(), io.BytesIO()
    ppl._write_logprob_rows(got, rows, 259)
    jppl._write_logprob_rows(want, rows, 259)
    assert got.getvalue() == want.getvalue() and len(got.getvalue()) == 5 * 2 * (2 * 130 + 4)


def test_chunk_logp_is_a_log_softmax(models):
    import torch

    from prima_tpu_torch.models.llama import ForwardOptions

    toks = torch.arange(3, 19)
    logp = ppl.chunk_logp(models["port"].params, models["port"].cfg, toks,
                          ForwardOptions(dtype=torch.float32))
    assert logp.shape == (16, 259) and logp.dtype == torch.float32
    assert torch.allclose(logp.exp().sum(-1), torch.ones(16), atol=1e-5)
