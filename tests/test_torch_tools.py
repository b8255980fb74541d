"""The port's engine tools against the JAX package's, through each tool's
main on the trained tiny pair (models_tiny_pair), f32 activations on both
sides: simple, batched, parallel, speculative, save_load_state, passkey
and lookahead print the JAX tool's deterministic lines; infill covers the
cases of tests/test_infill.py. The passkey tool is held to its contract:
with a context that fits it prints the response and the FOUND / NOT FOUND
line, and with one too small it exits 1 with the JAX tool's error on
stderr and nothing on stdout. gritlm is in test_torch_gritlm.py, the
benchmark tools in test_torch_tools_bench.py, perplexity in
test_torch_perplexity.py and lookup in test_torch_lookup.py."""

import os
import re

import pytest

from prima_tpu.tools import batched as jbatched
from prima_tpu.tools import infill as jinfill
from prima_tpu.tools import lookahead as jlookahead
from prima_tpu.tools import parallel as jparallel
from prima_tpu.tools import passkey as jpasskey
from prima_tpu.tools import save_load_state as jsave_load_state
from prima_tpu.tools import simple as jsimple
from prima_tpu.tools import speculative as jspeculative
from prima_tpu.tools.make_tiny_gguf import make_tiny_gguf
from prima_tpu_torch.tools import (batched, infill, lookahead, parallel, passkey,
                                   save_load_state, simple, speculative)
from test_torch_cli import f32  # noqa: F401
from test_torch_speculative import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
DRAFT = os.path.join(ROOT, "models_tiny_pair", "draft.gguf")
FIM = ["<|fim_prefix|>", "<|fim_suffix|>", "<|fim_middle|>"]


def run(main, args, capsys, rc=0) -> tuple[str, str]:
    got = main(args)
    cap = capsys.readouterr()
    assert got == rc, cap.err[-2000:]
    return cap.out, cap.err


def both(jmain, main, args, capsys, rc=0) -> tuple[str, str]:
    """The JAX tool's stdout (--matmul xla) and the port's (--device cpu)."""
    want, _ = run(jmain, args + ["--matmul", "xla"], capsys, rc)
    got, _ = run(main, args + ["--device", "cpu"], capsys, rc)
    return want, got


def test_simple_matches_jax(f32, capsys):
    want, got = both(jsimple.main, simple.main, ["-m", TARGET, "-p", "Once upon", "-n", "16"],
                     capsys)
    assert got == want and got.startswith("Once upon") and len(got) > 12


def test_batched_matches_jax(f32, capsys):
    want, got = both(jbatched.main, batched.main,
                     ["-m", TARGET, "-p", "The quick", "-np", "3", "-n", "12", "--temp", "0",
                      "-c", "128"], capsys)
    assert got == want and got.count("sequence ") == 3


def test_batched_sampled_runs(capsys):
    out, _ = run(batched.main, ["-m", TARGET, "-np", "2", "-n", "8", "-c", "128",
                                "--device", "cpu"], capsys)
    assert out.count("sequence ") == 2


def _no_latency(text: str) -> str:
    return re.sub(r"\(\s*[0-9.]+s, ", "(", text)


def test_parallel_matches_jax(f32, capsys):
    want, got = both(jparallel.main, parallel.main,
                     ["-m", TARGET, "-np", "2", "-ns", "3", "-n", "8", "--no-system",
                      "-c", "128"], capsys)
    assert _no_latency(got) == _no_latency(want) and got.count("[seq ") == 3


def test_speculative_matches_jax(f32, capsys):
    args = ["-m", TARGET, "-md", DRAFT, "-p", "Once upon a time", "-n", "20", "-c", "256"]
    want, got = both(jspeculative.main, speculative.main, args, capsys)
    plain, _ = run(simple.main, ["-m", TARGET, "-p", "Once upon a time", "-n", "20",
                                 "--device", "cpu"], capsys)
    assert got == want == plain


def test_save_load_state_matches_jax(f32, capsys):
    want, got = both(jsave_load_state.main, save_load_state.main,
                     ["-m", TARGET, "-p", "Once upon", "-n", "12", "--temp", "0"], capsys)
    assert got == want and got.count("run: ") == 4


def test_save_load_state_sampled(capsys):
    out, err = run(save_load_state.main, ["-m", TARGET, "-p", "Once upon", "-n", "12",
                                          "--device", "cpu"], capsys)
    runs = [ln.split("run: ", 1)[1] for ln in out.splitlines() if "run: " in ln]
    assert len(runs) == 4 and len(set(runs)) == 1 and "success" in err


def test_passkey_fits(f32, capsys):
    args = ["-m", TARGET, "--junk", "2", "--pos", "1", "-s", "3", "-c", "1024", "-n", "4"]
    got = passkey.main(args + ["--device", "cpu"])
    out, _ = capsys.readouterr()
    assert got in (0, 1)
    lines = out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("response: ")
    assert re.fullmatch(r"passkey \d+: (FOUND|NOT FOUND)", lines[1])
    assert got == (0 if lines[1].endswith(": FOUND") else 1)
    jrc = jpasskey.main(args + ["--matmul", "xla"])
    assert (jrc, capsys.readouterr().out) == (got, out)


def test_passkey_context_too_small(capsys):
    args = ["-m", TARGET, "--junk", "2", "--pos", "1", "-s", "3", "-c", "512", "-n", "4"]
    out, err = run(passkey.main, args + ["--device", "cpu"], capsys, rc=1)
    jout, jerr = run(jpasskey.main, args + ["--matmul", "xla"], capsys, rc=1)
    assert out == jout == ""
    want = [ln for ln in jerr.splitlines() if ln.startswith("error: ")]
    assert len(want) == 1 and "does not fit in ctx (512)" in want[0]
    assert [ln for ln in err.splitlines() if ln.startswith("error: ")] == want


def test_lookahead_tool_matches_jax(f32, capsys):
    args = ["-m", TARGET, "-p", "Once upon a time", "-n", "16", "--temp", "0",
            "--lookahead-w", "4", "--lookahead-n", "3", "--lookahead-g", "4"]
    want, got = both(jlookahead.main, lookahead.main, args, capsys)
    plain, _ = run(simple.main, ["-m", TARGET, "-p", "Once upon a time", "-n", "16",
                                 "--device", "cpu"], capsys)
    assert got == want == plain


# -- infill (the cases of tests/test_infill.py) ------------------------------


@pytest.fixture(scope="module")
def fim_model(tmp_path_factory):
    return make_tiny_gguf(str(tmp_path_factory.mktemp("m") / "fim.gguf"), seed=3,
                          extra_tokens=FIM)


def test_infill_detect_and_build(fim_model):
    from prima_tpu.models.loader import load_model as jload_model
    from prima_tpu.tokenizer.fim import build_infill_prompt as jbuild
    from prima_tpu_torch.models.loader import load_model
    from prima_tpu_torch.tokenizer.fim import build_infill_prompt, detect_fim_tokens

    m, jm = load_model(fim_model, device="cpu"), jload_model(fim_model)
    pre, suf, mid = detect_fim_tokens(m.tokenizer.vocab)
    for spm in (False, True):
        toks = build_infill_prompt(m.tokenizer, "ab", "cd", spm_infill=spm)
        assert toks == jbuild(jm.tokenizer, "ab", "cd", spm_infill=spm)
        assert toks[0] == m.tokenizer.vocab.bos_id and toks[-1] == mid
        assert toks[1] == (suf if spm else pre)


def test_infill_no_fim_tokens_raises(tmp_path):
    from prima_tpu_torch.models.loader import load_model
    from prima_tpu_torch.tokenizer.fim import build_infill_prompt

    path = make_tiny_gguf(str(tmp_path / "plain.gguf"), seed=3, vocab_from=None)
    with pytest.raises(ValueError):
        build_infill_prompt(load_model(path, device="cpu").tokenizer, "a", "b")


def test_infill_tool_matches_jax(fim_model, f32, capsys):
    want, got = both(jinfill.main, infill.main,
                     ["-m", fim_model, "--in-prefix", "def f():", "--in-suffix", "return x",
                      "-n", "6", "--temp", "0", "-c", "128"], capsys)
    assert got == want
    assert got.startswith("def f():") and got.rstrip().endswith("return x")


def test_infill_tool_rejects_plain_model(tmp_path, capsys):
    path = make_tiny_gguf(str(tmp_path / "plain.gguf"), seed=3, vocab_from=None)
    _, err = run(infill.main, ["-m", path, "--device", "cpu"], capsys, rc=1)
    assert "no FIM" in err


def test_infill_fim_kv_ids_preferred(tmp_path):
    from prima_tpu_torch.models.loader import load_model
    from prima_tpu_torch.tokenizer.fim import detect_fim_tokens

    path = make_tiny_gguf(str(tmp_path / "kvfim.gguf"), seed=3,
                          extra_tokens=["▁<PRE>", "▁<SUF>", "▁<MID>"])
    v = load_model(path, device="cpu").tokenizer.vocab
    assert detect_fim_tokens(v) is not None
    v.fim_pre_id, v.fim_suf_id, v.fim_mid_id = 7, 8, 9
    assert detect_fim_tokens(v) == (7, 8, 9)
