"""The port's speculative decoding against the JAX package on the trained
tiny pair (models_tiny_pair: a 4-layer target, a 2-layer draft), f32
activations and KV on both sides: host and fused speculative greedy are
token-identical to plain greedy, the acceptance counts equal the JAX
SpeculativeDecoder's, a sampled chain through the fused rounds equals the
port's plain fused stream, and the engine surface under them (verify_chain,
fork, prefill_only, kv.clear, kv.seq_add) matches the JAX engine's."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.runtime.engine import Engine as JEngine
from prima_tpu.runtime.speculative import SpeculativeDecoder as JSpec
from prima_tpu_torch.models.llama import ForwardOptions
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.runtime.speculative import SpeculativeDecoder
from prima_tpu_torch.runtime.speculative_fused import FusedSpeculative, fused_spec_eligible
from prima_tpu_torch.sampling import Sampler, SamplerParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
DRAFT = os.path.join(ROOT, "models_tiny_pair", "draft.gguf")
TEXTS = ["Once upon a time there was a", "The quick brown fox"]
N = 24
LOGITS_TOL = 1e-5  # of max |logit|


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """One PyTorch intra-op thread while a file runs (this one and the other
    files that import it): the suite runs test files in parallel processes,
    where per-op thread pools contend for the cores and the tiny models'
    ops run several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return {"jt": jload_model(TARGET), "jd": jload_model(DRAFT),
            "t": load_model(TARGET, device="cpu"), "d": load_model(DRAFT, device="cpu")}


def _eng(m, n_slots=1, kv_dtype=torch.float32):
    return Engine(m.cfg, m.params, n_slots=n_slots, max_seq=128, n_batch=32,
                  opts=ForwardOptions(dtype=torch.float32), kv_dtype=kv_dtype,
                  eog_ids=m.eog_ids, device="cpu")


def _jeng(m, n_slots=1, kv_dtype=jnp.float32):
    return JEngine(m.cfg, m.params, n_slots=n_slots, max_seq=128, n_batch=32,
                   opts=JOpts(matmul_impl="xla", dtype=jnp.float32), kv_dtype=kv_dtype,
                   eog_ids=m.eog_ids, scan=False)


def _prompt(pair, text=TEXTS[0]):
    return pair["t"].tokenizer.encode(text, add_special=True)


@pytest.fixture(scope="module")
def plain(pair):
    """The JAX package's plain greedy streams of TEXTS, and the port's."""
    out = {}
    for text in TEXTS:
        p = _prompt(pair, text)
        out[text] = _jeng(pair["jt"]).run_to_completion(p, n_predict=N)
        assert _eng(pair["t"]).run_to_completion(p, n_predict=N) == out[text]
    return out


def _spec(pair, fused: bool, monkeypatch, n_draft=8, p_min=0.75, draft="d", n_slots=1):
    monkeypatch.setenv("PRIMA_SPEC_FUSED", "1" if fused else "0")
    return SpeculativeDecoder(_eng(pair["t"], n_slots), _eng(pair[draft], n_slots),
                              n_draft=n_draft, p_min=p_min)


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_spec_greedy_matches_jax_plain(pair, plain, fused, monkeypatch):
    spec = _spec(pair, fused, monkeypatch)
    for text in TEXTS:
        out, stats = spec.generate(_prompt(pair, text), n_predict=N)
        assert out == plain[text]
        assert stats.n_drafted > 0 and stats.n_target_calls < N


def test_spec_stats_match_jax(pair, plain, monkeypatch):
    monkeypatch.setenv("PRIMA_SPEC_FUSED", "0")
    jspec = JSpec(_jeng(pair["jt"]), _jeng(pair["jd"]), n_draft=8, p_min=0.75)
    want_out, want = jspec.generate(_prompt(pair), n_predict=N)
    assert want_out == plain[TEXTS[0]]
    for fused in (False, True):
        out, got = _spec(pair, fused, monkeypatch).generate(_prompt(pair), n_predict=N)
        assert out == want_out
        assert (got.n_drafted, got.n_accepted) == (want.n_drafted, want.n_accepted)
        if not fused:
            assert (got.n_target_calls, got.n_draft_calls) == (want.n_target_calls,
                                                               want.n_draft_calls)


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_target_as_draft_accepts_every_draft(pair, plain, fused, monkeypatch):
    # 27 tokens: three rounds of 8 drafts and the target's own token
    spec = _spec(pair, fused, monkeypatch, p_min=0.0, draft="t")
    chains = []
    real = spec.target.verify_chain
    spec.target.verify_chain = lambda sid, chain: chains.append(len(chain)) or real(sid, chain)
    out, stats = spec.generate(_prompt(pair), n_predict=27)
    assert out[:N] == plain[TEXTS[0]]
    assert stats.n_drafted == 24 and stats.n_accepted == stats.n_drafted
    assert stats.n_target_calls == 3
    assert chains == ([] if fused else [9, 9, 9])


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_draft_max_zero_is_plain_decode(pair, plain, fused, monkeypatch):
    out, stats = _spec(pair, fused, monkeypatch, n_draft=0).generate(_prompt(pair),
                                                                     n_predict=N)
    assert out == plain[TEXTS[0]]
    assert stats.n_drafted == 0 and stats.n_target_calls == N


def _plain_fused(eng, prompt, sampler, n):
    s = eng.submit(prompt, sampler=sampler, n_predict=n)
    while s.state.name != "IDLE":
        eng.step_fused(max_chunk=8)
    return list(s.generated)


def test_sampled_fused_matches_plain_fused(pair):
    sp = lambda: Sampler(SamplerParams(temp=0.8, top_k=40, seed=11))
    assert fused_spec_eligible(sp())
    for text in TEXTS:
        want = _plain_fused(_eng(pair["t"]), _prompt(pair, text), sp(), N)
        fs = FusedSpeculative(_eng(pair["t"]), _eng(pair["d"]), n_draft=4, rounds=3)
        got, stats = fs.generate(_prompt(pair, text), sp(), n_predict=N)
        assert got == want
        assert stats.n_drafted > 0


def _close(got, want, tol=LOGITS_TOL):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


def _chains(eng, prompt):
    """Prefill, verify a chain of 6, roll back to 2 accepted (the cells past
    them stale), verify a chain of 5: the logits of both chains."""
    slot = eng.submit(prompt, n_predict=-1)
    eng.prefill_only(slot)
    pos0 = eng.kv.used(slot.id)
    a = eng.verify_chain(slot.id, [prompt[-1], 40, 41, 42, 43, 44])
    assert eng.kv.used(slot.id) == pos0 + 6
    eng.kv.cache_pos[slot.id] = pos0 + 2
    b = eng.verify_chain(slot.id, [50, 51, 52, 53, 54])
    return a, b


def _codes(caches, n):
    return np.concatenate([np.asarray(c.qs)[0, :n].ravel() for kv in caches for c in kv])


@pytest.mark.parametrize("kind", ["f32", "q8_0"])
def test_verify_chain_matches_jax(pair, kind):
    p = _prompt(pair)
    jeng = _jeng(pair["jt"], 2, jnp.float32 if kind == "f32" else "q8_0")
    eng = _eng(pair["t"], 2, torch.float32 if kind == "f32" else "q8_0")
    want, got = _chains(jeng, p), _chains(eng, p)
    tol = LOGITS_TOL
    if kind == "q8_0":
        # the packages quantize equal rows to equal codes (test_torch_kvquant);
        # the chains' K/V rows differ in the last f32 bits, and a value that
        # close to a rounding boundary takes the neighbouring code, one step
        # of scale / 127 in one element: the prompt's codes are equal, and the
        # chains' differ by 1 in no more than 4 codes a layer
        n = len(p) - 1
        assert np.array_equal(_codes(eng.kv.caches, n), _codes(jeng.kv.caches, n))
        d = (_codes(eng.kv.caches, n + 6).astype(np.int32)
             - _codes(jeng.kv.caches, n + 6).astype(np.int32))
        assert np.abs(d).max() <= 1 and np.count_nonzero(d) <= 4 * len(eng.kv.caches)
        tol = 1e-3
    for g, w in zip(got, want):
        _close(g, w, tol)
    # the rolled-back chain sees only its accepted prefix: the same logits as
    # a fresh cache that never held the stale cells
    eng = _eng(pair["t"], 1, torch.float32 if kind == "f32" else "q8_0")
    slot = eng.submit(p + [40, 50], n_predict=-1)
    eng.prefill_only(slot)
    _close(got[1], eng.verify_chain(slot.id, [50, 51, 52, 53, 54]), tol)


def _surface(eng, prompt, step):
    """fork, prefill_only, kv.seq_add and kv.clear on one engine; the greedy
    tokens and verify logits they lead to."""
    src = eng.submit(prompt, n_predict=-1)
    eng.prefill_only(src)
    out = {"after_prefill": int(eng.kv.used(src.id))}
    for _ in range(3):
        step(eng)
    fork = eng.fork(src, n_predict=4)
    out["fork_prompt"] = list(fork.prompt)
    out["fork_generated"] = list(fork.generated)
    src.n_predict = len(src.generated) + 4
    while fork.state.name != "IDLE" or src.state.name != "IDLE":
        step(eng)
    out["src"], out["fork"] = list(src.generated), list(fork.generated)
    # drop cells [2, 5) of the fork's row by moving the rest down
    used = eng.kv.used(fork.id)
    eng.kv.seq_add(fork.id, 5, used, -3)
    out["seq_add_used"] = int(eng.kv.used(fork.id))
    out["seq_add_logits"] = eng.verify_chain(fork.id, [7, 8])
    eng.kv.seq_add(src.id, 0, eng.kv.used(src.id), 2, move=False)
    out["rotate_logits"] = eng.verify_chain(src.id, [9])
    eng.kv.clear()
    out["cleared"] = [int(x) for x in eng.kv.cache_pos]
    return out


def test_fork_prefill_only_and_kv_ops_match_jax(pair):
    p = _prompt(pair, TEXTS[1])
    want = _surface(_jeng(pair["jt"], 2), p, lambda e: e.step())
    got = _surface(_eng(pair["t"], 2), p, lambda e: e.step())
    for key, w in want.items():
        if key.endswith("logits"):
            _close(got[key], w)
        else:
            assert got[key] == w, key
    assert got["cleared"] == [0, 0]


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_two_requests_speculate_per_slot(pair, plain, fused, monkeypatch):
    spec = _spec(pair, fused, monkeypatch, n_slots=2)
    gens = [spec.generate_stream(_prompt(pair, t), Sampler(SamplerParams(temp=0.0)), N)
            for t in TEXTS]
    outs, live = [[], []], [True, True]
    busy = []
    while any(live):
        for i, g in enumerate(gens):
            if live[i]:
                try:
                    outs[i].extend(next(g))
                except StopIteration:
                    live[i] = False
        busy.append(sum(s.state.name != "IDLE" for s in spec.target.slots))
    assert max(busy) == 2  # both slot pairs held at once
    assert [o[:N] for o in outs] == [plain[t] for t in TEXTS]
    assert all(s.state.name == "IDLE" for s in spec.target.slots + spec.draft.slots)


def test_server_speculative_options_are_accepted():
    from prima_tpu_torch.server.__main__ import _unported, build_parser

    args = build_parser().parse_args(["-m", TARGET, "-md", DRAFT, "--draft-max", "4",
                                      "--draft-p-min", "0.5", "--lora", "a.gguf",
                                      "--lora-scaled", "b.gguf", "0.25"])
    assert _unported(args) is None
    assert (args.model_draft, args.draft_max, args.draft_p_min) == (DRAFT, 4, 0.5)
    assert (args.lora, args.lora_scaled) == (["a.gguf"], [["b.gguf", "0.25"]])


def test_server_with_draft_matches_jax(pair, plain):
    """Two concurrent greedy requests on the servers with a draft model (one
    draft slot a server slot): the JAX server's text, which is the text of
    plain decoding."""
    import http.client
    import json
    import threading

    from prima_tpu.server.app import serve as jserve
    from prima_tpu_torch.server.app import serve

    started = [jserve(pair["jt"], _jeng(pair["jt"], 2), "127.0.0.1", 0,
                      spec=JSpec(_jeng(pair["jt"], 2), _jeng(pair["jd"], 2))),
               serve(pair["t"], _eng(pair["t"], 2), "127.0.0.1", 0,
                     spec=SpeculativeDecoder(_eng(pair["t"], 2), _eng(pair["d"], 2)))]
    for httpd, _ in started:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def complete(port, text, out):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/completion", json.dumps(
            {"prompt": text, "n_predict": N, "temperature": 0}))
        out[text] = json.loads(conn.getresponse().read())["choices"][0]["text"]
        conn.close()

    try:
        texts = []
        for httpd, _ in started:
            out = {}
            threads = [threading.Thread(target=complete, args=(httpd.server_address[1], t, out))
                       for t in TEXTS]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            texts.append(out)
        assert texts[1] == texts[0]
        tok = pair["t"].tokenizer
        for t in TEXTS:
            assert texts[1][t] == b"".join(tok.decode_token_bytes(x) for x in plain[t]).decode()
    finally:
        for httpd, ctx in started:
            httpd.shutdown()
            ctx.worker.shutdown()
            httpd.server_close()
