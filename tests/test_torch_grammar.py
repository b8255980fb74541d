"""Grammar-constrained sampling in the port against the JAX package: the
copied grammar modules give the JAX modules' results (json_schema_to_gbnf
strings and matches over the cases of tests/test_json_schema.py, and the
GrammarSampler's accepted tokens over the trained tiny target's vocab),
and the port's server gives the JAX server's greedy text under a GBNF
grammar and under a JSON schema (f32 on both sides)."""

import http.client
import importlib.util
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.grammar import GrammarMatcher as JMatcher
from prima_tpu.grammar import parse_gbnf as jparse
from prima_tpu.grammar.engine import GrammarSampler as JSampler
from prima_tpu.grammar.json_schema import json_schema_to_gbnf as jconvert
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.runtime.engine import Engine as JEngine
from prima_tpu.server.app import serve as jserve
from prima_tpu_torch.grammar import GrammarMatcher, parse_gbnf
from prima_tpu_torch.grammar.engine import GrammarSampler
from prima_tpu_torch.grammar.json_schema import json_schema_to_gbnf
from prima_tpu_torch.models.llama import ForwardOptions
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.server.app import serve
from test_torch_speculative import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(ROOT, "models_tiny_pair", "target.gguf")


def _schema_cases():
    """The JAX package's JSON-schema tests, loaded under another name: each
    case's (schema, text) pairs are recorded while it runs against the JAX
    converter. The pydantic case tests a tool the port does not have."""
    spec = importlib.util.spec_from_file_location(
        "jax_json_schema_cases", os.path.join(ROOT, "tests", "test_json_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, sorted(n for n in vars(mod) if n.startswith("test_")
                       and n != "test_pydantic_models_to_grammar")


SCHEMA_MOD, SCHEMA_CASES = _schema_cases()


def _port_matches(schema, text: str) -> bool:
    m = GrammarMatcher(parse_gbnf(json_schema_to_gbnf(schema)))
    return m.advance_text(text.encode()) and m.is_complete()


@pytest.mark.parametrize("case", SCHEMA_CASES)
def test_json_schema_cases_match_jax(case, monkeypatch):
    seen = []
    real_matches, real_convert = SCHEMA_MOD._matches, SCHEMA_MOD.json_schema_to_gbnf

    def matches(schema, text):
        seen.append((schema, text))
        return real_matches(schema, text)

    def convert(schema):
        seen.append((schema, None))
        return real_convert(schema)

    monkeypatch.setattr(SCHEMA_MOD, "_matches", matches)
    monkeypatch.setattr(SCHEMA_MOD, "json_schema_to_gbnf", convert)
    getattr(SCHEMA_MOD, case)()
    assert seen
    for schema, text in seen:
        try:
            want = jconvert(schema)
        except ValueError:
            with pytest.raises(ValueError):
                json_schema_to_gbnf(schema)
            continue
        assert json_schema_to_gbnf(schema) == want
        if text is not None:
            assert _port_matches(schema, text) == real_matches(schema, text)


GRAMMARS = {
    "gbnf": 'root ::= ("yes" | "no" | "maybe") " " [a-z]+ "."',
    "json": jconvert({"type": "object", "properties": {
        "name": {"type": "string"}, "n": {"type": "integer"}}, "required": ["name", "n"]}),
    "list": 'root ::= item ("," item)*\nitem ::= [0-9]+ | "\\"" [^"\\n]* "\\""',
}


@pytest.fixture(scope="module")
def tiny():
    m = load_model(PAIR, device="cpu")
    vocab = [m.tokenizer.decode_token_bytes(i) for i in range(m.tokenizer.vocab.n_tokens)]
    return m, vocab


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_grammar_sampler_matches_jax_over_tiny_vocab(tiny, name):
    m, vocab = tiny
    gs = GrammarSampler(GRAMMARS[name], vocab, eog_ids=m.eog_ids)
    jgs = JSampler(GRAMMARS[name], vocab, eog_ids=m.eog_ids)
    rng = np.random.default_rng(len(name))
    for _ in range(40):
        got, want = np.zeros(len(vocab), np.float32), np.zeros(len(vocab), np.float32)
        gs.apply(got)
        jgs.apply(want)
        allowed = np.flatnonzero(np.isfinite(want))
        assert np.array_equal(np.isfinite(got), np.isfinite(want))
        assert all(gs.accepts(int(t)) == jgs.accepts(int(t)) for t in range(len(vocab)))
        if allowed.size == 0 or set(allowed) <= m.eog_ids:
            break
        tok = int(rng.choice([t for t in allowed if t not in m.eog_ids]))
        gs.accept(tok)
        jgs.accept(tok)
    # a complete sentence of the GBNF grammar matches in both packages
    for text, ok in ((b"maybe so.", True), (b"yes No.", False)):
        assert JMatcher(jparse(GRAMMARS["gbnf"])).advance_text(text) == ok
        assert GrammarMatcher(parse_gbnf(GRAMMARS["gbnf"])).advance_text(text) == ok


@pytest.fixture(scope="module")
def servers():
    jm = jload_model(PAIR)
    jeng = JEngine(jm.cfg, jm.params, n_slots=2, max_seq=128, n_batch=32,
                   opts=JOpts(matmul_impl="xla", dtype=jnp.float32), kv_dtype=jnp.float32,
                   eog_ids=jm.eog_ids, scan=False)
    m = load_model(PAIR, device="cpu")
    eng = Engine(m.cfg, m.params, n_slots=2, max_seq=128, n_batch=32,
                 opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                 eog_ids=m.eog_ids, device="cpu")
    started = [jserve(jm, jeng, "127.0.0.1", 0), serve(m, eng, "127.0.0.1", 0)]
    ports = []
    for httpd, _ in started:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        ports.append(httpd.server_address[1])
    yield ports
    for httpd, ctx in started:
        httpd.shutdown()
        ctx.worker.shutdown()
        httpd.server_close()


def _completion(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/completion", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    assert resp.status == 200, data
    return json.loads(data)["choices"][0]["text"]


SCHEMA = {"type": "object", "properties": {"name": {"type": "string"},
                                           "age": {"type": "integer"}},
          "required": ["name", "age"]}


@pytest.mark.parametrize("constraint", [
    {"grammar": GRAMMARS["gbnf"]},
    {"response_format": {"type": "json_schema", "json_schema": {"schema": SCHEMA}}},
    {"json_schema": SCHEMA},
], ids=["gbnf", "response_format", "json_schema"])
def test_server_constrained_text_matches_jax(servers, constraint):
    body = dict(constraint, prompt="Once upon a time", n_predict=24, temperature=0)
    want, got = (_completion(port, body) for port in servers)
    assert got == want and len(got) > 8
    gtext = constraint.get("grammar") or json_schema_to_gbnf(SCHEMA)
    assert GrammarMatcher(parse_gbnf(gtext)).advance_text(got.encode())
