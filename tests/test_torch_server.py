"""The port's HTTP server on the CPU against the JAX package's server:
/completion (plain and streamed SSE) and /v1/chat/completions give the
same greedy text on the trained tiny model, f32 on both sides."""

import http.client
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.runtime.engine import Engine as JEngine
from prima_tpu.server.app import serve as jserve
from prima_tpu_torch.models.llama import ForwardOptions
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.server.__main__ import main as server_main
from prima_tpu_torch.server.app import serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(ROOT, "models_tiny_pair", "target.gguf")


def _start(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd.server_address[1]


@pytest.fixture(scope="module")
def servers():
    jm = jload_model(PAIR)
    jeng = JEngine(jm.cfg, jm.params, n_slots=2, max_seq=128, n_batch=32,
                   opts=JOpts(matmul_impl="xla", dtype=jnp.float32),
                   kv_dtype=jnp.float32, eog_ids=jm.eog_ids, scan=False)
    m = load_model(PAIR, device="cpu")
    eng = Engine(m.cfg, m.params, n_slots=2, max_seq=128, n_batch=32,
                 opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                 eog_ids=m.eog_ids, device="cpu")
    started = [jserve(jm, jeng, "127.0.0.1", 0), serve(m, eng, "127.0.0.1", 0)]
    ports = [_start(httpd) for httpd, _ in started]
    yield ports
    for httpd, ctx in started:
        httpd.shutdown()
        ctx.worker.shutdown()
        httpd.server_close()


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _sse_text(data: bytes) -> str:
    out = []
    for line in data.decode().split("\n"):
        if line.startswith("data: ") and line != "data: [DONE]":
            out.append(json.loads(line[6:])["choices"][0]["text"])
    return "".join(out)


GREEDY = {"n_predict": 16, "temperature": 0}


@pytest.mark.parametrize("prompt", ["def main():", "The quick brown fox"])
def test_completion_matches_jax(servers, prompt):
    texts = []
    for port in servers:
        st, data = _req(port, "POST", "/completion", dict(GREEDY, prompt=prompt))
        assert st == 200
        body = json.loads(data)
        assert body["usage"]["completion_tokens"] > 0
        texts.append(body["choices"][0]["text"])
    assert texts[1] == texts[0]


def test_streamed_completion_matches_jax(servers):
    texts = []
    for port in servers:
        st, data = _req(port, "POST", "/completion",
                        dict(GREEDY, prompt="import numpy as np", stream=True))
        assert st == 200
        texts.append(_sse_text(data))
    assert texts[1] == texts[0] and texts[0]


def test_chat_matches_jax(servers):
    msgs = [{"role": "user", "content": "Write a loop"}]
    texts = []
    for port in servers:
        st, data = _req(port, "POST", "/v1/chat/completions",
                        dict(GREEDY, max_tokens=16, messages=msgs))
        assert st == 200
        texts.append(json.loads(data)["choices"][0]["message"]["content"])
    assert texts[1] == texts[0]


def test_embeddings_match_jax(servers):
    vecs = []
    for port in servers:
        st, data = _req(port, "POST", "/v1/embeddings", {"input": "hello world"})
        assert st == 200
        vecs.append(np.asarray(json.loads(data)["data"][0]["embedding"]))
    assert vecs[1].shape == vecs[0].shape == (256,)
    np.testing.assert_allclose(vecs[1], vecs[0], rtol=0, atol=1e-4 * np.abs(vecs[0]).max())


def test_port_endpoints(servers):
    port = servers[1]
    st, data = _req(port, "GET", "/props")
    props = json.loads(data)
    assert st == 200 and set(props["kernel_launches"]) == {
        "qgemv", "qgemv_indexed", "kv_write", "kv_store", "flash_decode", "flash_prefill"}
    st, data = _req(port, "GET", "/metrics")
    assert st == 200 and b"prima:kernel_launches_total" in data
    # grammar requests are served: the one sentence of the grammar, then EOG
    st, data = _req(port, "POST", "/completion", dict(GREEDY, prompt="x", grammar="root ::= \"a\""))
    assert st == 200 and json.loads(data)["choices"][0]["text"] == "a"
    # llama.cpp's timing and queue series, from Engine.perf and the worker,
    # after a request that prefilled and decoded
    st, data = _req(port, "GET", "/metrics")
    values = dict(ln.rsplit(" ", 1) for ln in data.decode().splitlines()
                  if ln.startswith("llamacpp:"))
    assert float(values["llamacpp:prompt_seconds_total"]) > 0.0
    assert float(values["llamacpp:tokens_predicted_seconds_total"]) > 0.0
    assert values["llamacpp:requests_processing"] == "0"
    assert values["llamacpp:requests_deferred"] == "0"


def test_slot_file_crosses_servers(servers, tmp_path):
    """/slots/{id}?action=save on one server, restore on the other."""
    for src, dst in (servers, servers[::-1]):
        _req(src, "POST", "/completion", dict(GREEDY, prompt="class Foo:"))
        path = str(tmp_path / f"slot-{src}.bin")
        st, data = _req(src, "POST", "/slots/0?action=save", {"filename": path})
        assert st == 200
        n = json.loads(data)["n_saved"]
        st, data = _req(dst, "POST", "/slots/1?action=restore", {"filename": path})
        assert st == 200 and json.loads(data)["n_restored"] == n > 0


def test_long_context_options_are_accepted():
    from prima_tpu_torch.server.__main__ import _unported, build_parser

    args = build_parser().parse_args(["-m", PAIR, "-ctk", "q4_0", "-gan", "4", "-gaw", "256",
                                      "--slot-save-path", "slots"])
    assert _unported(args) is None
    assert (args.cache_type, args.grp_attn_n, args.grp_attn_w) == ("q4_0", 4, 256)


def test_unported_options_exit_with_error(capsys):
    """The mesh options are served now (tests/test_torch_mesh_server.py);
    what still exits with an error is the JAX server's own refusal: a LoRA
    adapter over a mesh exits 1 before any rank starts."""
    from prima_tpu_torch.server.__main__ import _unported, build_parser

    for flags in (["--pp", "2"], ["--tp", "2"]):
        assert _unported(build_parser().parse_args(["-m", PAIR, *flags])) is None
        assert server_main(["-m", PAIR, "--device", "cpu", "--lora", "a.gguf", *flags]) == 1
        assert "--lora is not supported in mesh-distributed mode" in capsys.readouterr().err
