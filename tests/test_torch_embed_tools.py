"""The port's embedding serving and tools against the JAX package's on the
CPU: serve_embeddings on a tiny Q8_0 bert with a rank head, every path
with the JAX server's JSON (vectors and scores within 1e-5), concurrent
requests equal to sequential ones; the server's bert branch through main;
the server's `-c 0` resolved as the JAX server's (without the key, with
it, and with --override-kv, which the probe ignores), and its refusal of
--lora over the ring (a deliberate departure: the JAX ring drops the
adapters silently); the embedding tool (bert and decoder branches, every
output format, pooling and normalization) and the retrieval tool (-q and
the interactive loop) through main against the JAX tools' stdout: equal
text, printed numbers within 1e-5."""

import http.client
import io
import json
import os
import re
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from prima_tpu.gguf.reader import GGUFModel as JGGUFModel
from prima_tpu.gguf.writer import GGUFWriter
from prima_tpu.models import bert as jbert
from prima_tpu.server import __main__ as jserver_main
from prima_tpu.server.app import serve_embeddings as jserve_embeddings
from prima_tpu.tools import embedding as jembedding
from prima_tpu.tools import retrieval as jretrieval
from prima_tpu_torch.models import bert
from prima_tpu_torch.server import __main__ as server_main
from prima_tpu_torch.server import app
from prima_tpu_torch.tools import embedding, retrieval
from test_torch_archs import write_model
from test_torch_bert import Q8_0, write_bert
from test_torch_cli import f32  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
TOL = 1e-5
NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


@pytest.fixture(scope="module")
def bert_gguf(tmp_path_factory):
    return write_bert(tmp_path_factory.mktemp("bert") / "bert.gguf", ftype=Q8_0,
                      rank_head=True)


def _start(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd.server_address[1]


@pytest.fixture(scope="module")
def servers(bert_gguf):
    """(JAX server port, port server port) on the same GGUF."""
    jhttpd = jserve_embeddings(jbert.BertModelRuntime.load(bert_gguf), "127.0.0.1", 0)
    httpd = app.serve_embeddings(bert.BertModelRuntime.load(bert_gguf, device="cpu"),
                                 "127.0.0.1", 0)
    yield _start(jhttpd), _start(httpd)
    for h in (jhttpd, httpd):
        h.shutdown()
        h.server_close()


def call(port: int, method: str, path: str, body=None) -> tuple[int, object]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def same_json(got, want, scale: float) -> None:
    """Equal JSON but for floats, which agree within TOL * scale."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            same_json(got[k], want[k], scale)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            same_json(g, w, scale)
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= TOL * scale
    else:
        assert got == want


def _max_float(obj) -> float:
    if isinstance(obj, dict):
        return max([_max_float(v) for v in obj.values()] + [0.0])
    if isinstance(obj, list):
        return max([_max_float(v) for v in obj] + [0.0])
    return abs(obj) if isinstance(obj, float) else 0.0


DOCS = ["the quick brown fox", "a lazy dog sat on the mat", "red sky", "gpu card fast"]
REQUESTS = [
    ("GET", "/health", None), ("GET", "/v1/models", None), ("GET", "/props", None),
    ("POST", "/v1/embeddings", {"input": "hello world"}),
    ("POST", "/v1/embeddings", {"input": ["hello world", "the quick brown fox"]}),
    ("POST", "/embeddings", {"content": "searching documents"}),
    ("POST", "/embedding", {"content": ["red sky", "blue sky"]}),
    ("POST", "/v1/rerank", {"query": "quick fox", "documents": DOCS, "top_n": 3}),
    ("POST", "/rerank", {"query": "lazy dog", "documents": DOCS}),
    ("POST", "/v1/reranking", {"query": "sky", "documents": DOCS, "top_n": 0}),
    ("POST", "/v1/completions", {"prompt": "hi"}),
]


@pytest.mark.parametrize("method,path,body", REQUESTS,
                         ids=[f"{m}{p}-{i}" for i, (m, p, _) in enumerate(REQUESTS)])
def test_embeddings_server_matches_jax(servers, method, path, body):
    jport, port = servers
    wstatus, want = call(jport, method, path, body)
    status, got = call(port, method, path, body)
    if path == "/props":
        # the port's one addition (ROADMAP.md, Departures): the kernels'
        # launch counts, as on the decoder server; none on the CPU
        assert wstatus == 404 and status == 200
        assert got == {"kernel_launches": app.kernel_launches()}
        assert not any(got["kernel_launches"].values())
        return
    assert status == wstatus
    same_json(got, want, _max_float(want))
    if "rerank" in path:
        assert [r["index"] for r in got["results"]] == [r["index"] for r in want["results"]]
    if path.endswith("embeddings") and status == 200:
        for d in got["data"]:
            assert abs(np.linalg.norm(d["embedding"]) - 1.0) <= 1e-5


def test_concurrent_requests_equal_sequential(servers):
    _, port = servers
    texts = [["hello world"], ["the quick brown fox", "red sky"], ["gpu card fast"],
             ["searching documents on the card"]]
    seq = [call(port, "POST", "/v1/embeddings", {"input": t})[1] for t in texts]
    out = [None] * len(texts)

    def one(i):
        out[i] = call(port, "POST", "/v1/embeddings", {"input": texts[i]})[1]

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert out == seq


def test_server_main_serves_bert(bert_gguf, monkeypatch, capsys):
    """python -m prima_tpu_torch.server -m <bert>.gguf: the probe routes it
    to serve_embeddings, after a warm-up embed."""
    made = []

    def capture(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    real = app.serve_embeddings
    monkeypatch.setattr(app, "serve_embeddings", capture)
    rc = []
    t = threading.Thread(target=lambda: rc.append(server_main.main(
        ["-m", bert_gguf, "--device", "cpu", "--port", "0", "--matmul", "plain"])))
    t.start()
    for _ in range(600):
        if made or not t.is_alive():
            break
        t.join(0.1)
    assert made, "the server did not start"
    port = made[0].server_address[1]
    try:
        assert call(port, "GET", "/health") == (200, {"status": "ok"})
        status, got = call(port, "POST", "/v1/embeddings", {"input": "hello world"})
        want = bert.BertModelRuntime.load(bert_gguf, device="cpu").embed(["hello world"])[0]
        assert status == 200 and got["model"] == "prima-tpu"
        assert np.abs(np.asarray(got["data"][0]["embedding"]) - want).max() <= 1e-6
    finally:
        made[0].shutdown()
        t.join(30)
    assert rc == [0]
    assert "embeddings server on http://127.0.0.1:0" in capsys.readouterr().err


def rewrite_gguf(src: str, dst: str, drop: str) -> str:
    """`src` written again without the metadata key `drop`."""
    m = JGGUFModel.open(src)
    w = GGUFWriter(dst, arch=m.arch)
    for k, v in m.metadata.items():
        if k != drop and k != "general.architecture" and not k.startswith("GGUF."):
            w.add_kv(k, v)
    for ti in m.tensors.values():
        w.add_tensor(ti.name, np.asarray(ti.data), ne=ti.ne, ggml_type=ti.ggml_type)
    w.write()
    m.close()
    return dst


class _Stop(Exception):
    pass


def _engine_ctx(monkeypatch, module) -> list:
    """Records the max_seq a server main hands its Engine, which then
    raises _Stop."""
    seen = []

    def fake(*a, max_seq=None, **kw):
        seen.append(max_seq)
        raise _Stop

    monkeypatch.setattr(module, "Engine", fake)
    return seen


@pytest.mark.parametrize("case", ["no-key", "key", "override"])
def test_ctx_zero_resolves_like_jax(tmp_path, monkeypatch, case):
    from prima_tpu.runtime import engine as jengine
    from prima_tpu_torch.runtime import engine

    path = write_model(tmp_path / "m.gguf", "minicpm")  # context_length 512
    if case == "no-key":
        path = rewrite_gguf(path, str(tmp_path / "nokey.gguf"), "minicpm.context_length")
    argv = ["-m", path, "-c", "0"]
    if case == "override":
        argv += ["--override-kv", "minicpm.context_length=int:4096"]
    jseen = _engine_ctx(monkeypatch, jengine)
    with pytest.raises(_Stop):
        jserver_main.main(argv + ["--matmul", "xla"])
    seen = _engine_ctx(monkeypatch, engine)
    with pytest.raises(_Stop):
        server_main.main(argv + ["--device", "cpu"])
    assert seen == jseen == [2048 if case == "no-key" else 512]
    # the ring branch gets the same resolved value
    rings = []
    monkeypatch.setattr(server_main, "_ring_main", lambda a: rings.append(a.ctx_size) or 0)
    assert server_main.main(argv + ["--device", "cpu", "-w", "2"]) == 0
    assert rings == seen


def test_lora_over_the_ring_is_refused(tmp_path, capsys):
    """A departure kept on purpose: the JAX ring server ignores --lora and
    serves the base model; the port refuses it."""
    path = write_model(tmp_path / "m.gguf", "minicpm")
    rc = server_main.main(["-m", path, "-w", "2", "--lora", "a.gguf", "--device", "cpu"])
    assert rc == 1
    assert "--lora is not supported over the ring" in capsys.readouterr().err


# -- tools -------------------------------------------------------------------


def run(main, args, capsys, rc=0) -> str:
    got = main(args)
    cap = capsys.readouterr()
    assert got == rc, cap.err[-2000:]
    return cap.out


def same_text(got: str, want: str) -> None:
    """Equal text outside the numbers; the numbers within TOL * max(1, the
    largest printed)."""
    assert NUM.sub("#", got) == NUM.sub("#", want)
    g = np.asarray([float(x) for x in NUM.findall(got)])
    w = np.asarray([float(x) for x in NUM.findall(want)])
    assert g.shape == w.shape and g.size > 0
    assert np.abs(g - w).max() <= TOL * max(1.0, np.abs(w).max())


EMBED_ARGS = [
    [], ["--embd-output-format", "array"], ["--embd-output-format", "json"],
    ["--embd-output-format", "json+"], ["--pooling", "cls", "--embd-normalize", "-1"],
    ["--pooling", "last", "--embd-normalize", "0"], ["--embd-normalize", "1"],
    ["--embd-normalize", "3", "--embd-separator", "|", "-p", "red sky|blue sky|gpu"],
]


@pytest.mark.parametrize("extra", EMBED_ARGS, ids=[" ".join(a) or "default" for a in EMBED_ARGS])
def test_embedding_tool_bert_matches_jax(bert_gguf, capsys, extra):
    args = ["-m", bert_gguf, "-p", "hello world\\nthe quick brown fox"] + extra
    want = run(jembedding.main, args + ["--matmul", "xla"], capsys)
    got = run(embedding.main, args + ["--device", "cpu"], capsys)
    same_text(got, want)  # --embd-normalize 0 scales the largest entry to 32760


@pytest.fixture
def f32_kv(monkeypatch):
    """The decoder branch's Engines keep their caches in f32."""
    from prima_tpu.runtime import engine as jengine
    from prima_tpu_torch.runtime import engine

    for mod, dt in ((jengine, jnp.float32), (engine, torch.float32)):
        base = mod.Engine

        class F32Engine(base):
            def __init__(self, *a, base=base, dt=dt, **kw):
                kw["kv_dtype"] = dt
                base.__init__(self, *a, **kw)

        monkeypatch.setattr(mod, "Engine", F32Engine)


@pytest.mark.parametrize("extra", [[], ["--pooling", "last", "--embd-output-format", "json+"]],
                         ids=["mean", "last-json+"])
def test_embedding_tool_decoder_matches_jax(f32, f32_kv, capsys, extra):
    args = ["-m", TARGET, "-p", "Once upon a time\\nthe end", "-c", "64"] + extra
    want = run(jembedding.main, args + ["--matmul", "xla"], capsys)
    got = run(embedding.main, args + ["--device", "cpu"], capsys)
    same_text(got, want)


def test_embedding_normalize_and_cosine_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(4):
        v, u = rng.standard_normal(16), rng.standard_normal(16)
        for p in (-1, 0, 1, 2, 3):
            assert np.array_equal(embedding.normalize_embedding(v, p),
                                  jembedding.normalize_embedding(v, p))
        assert embedding.cosine_sim(v, u) == jembedding.cosine_sim(v, u)
    assert embedding.cosine_sim(np.zeros(3), np.ones(3)) == 0.0


CONTEXT = ("the quick brown fox jumps over the lazy dog.\nhello world again.\n"
           "the fox sat on the mat.\nred sky and blue sky.\ngpu card fast, tpu slow.\n") * 3


def test_retrieval_tool_matches_jax(bert_gguf, tmp_path, capsys, monkeypatch):
    ctx = tmp_path / "doc.txt"
    ctx.write_text(CONTEXT)
    assert retrieval.chunk_files([str(ctx)], 40, ".") == \
        jretrieval.chunk_files([str(ctx)], 40, ".")
    args = ["-m", bert_gguf, "--context-file", str(ctx), "--chunk-size", "40", "--top-k", "3"]
    want = run(jretrieval.main, args + ["-q", "quick fox"], capsys)
    got = run(retrieval.main, args + ["-q", "quick fox", "--device", "cpu"], capsys)
    same_text(got, want)
    assert got.count("\n") == 3
    # the interactive loop: two queries, then an empty line ends it
    outs = []
    for main, extra in ((jretrieval.main, []), (retrieval.main, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO("lazy dog\nred sky\n\n"))
        outs.append(run(main, args + extra, capsys))
    same_text(outs[1], outs[0])
    assert outs[1].count("Enter query: ") == 3


def test_tools_raise_without_cuda(bert_gguf):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for main in (embedding.main, retrieval.main):
        extra = ["--context-file", bert_gguf] if main is retrieval.main else []
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-m", bert_gguf] + extra)

