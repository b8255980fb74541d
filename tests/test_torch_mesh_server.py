"""The port's server over the mesh, started as a user starts it
(python -m prima_tpu_torch.server ... --pp 2 --tp 2: the server spawns its
three other ranks), on the trained tiny pair in f32: four concurrent
/completion requests give the JAX package's single-device greedy texts
(its server and Engine in f32 on the same prompts), also with a draft
model (-md: the mesh engine verifies the drafts); /props reports every
rank's launch counts."""

import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import pytest

from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.runtime.engine import Engine as JEngine
from prima_tpu.server.app import serve as jserve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
DRAFT = os.path.join(ROOT, "models_tiny_pair", "draft.gguf")
PROMPTS = ["Once upon a time", "The quick brown fox", "def main():", "import numpy as np"]
DEADLINE = 120.0


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(port: int, method: str, path: str, body=None) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=DEADLINE)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    assert resp.status == 200, data[:200]
    return json.loads(data)


def _texts(port: int) -> list:
    out = [None] * len(PROMPTS)

    def one(i):
        out[i] = _req(port, "POST", "/completion", {
            "prompt": PROMPTS[i], "max_tokens": 12, "temperature": 0})["choices"][0]["text"]

    threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE)
        assert not t.is_alive()
    return out


@pytest.fixture(scope="module")
def jax_texts():
    m = jload_model(TARGET)
    eng = JEngine(m.cfg, m.params, n_slots=4, max_seq=256, n_batch=64,
                  opts=JOpts(matmul_impl="xla", dtype=jnp.float32), kv_dtype=jnp.float32,
                  eog_ids=m.eog_ids)
    httpd, ctx = jserve(m, eng, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        return _texts(httpd.server_address[1])
    finally:
        httpd.shutdown()
        ctx.worker.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("flags", [["--pp", "2", "--tp", "2"], ["--pp", "2", "-md", DRAFT]],
                         ids=["pp2-tp2", "pp2-draft"])
def test_mesh_server_gives_the_jax_greedy_text(jax_texts, flags, tmp_path):
    port = _port()
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "prima_tpu_torch.server", "-m", TARGET, "--device", "cpu",
         "--dtype", "f32", "-ctk", "f32", "-np", "4", "-c", "256", "-b", "64", "--port",
         str(port), *flags], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        t_end = time.time() + DEADLINE
        while time.time() < t_end and proc.poll() is None:
            try:
                if _req(port, "GET", "/health").get("status") == "ok":
                    break
            except OSError:
                time.sleep(0.3)
        assert proc.poll() is None, (tmp_path / "server.log").read_text()[-3000:]
        assert _texts(port) == jax_texts and all(len(t) > 4 for t in jax_texts)
        props = _req(port, "GET", "/props")
        n_ranks = 4 if "--tp" in flags else 2
        assert len(props["kernel_launches_by_rank"]) == n_ranks
        assert props["total_slots"] == 4
    finally:
        proc.terminate()  # SIGTERM: rank 0 stops its ranks on the way out
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
        log.close()
    assert "mesh dp=1 pp=2" in (tmp_path / "server.log").read_text()
