"""The ring's entry points as processes on the CPU: the CLI at -w 2 (ranks
0 and 1, -lw 3,1 -k 1) prints the text of the CLI at -w 1, and the server
at -w 2 (-lw 2,2, 4 slots in 2 groups) answers 4 concurrent /completion
requests with the text of the one-process server, both in bf16, where the
wire's truncation to bf16 is lossless. The only
test file of the port that starts processes; every wait has a deadline."""

import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.server.app import serve
from prima_tpu_torch.tools.cli import main as cli
from test_torch_speculative import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
DEADLINE = 60.0
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
PROMPTS = ["Once upon a time", "The quick brown fox", "def main():", "import numpy as np"]


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(module: str, args: list) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT, env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(procs: list) -> list:
    """(returncode, stdout, stderr) of each process within the deadline; a
    process still running then is killed and fails the test."""
    out, t_end = [], time.time() + DEADLINE
    try:
        for p in procs:
            o, e = p.communicate(timeout=max(t_end - time.time(), 1))
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _ring(run) -> list:
    """run(data_port) -> [(rc, out, err)]; a new base port when a rank
    found one of its ports taken."""
    for _ in range(3):
        res = run(_port())
        if not any(rc and "Address already in use" in e for rc, _, e in res):
            return res
    return res


def test_cli_ring_matches_one_process(capsys):
    common = ["-m", TARGET, "-p", "Once upon a time", "-n", "16", "--temp", "0",
              "--no-display-prompt", "-c", "128", "--device", "cpu"]
    assert cli(common) == 0
    want = capsys.readouterr().out
    ring = ["-w", "2", "-lw", "3,1", "-k", "1"]
    res = _ring(lambda port: _finish([
        _spawn("prima_tpu_torch.tools.cli", common + ring + ["--data-port", str(port),
                                                             "--rank", str(r)])
        for r in (0, 1)]))
    for rc, _, err in res:
        assert rc == 0, err[-2000:]
    assert res[0][1] == want and len(want.strip()) > 8


def _post(port: int, body: dict) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=DEADLINE)
    try:
        conn.request("POST", "/completion", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    assert resp.status == 200, data[:200]
    return json.loads(data)["choices"][0]["text"]


def _texts(port: int) -> list:
    """The 4 prompts' greedy texts, requested at once."""
    out = [None] * len(PROMPTS)

    def one(i):
        out[i] = _post(port, {"prompt": PROMPTS[i], "max_tokens": 12, "temperature": 0})

    threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE)
        assert not t.is_alive()
    return out


def _wait_health(port: int, procs: list) -> None:
    t_end = time.time() + DEADLINE
    while time.time() < t_end:
        if any(p.poll() is not None for p in procs):
            return
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
            conn.request("GET", "/health")
            if json.loads(conn.getresponse().read()).get("status") == "ok":
                return
        except OSError:
            time.sleep(0.2)
    raise AssertionError("the ring server did not come up")


def test_server_ring_matches_one_process():
    m = load_model(TARGET, device="cpu")
    eng = Engine(m.cfg, m.params, n_slots=4, max_seq=256, n_batch=64,
                 eog_ids=m.eog_ids, device="cpu")
    httpd, ctx = serve(m, eng, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        want = _texts(httpd.server_address[1])
    finally:
        httpd.shutdown()
        ctx.worker.shutdown()
        httpd.server_close()

    got = {}

    def run(port):
        http_port = _port()
        common = ["-m", TARGET, "--device", "cpu", "-np", "4", "-c", "256", "-b", "64",
                  "-w", "2", "-lw", "2,2", "--data-port", str(port)]
        procs = [_spawn("prima_tpu_torch.server", common + ["--rank", str(r),
                                                            "--port", str(http_port)])
                 for r in (0, 1)]
        try:
            _wait_health(http_port, procs)
            if procs[0].poll() is None:
                got["texts"] = _texts(http_port)
        finally:
            procs[0].terminate()  # rank 0 sends STOP around the ring on its way out
        return _finish(procs)

    res = _ring(run)
    assert "texts" in got, "\n".join(e[-2000:] for _, _, e in res)
    assert got["texts"] == want and all(len(t) > 4 for t in want)


@pytest.mark.parametrize("flags", [["-w", "2", "--rank", "1"], ["-ngl", "1"]],
                         ids=["world", "ngl"])
def test_ring_entry_points_need_the_card_unless_asked_for_cpu(flags):
    """No fallback: without a GPU the ring's entry points raise before they
    touch the network, unless --device cpu."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["-m", TARGET, "-p", "x", "-n", "2", *flags])


@pytest.mark.parametrize("stagger", [False, True], ids=["at_once", "stagger"])
def test_ring_serve_runner_matches_engine(stagger, capsys):
    """tools/ring_serve.py's two ranks (on threads here): 4 prompts over 4
    slots in 2 groups give the one-process Engine's greedy tokens."""
    from prima_tpu_torch.tools.ring_serve import main as ring_serve

    m = load_model(TARGET, device="cpu")
    prompts = [m.tokenizer.encode(p, add_special=True) for p in PROMPTS]
    eng = Engine(m.cfg, m.params, n_slots=4, max_seq=128, n_batch=16, eog_ids=m.eog_ids,
                 device="cpu")
    want = [eng.run_to_completion(p, n_predict=6, reuse_prefix=False) for p in prompts]
    common = ["-m", TARGET, "--device", "cpu", "-w", "2", "-lw", "2,2", "--slots", "4"]
    for _ in range(3):
        port = str(_port())
        errs = []

        def rank(r):
            try:
                ring_serve(common + ["--data-port", port, "--rank", str(r)]
                           + (["--prompts-json", json.dumps(prompts)] if r == 0 else [])
                           + (["--stagger"] if stagger and r == 0 else []))
            except OSError as e:  # a port of this base is taken: another base
                errs.append(e)

        threads = [threading.Thread(target=rank, args=(r,), daemon=True) for r in (1, 0)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(DEADLINE)
            assert not t.is_alive()
        if not errs:
            break
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
