"""LoRA adapters and control vectors in the port against the JAX package:
adapter and control-vector GGUFs written with the JAX package's GGUFWriter
load to the same tensors in both packages; the trained tiny model's logits
under LoRA (scales 1.0 and 0.5, two adapters stacked) and under a control
vector match the JAX forward's within 1e-4 of max |logit| (f32); scale 0
gives the base logits bit for bit; and the port's server serves
/lora-adapters (GET, POST) as the JAX server does, with the same greedy
text at each scale."""

import http.client
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.gguf.writer import GGUFWriter
from prima_tpu.models import adapters as jad
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import forward as jforward
from prima_tpu.models.llama import init_kv_caches as jinit_kv
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.runtime.engine import Engine as JEngine
from prima_tpu.server.app import serve as jserve
from prima_tpu_torch.models import adapters as ad
from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.runtime.engine import Engine
from prima_tpu_torch.server.app import serve
from test_torch_speculative import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
TOL = 1e-4
# (gguf tensor name, (rows, cols) of the adapted weight) for the tiny target
PROJ = {"attn_q.weight": ("n_q", "e"), "attn_k.weight": ("n_kv", "e"),
        "attn_v.weight": ("n_kv", "e"), "attn_output.weight": ("e", "n_q"),
        "ffn_gate.weight": ("f", "e"), "ffn_up.weight": ("f", "e"),
        "ffn_down.weight": ("e", "f")}


def _dims(cfg) -> dict:
    return {"e": cfg.n_embd, "f": cfg.n_ff, "n_q": cfg.n_heads * cfg.head_dim,
            "n_kv": cfg.n_kv_heads * cfg.head_dim}


def write_lora(path, cfg, seed, rank=8, alpha=16.0, layers=None, names=PROJ, std=0.05):
    rng = np.random.default_rng(seed)
    dims = _dims(cfg)
    w = GGUFWriter(path, arch="llama")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.alpha", alpha)
    for li in layers if layers is not None else range(cfg.n_layers):
        for name in names:
            n, k = (dims[d] for d in PROJ[name])
            w.add_tensor(f"blk.{li}.{name}.lora_a",
                         (rng.standard_normal((rank, k)) * std).astype(np.float32))
            w.add_tensor(f"blk.{li}.{name}.lora_b",
                         (rng.standard_normal((n, rank)) * std).astype(np.float32))
    w.write()
    return path


def write_cvec(path, cfg, seed):
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, arch="controlvector")
    for li in range(1, cfg.n_layers + 1):  # direction.i follows layer i - 1
        w.add_tensor(f"direction.{li}",
                     (rng.standard_normal(cfg.n_embd) * 0.5).astype(np.float32))
    w.write()
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jm, m = jload_model(PAIR), load_model(PAIR, device="cpu")
    d = tmp_path_factory.mktemp("adapters")
    return {"jm": jm, "m": m,
            "lora": write_lora(str(d / "lora.gguf"), m.cfg, seed=1),
            "lora2": write_lora(str(d / "lora2.gguf"), m.cfg, seed=2, rank=4, alpha=0.0,
                                layers=[1, 3], names=["attn_q.weight", "ffn_down.weight"]),
            # strong enough to change the greedy text
            "lora_strong": write_lora(str(d / "lora_strong.gguf"), m.cfg, seed=4, std=0.2),
            "cvec": write_cvec(str(d / "cvec.gguf"), m.cfg, seed=3)}


TOKENS = np.asarray([[1, 40, 77, 101, 35, 120, 9, 64]], np.int32)


def _jlogits(jm, params):
    s = TOKENS.shape[1]
    kv = jinit_kv(jm.cfg, 1, 16, jnp.float32)
    logits, _ = jforward(params, jm.cfg, TOKENS, np.arange(s, dtype=np.int32)[None], kv,
                         np.zeros(1, np.int32), JOpts(matmul_impl="xla", dtype=jnp.float32))
    return np.asarray(logits)


def _logits(m, params):
    s = TOKENS.shape[1]
    kv = init_kv_caches(m.cfg, 1, 16, torch.float32, "cpu")
    with torch.no_grad():
        logits, _ = forward(params, m.cfg, torch.from_numpy(TOKENS).long(),
                            torch.arange(s, dtype=torch.int32)[None], kv,
                            torch.zeros(1, dtype=torch.int32),
                            ForwardOptions(dtype=torch.float32))
    return logits.numpy()


def _close(got, want):
    assert float(np.abs(got - want).max()) <= TOL * float(np.abs(want).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adapter_files_load_alike(models, dtype):
    jdt, dt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    for key in ("lora", "lora2"):
        want = jad.load_lora_gguf(models[key], scale=0.5, dtype=jdt)
        got = ad.load_lora_gguf(models[key], scale=0.5, dtype=dt, device="cpu")
        assert sorted(got) == sorted(want)
        for li, mods in want.items():
            assert sorted(got[li]) == sorted(mods)
            for name, (a, b, s) in mods.items():
                ga, gb, gs = got[li][name]
                assert gs == s and ga.dtype == dt
                for g, w in ((ga, a), (gb, b)):
                    assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))
    want = jad.load_control_vector(models["cvec"], strength=0.7)
    got = ad.load_control_vector(models["cvec"], strength=0.7, device="cpu")
    assert sorted(got) == sorted(want)
    for li in want:
        assert np.array_equal(got[li].numpy(), np.asarray(want[li]))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_lora_logits_match_jax(models, scale):
    jm, m = models["jm"], models["m"]
    jl = jad.load_lora_gguf(models["lora"], dtype=jnp.float32)
    lora = ad.load_lora_gguf(models["lora"], dtype=torch.float32, device="cpu")
    want = _jlogits(jm, jad.apply_lora(jm.params, jl, scale=scale))
    got = _logits(m, ad.apply_lora(m.params, lora, scale=scale))
    _close(got, want)
    base = _logits(m, m.params)
    assert float(np.abs(got - base).max()) > 1e-2  # the adapter moves the logits


def test_stacked_loras_match_jax(models):
    jm, m = models["jm"], models["m"]
    jp, p = jm.params, m.params
    for key, scale in (("lora", 1.0), ("lora2", 2.0)):
        jp = jad.apply_lora(jp, jad.load_lora_gguf(models[key], dtype=jnp.float32), scale)
        p = ad.apply_lora(p, ad.load_lora_gguf(models[key], dtype=torch.float32,
                                               device="cpu"), scale)
    assert len(p["layers"][1]["wq_lora"]) == 2
    _close(_logits(m, p), _jlogits(jm, jp))


def test_lora_scale_zero_is_base_bit_for_bit(models):
    m = models["m"]
    lora = ad.load_lora_gguf(models["lora"], dtype=torch.float32, device="cpu")
    base = _logits(m, m.params)
    assert np.array_equal(_logits(m, ad.apply_lora(m.params, lora, scale=0.0)), base)
    assert "wq_lora" not in m.params["layers"][0]  # apply_lora leaves its input alone


@pytest.mark.parametrize("strength", [1.0, -0.5])
def test_control_vector_logits_match_jax(models, strength):
    jm, m = models["jm"], models["m"]
    jc = jad.load_control_vector(models["cvec"], strength=strength)
    cv = ad.load_control_vector(models["cvec"], strength=strength, device="cpu")
    got = _logits(m, ad.apply_control_vector(m.params, cv, layer_start=1))
    _close(got, _jlogits(jm, jad.apply_control_vector(jm.params, jc, layer_start=1)))
    assert float(np.abs(got - _logits(m, m.params)).max()) > 1e-2
    assert "cvec" not in m.params["layers"][1]


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_server_lora_adapters_match_jax(models):
    jm, m = models["jm"], models["m"]
    jeng = JEngine(jm.cfg, jm.params, n_slots=1, max_seq=96, n_batch=32,
                   opts=JOpts(matmul_impl="xla", dtype=jnp.float32), kv_dtype=jnp.float32,
                   eog_ids=jm.eog_ids, scan=False)
    eng = Engine(m.cfg, m.params, n_slots=1, max_seq=96, n_batch=32,
                 opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                 eog_ids=m.eog_ids, device="cpu")
    jloras = [{"id": 0, "path": models["lora_strong"], "scale": 1.0,
               "data": jad.load_lora_gguf(models["lora_strong"], scale=1.0)}]
    loras = [{"id": 0, "path": models["lora_strong"], "scale": 1.0,
              "data": ad.load_lora_gguf(models["lora_strong"], scale=1.0, device="cpu")}]
    started = [jserve(jm, jeng, "127.0.0.1", 0, loras=jloras),
               serve(m, eng, "127.0.0.1", 0, loras=loras)]
    for _, ctx in started:
        ctx.set_lora_scales([{"id": 0, "scale": 1.0}])
    ports = [_start(httpd) for httpd, _ in started]
    # token prompts without BOS, each with another first token, so that no
    # request reuses a cached prefix computed at another scale
    prompts = {0.0: "Once upon a time", 1.0: "The quick brown fox", 0.5: "In the beginning"}
    # (the byte tokenizer starts every text with the 3 bytes of its space mark)
    toks = {sc: m.tokenizer.encode(t, add_special=False)[3:] for sc, t in prompts.items()}
    assert len({t[0] for t in toks.values()}) == 3
    plain = Engine(m.cfg, m.params, n_slots=1, max_seq=96, n_batch=32,
                   opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                   eog_ids=m.eog_ids, device="cpu")
    try:
        for scale in (0.0, 1.0, 0.5):
            texts = []
            for port in ports:
                st, listed = _req(port, "GET", "/lora-adapters")
                assert st == 200 and [(r["id"], r["path"]) for r in listed] == [
                    (0, models["lora_strong"])]
                st, ok = _req(port, "POST", "/lora-adapters", [{"id": 0, "scale": scale}])
                assert st == 200 and ok == {"success": True}
                assert _req(port, "GET", "/lora-adapters")[1][0]["scale"] == scale
                st, out = _req(port, "POST", "/completion",
                               {"prompt": toks[scale], "n_predict": 16, "temperature": 0})
                assert st == 200
                texts.append(out["choices"][0]["text"])
            assert texts[0] == texts[1], scale
            # scale 0 swaps the base params back in: the text without the adapter
            base = b"".join(m.tokenizer.decode_token_bytes(t) for t in
                            plain.run_to_completion(toks[scale], n_predict=16)).decode()
            assert (texts[1] == base) == (scale == 0.0), scale
        assert _req(ports[1], "POST", "/lora-adapters", [{"id": 3, "scale": 1.0}])[0] == 400
    finally:
        for httpd, ctx in started:
            httpd.shutdown()
            ctx.worker.shutdown()
            httpd.server_close()
