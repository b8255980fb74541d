"""The mixture-of-experts paths around the expert-indexed GEMV: its plain
version against qmatmul_plain of each pair's expert; decode through the
indexed GEMV and prefill through the dense loop over experts; stacked
experts carried across from the JAX package's params; the HTTP server on
tiny MoE and gemma2 models against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.gguf.constants import GGMLType
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu_torch.models import llama as L
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.quant import qmatmul as qm
from prima_tpu_torch.quant.device_format import to_device_format
from prima_tpu_torch.quant.qtensor import QTensor
from test_torch_archs import F32, MOE_TOL, Q4_K, Q8_0, run_both, write_model
from test_torch_model import _flatten_jax


def _stacked(t: GGMLType, n_exp: int, n: int, k: int, seed: int = 0) -> QTensor:
    from prima_tpu.quant.quantize_np import quantize

    x = np.random.default_rng(seed).standard_normal((n_exp * n, k)).astype(np.float32) * 0.1
    return QTensor.from_host(to_device_format(quantize(x, t), t, k), "cpu")


@pytest.mark.parametrize("ids", [[2, 0], [1, 1, 3, 0, 2, 2, 0, 3], [3] * 5])
@pytest.mark.parametrize("t,k", [(GGMLType.Q4_K, 256), (GGMLType.Q6_K, 512),
                                 (GGMLType.Q8_0, 64), (GGMLType.Q4_0, 96)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_indexed_gemv_plain_is_each_experts_product(t, k, ids):
    """Row p through expert ids[p]: repeated and out-of-order ids."""
    n_exp, n = 4, 48
    qt = _stacked(t, n_exp, n, k)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((len(ids), k))
                         .astype(np.float32))
    idt = torch.tensor(ids, dtype=torch.int32)
    got = qm.qgemv_indexed_plain(x, qt, idt, n)
    for p, e in enumerate(ids):
        want = qm.qmatmul_plain(x[p:p + 1], qt.rows(e * n, (e + 1) * n))[0]
        # the matmul sums in another order for another number of rows
        assert (got[p] - want).abs().max() <= 1e-6 * want.abs().max()
    # a CPU tensor takes the plain version through the kernel's wrapper too
    torch.testing.assert_close(qm.qgemv_indexed(x, qt, idt, n), got, rtol=0, atol=0)
    torch.testing.assert_close(qm.qmatmul_indexed(x.double(), qt, idt, n),
                               got.double(), rtol=0, atol=0)


def test_indexed_gemv_rejects_partial_experts():
    qt = _stacked(GGMLType.Q8_0, 4, 48, 64)
    with pytest.raises(ValueError, match="whole experts"):
        qm.qgemv_indexed_plain(torch.zeros(2, 64), qt, torch.zeros(2, dtype=torch.int32), 50)


def test_decode_takes_the_indexed_gemv_and_prefill_the_dense_loop(tmp_path, monkeypatch):
    m = load_model(write_model(tmp_path / "mixtral.gguf", "mixtral", Q8_0), device="cpu",
                   dtype=torch.float32)
    calls = []
    real = qm.qmatmul_indexed
    monkeypatch.setattr(L, "qmatmul_indexed",
                        lambda x, *a: calls.append(x.shape[0]) or real(x, *a))
    kv = L.init_kv_caches(m.cfg, 4, 32, torch.float32, "cpu")
    zeros = torch.zeros(4, dtype=torch.int32)
    opts = L.ForwardOptions(dtype=torch.float32)
    toks = torch.randint(0, m.cfg.n_vocab, (4, 8), generator=torch.Generator().manual_seed(0))
    L.forward(m.params, m.cfg, toks, torch.arange(8).repeat(4, 1), kv, zeros, opts)
    assert calls == []  # 32 rows x top-2: the dense loop over experts
    L.forward(m.params, m.cfg, toks[:, :1], torch.full((4, 1), 8), kv, zeros + 8, opts)
    # 4 rows x top-2 = 8 pairs: gate, up and down of each layer
    assert calls == [8] * 3 * m.cfg.n_layers


@pytest.mark.parametrize("ftype", [Q4_K, Q8_0, F32], ids=lambda t: t.name)
def test_params_from_numpy_stacked_experts(tmp_path, ftype):
    """The JAX package's stacked experts (a leading expert axis, sigma
    order, packed scales) carried across give the loader's layout and the
    JAX logits."""
    wide = ftype == Q4_K
    path = write_model(tmp_path / "mixtral.gguf", "mixtral", ftype,
                       n_embd=256 if wide else 64, n_ff=256 if wide else 96)
    jm = jload_model(path, dtype=jnp.float32)
    params = L.params_from_numpy(_flatten_jax(jm.params), "cpu")
    loaded = load_model(path, device="cpu", dtype=torch.float32)
    for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
        a, b = params["layers"][1][key], loaded.params["layers"][1][key]
        if ftype == F32:
            assert a.shape == b.shape == (4, *b.shape[1:])
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert (a.shape, a.layout, a.packed) == (b.shape, b.layout, b.packed)
            for x, y in zip(a.tensors(), b.tensors()):
                assert (x is None) == (y is None)
                if x is not None:
                    torch.testing.assert_close(x, y, rtol=0, atol=0)
    run = run_both(path, b=1, s=5, steps=0)
    cfg = loaded.cfg
    kv = L.init_kv_caches(cfg, 1, 16, torch.float32, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.n_vocab, (1, 5))
    with torch.no_grad():
        got, _ = L.forward(params, cfg, torch.from_numpy(toks), torch.arange(5)[None], kv,
                           torch.zeros(1, dtype=torch.int32), L.ForwardOptions(dtype=torch.float32))
    want = run["jax_logits"][0]
    assert np.abs(got.numpy() - want).max() <= MOE_TOL * np.abs(want).max()


@pytest.mark.parametrize("name", ["qwen2moe", "gemma2"])
def test_server_serves_the_arch_like_jax(tmp_path, name):
    """The port's HTTP server on a tiny mixture-of-experts and a gemma2
    model: /completion of a token-id prompt gives the JAX server's greedy
    text, 12 tokens of the tiny vocabulary (f32 on both sides)."""
    import http.client
    import json
    import threading

    from prima_tpu.models.llama import ForwardOptions as JOpts
    from prima_tpu.runtime.engine import Engine as JEngine
    from prima_tpu.server.app import serve as jserve
    from prima_tpu_torch.runtime.engine import Engine
    from prima_tpu_torch.server.app import serve

    path = write_model(tmp_path / f"{name}.gguf", name, Q8_0)
    jm = jload_model(path, dtype=jnp.float32)
    jeng = JEngine(jm.cfg, jm.params, n_slots=2, max_seq=64, n_batch=16,
                   opts=JOpts(matmul_impl="xla", dtype=jnp.float32), kv_dtype=jnp.float32,
                   scan=False)
    m = load_model(path, device="cpu", dtype=torch.float32)
    eng = Engine(m.cfg, m.params, n_slots=2, max_seq=64, n_batch=16,
                 opts=L.ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                 device="cpu")
    started = [jserve(jm, jeng, "127.0.0.1", 0), serve(m, eng, "127.0.0.1", 0)]
    out = []
    try:
        for httpd, _ in started:
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                              timeout=300)
            conn.request("POST", "/completion", json.dumps(
                {"prompt": [5, 17, 99, 3, 42, 8], "n_predict": 12, "temperature": 0}),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            body = json.loads(resp.read())
            conn.close()
            assert body["usage"]["completion_tokens"] == 12
            out.append(body)
    finally:
        for httpd, ctx in started:
            httpd.shutdown()
            ctx.worker.shutdown()
            httpd.server_close()
    assert out[1]["choices"][0]["text"] == out[0]["choices"][0]["text"]
