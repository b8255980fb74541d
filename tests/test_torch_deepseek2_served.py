"""DeepSeek-V2 on the port's served path (ModelConfig.from_gguf ->
llama.load_params -> Engine / EngineWorker): latent attention over a
latent cache in the absorbed form, a dense first layer, routed experts
under raw softmax weights and an ungated shared expert, YaRN.

A tiny deepseek2 (3 layers, layer 0 dense, 8 experts, top-3, 1 shared
expert, YaRN factor 40 at an original context of 64) is made from a seed by
the benchmark's block maker and written with GGUFWriter. Held against the
benchmark's plain float32 reference (benchmark/archs/deepseek2.py, the
published form with every latent decompressed), which is itself held
against the JAX package's deepseek2_forward on the same file. 12 slots
make 36 (row, expert) pairs a decode step, past the indexed GEMV's 32, so
decode takes the chunked indexed route.

On the card (marked cuda, skipped here; the card's machine has no JAX, so
run it there without the suite's conftest):

    python -m pytest --noconftest -q tests/test_torch_deepseek2_served.py -m cuda
"""

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from benchmark.reference import Reference
from benchmark.synth import synth_gguf
from prima_tpu_torch.gguf.constants import GGMLType
from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.gguf.writer import GGUFWriter
from prima_tpu_torch.models import llama
from prima_tpu_torch.models.config import ModelConfig
from prima_tpu_torch.models.llama import ForwardOptions, load_params
from prima_tpu_torch.runtime.engine import Engine, SlotState
from prima_tpu_torch.utils import perf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_PATH = os.path.join(ROOT, "benchmark", "tests", "data", "tiny-deepseek2.json")
SEED = 2 ** 33 + 5
N_SLOTS = 12  # 36 pairs a decode step at top-3: the chunked indexed route
T = 48  # cache cells a slot
# f32 program against the f32 reference: the same arithmetic in another
# order (the absorbed form's products, the GEMV's sums), of max |logit|
TOL = 1e-4
# bf16 weights, activations and latent cache: every GEMV output, the latent
# and the absorbed query are rounded to bf16 (2^-9 relative) and the error
# grows through three layers and the head; 2e-2 of max |logit| is the bf16
# tolerance of the family runtime's test (test_torch_deepseek2.py), and a
# dropped shared expert or a renormalised router moves the logits by more
BF16_TOL = 2e-2


def _cfg() -> dict:
    with open(CFG_PATH) as f:
        cfg = json.load(f)
    cfg["model"]["arch_dir"] = os.path.join(ROOT, "benchmark", "archs")
    return cfg


def write_gguf(cfg: dict, seed: int, path: str) -> str:
    """The configuration's GGUF, its blocks made from the seed, as a file."""
    m = synth_gguf(cfg, seed, "cpu")
    w = GGUFWriter(path)
    for key, value in m.metadata.items():
        w.add_kv(key, value.tolist() if isinstance(value, np.ndarray) else value)
    for name in m.tensors:
        ti = m.tensors[name]
        if ti.ggml_type == GGMLType.F32:
            w.add_tensor(name, np.ascontiguousarray(ti.data, np.float32))
        else:
            w.add_tensor(name, ti.data, ne=ti.ne, ggml_type=ti.ggml_type)
    w.write()
    return path


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return write_gguf(_cfg(), SEED, str(tmp_path_factory.mktemp("ds2") / "tiny-ds2.gguf"))


def _model(path: str, dtype) -> tuple:
    m = GGUFModel.open(path)
    cfg = ModelConfig.from_gguf(m)
    params = load_params(m, cfg, "cpu", dtype=dtype)
    m.close()
    return cfg, params


def _prompts(n: int, seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 512, int(rng.integers(4, 20))).tolist() for _ in range(n)]


def _serve(cfg, params, dtype, prompts, n_out: int = 6, **kw) -> tuple:
    """Greedy decode of one prompt a slot through step_fused (the worker's
    path), prefill chunks of 8: (each slot's served sequence, the logits of
    every decode step's rows with their cells)."""
    eng = Engine(cfg, params, n_slots=len(prompts), max_seq=T, n_batch=8,
                 opts=ForwardOptions(dtype=dtype), kv_dtype=dtype, device="cpu", **kw)
    for p in prompts:
        eng.submit(p, n_predict=n_out)
    seen = []

    def recorded(fwd):
        def record(params_, caches, tokens, cache_pos, rope_pos):
            logits, out = fwd(params_, caches, tokens, cache_pos, rope_pos)
            seen.append((tokens[:, 0].clone(), cache_pos.clone(), logits.float().clone()))
            return logits, out
        return record

    # the fused chunks, and step()'s decode while a slot still prefills
    eng._fused_gen.fwd = recorded(eng._fused_gen.fwd)
    eng._decode_raw = recorded(eng._decode_raw)
    while any(s.state != SlotState.IDLE for s in eng.slots):
        eng.step_fused(max_chunk=4)
    seqs = [s.prompt + s.generated for s in eng.slots]
    return eng, seqs, seen


def _reference(seqs: list, cfg: dict | None = None) -> list:
    ref = Reference(cfg or _cfg(), SEED, "cpu")
    return ref.logits([s[:-1] for s in seqs], [0] * len(seqs))


def _gap(seqs, seen, want) -> float:
    """The widest difference, over every live row of every decode step,
    between the served logits and the reference's at that cell, over the
    reference's max |logit|."""
    worst, n = 0.0, 0
    top = max(float(w.abs().max()) for w in want)
    for toks, pos, logits in seen:
        for s, seq in enumerate(seqs):
            p = int(pos[s])
            if p < len(seq) - 1 and int(toks[s]) == seq[p]:
                worst = max(worst, float((logits[s] - want[s][p]).abs().max()))
                n += 1
    assert n >= 4 * len(seqs)
    return worst / top


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_served_logits_match_reference(gguf, dtype, tol):
    """Prefill in chunks, then decode through the latent cache on 12 slots,
    against the reference's full forward over each served sequence."""
    cfg, params = _model(gguf, dtype)
    assert cfg.kv_lora_rank == 64 and cfg.n_dense_lead == 1 and cfg.rope_scaling.kind == "yarn"
    _, seqs, seen = _serve(cfg, params, dtype, _prompts(N_SLOTS))
    assert _gap(seqs, seen, _reference(seqs)) <= tol


def test_reference_matches_jax_forward(gguf):
    """The plain reference against the JAX package's deepseek2_forward (its
    own loader and dequantizers) on the same file, f32."""
    import jax.numpy as jnp
    import prima_tpu.models.deepseek2 as jds
    from prima_tpu.gguf.reader import GGUFModel as JGGUFModel

    m = JGGUFModel.open(gguf)
    jcfg = jds.DeepseekV2Config.from_gguf(m)
    jparams = jds.load_deepseek2_params(m, jcfg, jnp.float32)
    m.close()
    assert jcfg.rope_scaling == "yarn" and jcfg.n_expert_shared == 1
    seqs = _prompts(2, seed=3)
    n = min(len(s) for s in seqs)
    toks = np.asarray([s[:n] for s in seqs], np.int32)
    want = np.asarray(jds.deepseek2_forward(jparams, jcfg, toks))
    got = torch.stack(Reference(_cfg(), SEED, "cpu").logits([s[:n] for s in seqs],
                                                            [0, 0])).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_chunked_indexed_route_equals_the_dense_loop(gguf):
    """36 pairs at one token a row take the indexed GEMV in chunks of 32
    (6 launches); the same rows as one prefill chunk take the all-expert
    loop; the counters tell them apart."""
    cfg, params = _model(gguf, torch.float32)
    layer = params["layers"][1]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((N_SLOTS, 256))
                         .astype(np.float32))
    opts = ForwardOptions(dtype=torch.float32)
    was = perf.enable(True)
    try:
        with perf.recording() as rec:
            dec = llama.moe_ffn(layer, cfg, x[:, None], opts)[:, 0]
            pre = llama.moe_ffn(layer, cfg, x[None], opts)[0]
    finally:
        perf.enable(was)
    # the same products; the matmuls sum in another order for another
    # number of rows
    assert (dec - pre).abs().max() <= 1e-6 * pre.abs().max()
    assert dict(rec.counts) == {"moe.calls": 2, "moe.pairs": 2 * 3 * N_SLOTS,
                                "moe.indexed_launches": 6, "moe.dense_loops": 1}
    spans = [s for s in rec.spans if s.name == "moe.experts"]
    assert [s.attrs for s in spans] == [{"pairs": 36, "launches": 6},
                                        {"pairs": 36, "launches": 0}]


def test_context_shift_matches_recompute(gguf):
    """A slot that fills its 48 cells shifts: the kept cells' latents move
    as they are and their RoPE keys are rotated to their new positions, so
    the first layer's cache (which sees no earlier layer) equals that of a
    fresh prefill of the kept tokens."""
    cfg, params = _model(gguf, torch.float32)
    prompt = np.random.default_rng(11).integers(3, 512, T - 4).tolist()
    eng, seqs, _ = _serve(cfg, params, torch.float32, [prompt], n_out=10, ctx_shift=True,
                          n_keep=4)
    slot = eng.slots[0]
    assert slot.shifts and len(slot.generated) == 10
    n_keep, n_discard = slot.shifts[0]
    kept = (slot.prompt + slot.generated)[:n_keep] + (slot.prompt + slot.generated)[
        n_keep + n_discard:]
    used = eng.kv.used(0)
    fresh = Engine(cfg, params, n_slots=1, max_seq=T, n_batch=8,
                   opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                   device="cpu")
    fresh._prefill(np.asarray(kept[:used], np.int64), 0, 0, 0)
    for got, want in zip(eng.kv.caches[0], fresh.kv.caches[0]):
        assert (got[0, :used] - want[0, :used]).abs().max() <= 1e-5 * want[0, :used].abs().max()


FAULTS = {
    "no_shared_expert": lambda cfg, p: (cfg, {**p, "layers": [
        {k: v for k, v in layer.items() if "shexp" not in k} for layer in p["layers"]]}),
    "renormalised": lambda cfg, p: (replace(cfg, moe_norm_w=True), p),
    "mscale_dropped": lambda cfg, p: (replace(cfg, yarn_log_mul=0.0), p),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails(gguf, fault):
    """A program without the shared expert, with renormalised top-k weights
    or without YaRN's attention magnitude is held outside the f32
    tolerance (by 3e-2 to 0.3 of max |logit|: the bf16 tolerance's order)."""
    cfg, params = _model(gguf, torch.float32)
    cfg, params = FAULTS[fault](cfg, params)
    _, seqs, seen = _serve(cfg, params, torch.float32, _prompts(4))
    assert _gap(seqs, seen, _reference(seqs)) > 10 * TOL


def test_worker_serves_the_engine_tokens(gguf):
    """EngineWorker, as the server and the benchmark drive it, serves the
    greedy tokens of the engine driven directly."""
    from prima_tpu_torch.sampling import Sampler, SamplerParams
    from prima_tpu_torch.server.scheduler import EngineWorker, GenerationRequest
    from prima_tpu_torch.tokenizer import Tokenizer

    cfg, params = _model(gguf, torch.float32)
    prompts = _prompts(N_SLOTS, seed=13)
    _, seqs, _ = _serve(cfg, params, torch.float32, prompts)
    eng = Engine(cfg, params, n_slots=N_SLOTS, max_seq=T, n_batch=8,
                 opts=ForwardOptions(dtype=torch.float32), kv_dtype=torch.float32,
                 device="cpu")
    m = GGUFModel.open(gguf)
    worker = EngineWorker(eng, Tokenizer.from_gguf(m))
    m.close()
    reqs = [GenerationRequest(prompt_tokens=p, sampler=Sampler(SamplerParams(temp=0.0)),
                              n_predict=6) for p in prompts]
    for r in reqs:
        worker.submit(r)
    worker.start()
    try:
        for r in reqs:
            while r.events.get(timeout=60).done is False:
                pass
    finally:
        worker.shutdown()
    assert [p + r.tokens_out for p, r in zip(prompts, reqs)] == seqs


def test_what_the_latent_cache_does_not_take(gguf, tmp_path):
    """A quantized cache, a slot file and a draft model are refused with
    their reason; every GEMV weight is its own QTensor under its GGUF
    name; the latent cache is one buffer a layer."""
    from prima_tpu_torch.quant.qtensor import QTensor
    from prima_tpu_torch.runtime.speculative import SpeculativeDecoder
    from prima_tpu_torch.runtime.state import slot_restore, slot_save

    cfg, params = _model(gguf, torch.float32)
    for i, layer in enumerate(params["layers"]):
        names = ["attn_q", "attn_kv_a_mqa", "attn_kv_b", "attn_output"] + (
            ["w_gate", "w_up", "w_down"] if i == 0 else
            [f"ffn_{n}_{s}" for n in ("gate", "up", "down") for s in ("exps", "shexp")])
        assert all(isinstance(layer[n], QTensor) for n in names)
        assert layer["mla_k_b"].shape == (4, 32, 64) and layer["mla_v_b"].shape == (4, 32, 64)
    for kind in ("q8_0", "q4_0"):
        with pytest.raises(NotImplementedError, match="latent attention"):
            Engine(cfg, params, n_slots=1, max_seq=T, kv_dtype=kind, device="cpu")
    eng = Engine(cfg, params, n_slots=2, max_seq=T, device="cpu")
    pe, lat = eng.kv.caches[0]
    assert pe.shape == (2, T, 1, 16) and lat.shape == (2, T, 1, 64)
    assert pe._base is lat._base and pe._base.shape == (2, T, 80)
    with pytest.raises(NotImplementedError, match="slot save / restore"):
        slot_save(eng, 0, str(tmp_path / "s.npz"))
    with pytest.raises(NotImplementedError, match="slot save / restore"):
        slot_restore(eng, 0, str(tmp_path / "s.npz"))
    with pytest.raises(NotImplementedError, match="speculative"):
        SpeculativeDecoder(eng, eng)


def test_spans_of_a_decode_step(gguf):
    """fwd.attn of every layer carries kind "mla"; a decode step's MoE
    layers each open moe.experts with their pairs and launches."""
    cfg, params = _model(gguf, torch.float32)
    was = perf.enable(True)
    try:
        with perf.recording() as rec:
            _serve(cfg, params, torch.float32, _prompts(N_SLOTS), n_out=2)
    finally:
        perf.enable(was)
    attn = [s for s in rec.spans if s.name == "fwd.attn"]
    assert attn and all(s.attrs.get("kind") == "mla" for s in attn)
    experts = [s for s in rec.spans if s.name == "moe.experts"]
    assert all(s.parent is not None and s.parent.name == "fwd.moe" for s in experts)
    # a decode step runs every slot's row: 36 pairs, 2 chunks of 3 launches;
    # a prefill chunk of one row also has one token a row
    decode = [s for s in experts if s.attrs == {"pairs": 3 * N_SLOTS, "launches": 6}]
    one_row = [s for s in experts if s.attrs == {"pairs": 3, "launches": 3}]
    assert len(decode) >= 2 * (cfg.n_layers - 1) and one_row
    assert len(experts) == rec.counts["moe.calls"]
    # the all-expert loop is left to prefill chunks of MAX_B pairs or more
    loops = [s for s in experts if s.attrs["launches"] == 0]
    assert len(loops) == rec.counts.get("moe.dense_loops", 0)
    assert all(s.attrs["pairs"] >= llama.MAX_B for s in loops)


@pytest.mark.cuda
def test_graph_replay_equals_the_eager_forward(tmp_path):
    """On the card, bf16: each graphed decode step's logits equal, bit for
    bit, the eager forward's from a copy of the same caches, and the
    served tokens equal an eager engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    path = write_gguf(_cfg(), SEED, str(tmp_path / "tiny-ds2.gguf"))
    m = GGUFModel.open(path)
    cfg = ModelConfig.from_gguf(m)
    params = load_params(m, cfg, dev, dtype=torch.bfloat16)
    m.close()
    opts = ForwardOptions(dtype=torch.bfloat16)

    def serve(graphed: bool):
        eng = Engine(cfg, params, n_slots=N_SLOTS, max_seq=T, n_batch=8, opts=opts,
                     kv_dtype=torch.bfloat16, device=dev)
        seen = []
        if graphed:
            graph = eng._decode_graph

            def call(params_, cfg_, tokens, positions, caches, cache_pos, opts_, **kw):
                twin = [tuple(c.clone() for c in kv) for kv in caches]
                want, _ = llama.forward(params_, cfg_, tokens, positions, twin, cache_pos,
                                        opts_, **kw)
                got, out = graph(params_, cfg_, tokens, positions, caches, cache_pos, opts_,
                                 **kw)
                seen.append((got.clone(), want))
                return got, out

            eng._decode_graph = call
        else:
            eng._decode_graph = llama.forward
        for p in _prompts(N_SLOTS):
            eng.submit(p, n_predict=12)
        while any(s.state != SlotState.IDLE for s in eng.slots):
            eng.step_fused(max_chunk=4)
        return [s.generated for s in eng.slots], seen

    was = perf.enable(True)
    try:
        with perf.recording() as rec:
            toks, seen = serve(True)
    finally:
        perf.enable(was)
    torch.cuda.synchronize()
    assert rec.counts["decode.graph_captures"] == 1 and rec.counts["decode.graph_steps"] >= 8
    assert all(torch.equal(got, want) for got, want in seen)
    assert toks == serve(False)[0]
