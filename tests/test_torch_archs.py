"""The port's decoder against the JAX package's on the RMSNorm arch families:
tiny GGUFs written with the JAX package's GGUFWriter (f32, or Q8_0 / Q4_K
blocks from its quantizer), each loaded by both packages' own load_params
and run in f32 through their forward: the prefill logits within 1e-4 *
max |logit| (2e-4 for mixture-of-experts archs), and 16 greedy decode steps
on 2 rows identical. The LayerNorm families are in test_torch_archs_ln.py
and the mixture-of-experts archs in test_torch_moe.py, which reuse the
writer and the runner below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.gguf.constants import GGMLType
from prima_tpu.gguf.reader import GGUFModel as JGGUFModel
from prima_tpu.gguf.writer import GGUFWriter
from prima_tpu.models.config import ModelConfig as JModelConfig
from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import forward as jforward
from prima_tpu.models.llama import init_kv_caches as jinit_kv
from prima_tpu.models.llama import load_params as jload_params
from prima_tpu.quant.quantize_np import quantize
from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.models.config import ModelConfig, RopeType
from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches, load_params

F32, Q8_0, Q4_K = GGMLType.F32, GGMLType.Q8_0, GGMLType.Q4_K
JOPTS = JOpts(matmul_impl="xla", dtype=jnp.float32)
OPTS = ForwardOptions(dtype=torch.float32)
T = 64  # cache cells: a prefill of 10 and 16 decode steps
TOL = 1e-4
MOE_TOL = 2e-4

# the GGUF tensor table of each arch's tiny model (see write_model)
ARCHS = {
    "gemma2": dict(post_norms=("post_attention_norm", "post_ffw_norm"), tied=True,
                   kv={"attn_logit_softcapping": 0.5, "final_logit_softcapping": 1.0,
                       "attention.sliding_window": 4}),
    "phi3": dict(fused_qkv=True, ffn="gate_up_fused"),
    "chatglm": dict(fused_qkv=True, qkv_bias=True, ffn="split", rope_dim=8),
    "chameleon": dict(qk_norm="head_ln"),
    "chameleon-swin": dict(arch="chameleon", qk_norm="head_ln", kv={"swin_norm": True}),
    "openelm": dict(fused_qkv=True, qk_norm="head_rms", tied=True,
                    heads=(2, 3, 4), kv_heads=(1, 1, 2), ffs=(48, 64, 96)),
    "bitnet": dict(bitnet=True, tied=True),
    "minicpm": dict(),
    # LayerNorm families (test_torch_archs_ln.py)
    "phi2": dict(ln_bias=True, fused_qkv=True, qkv_bias=True, bo=True, ffn="plain",
                 ffn_bias=True, no_ffn_norm=True, output_bias=True, rope_dim=8),
    "command-r": dict(ffn="gated", no_ffn_norm=True, kv={"logit_scale": 0.5}),
    "starcoder2": dict(ln_bias=True, qkv_bias=True, bo=True, ffn="plain", ffn_bias=True),
    "bloom": dict(ln_bias=True, fused_qkv=True, qkv_bias=True, bo=True, ffn="plain",
                  ffn_bias=True, tok_embd_norm=True),
    "mpt": dict(fused_qkv=True, ffn="plain",
                kv={"attention.max_alibi_bias": 8.0, "attention.clamp_kqv": 0.3}),
    "gpt2": dict(ln_bias=True, fused_qkv=True, qkv_bias=True, bo=True, ffn="plain",
                 ffn_bias=True, pos_embd=True),
    # mixture of experts (test_torch_moe.py)
    "mixtral": dict(arch="llama", moe=(4, 2)),
    "qwen2moe": dict(moe=(4, 2), qkv_bias=True, shexp=True),
    "grok": dict(moe=(4, 2), post_norms=("attn_out_norm", "layer_out_norm")),
    "arctic": dict(moe=(4, 2), arctic=True),
    # top-4 of 8: the reference sums a wide input's experts in id order
    "mixtral-top4": dict(arch="llama", moe=(8, 4)),
    "olmoe": dict(moe=(8, 4), qk_norm="full"),
    "dbrx": dict(moe=(8, 4), fused_qkv=True, no_ffn_norm=True, attn_out_norm=True,
                 kv={"attention.clamp_kqv": 0.3}),
}


def write_model(path, name: str, ftype=F32, n_embd: int = 64, n_heads: int = 4,
                n_kv: int = 2, n_ff: int = 96, n_layers: int = 2, n_vocab: int = 128,
                seed: int = 0) -> str:
    """Write the tiny GGUF of ARCHS[name] and return its path. Weight
    matrices whose rows are whole blocks of `ftype` are stored in it; norms,
    biases, scales, routers and position tables stay f32."""
    spec = ARCHS[name]
    arch = spec.get("arch", name)
    rng = np.random.default_rng(seed)
    hd = n_embd // n_heads
    heads = spec.get("heads", (n_heads,) * n_layers)
    kv_heads = spec.get("kv_heads", (n_kv,) * n_layers)
    ffs = spec.get("ffs", (n_ff,) * n_layers)
    n_layers = len(heads)
    w = GGUFWriter(str(path), arch=arch)
    per_layer = "heads" in spec
    for key, val in {"block_count": n_layers, "embedding_length": n_embd,
                     "attention.head_count": list(heads) if per_layer else n_heads,
                     "attention.head_count_kv": list(kv_heads) if per_layer else n_kv,
                     "feed_forward_length": list(ffs) if per_layer else n_ff,
                     "attention.key_length": hd, "attention.value_length": hd,
                     "context_length": 512, "attention.layer_norm_rms_epsilon": 1e-5,
                     "attention.layer_norm_epsilon": 1e-5, "rope.freq_base": 10000.0,
                     "rope.dimension_count": spec.get("rope_dim", hd),
                     **spec.get("kv", {})}.items():
        w.add_kv(f"{arch}.{key}", val)
    if "moe" in spec:
        w.add_kv(f"{arch}.expert_count", spec["moe"][0])
        w.add_kv(f"{arch}.expert_used_count", spec["moe"][1])
    w.add_kv("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(n_vocab)])

    block = {F32: 1, Q8_0: 32, Q4_K: 256}[ftype]

    def mat(name, rows, cols, scale=0.05, dense=False):
        x = (rng.standard_normal((rows, cols)) * scale).astype(np.float32)
        if dense or ftype == F32 or cols % block:
            w.add_tensor(name, x)
        else:
            w.add_tensor(name, quantize(x, ftype), ne=(cols, rows), ggml_type=ftype)

    def vec(name, n, around=1.0):
        w.add_tensor(name, (around + rng.standard_normal(n) * 0.05).astype(np.float32))

    def norm(name, n, bias):
        vec(name + ".weight", n)
        if bias:
            vec(name + ".bias", n, around=0.0)

    ln_bias = spec.get("ln_bias", False)
    mat("token_embd.weight", n_vocab, n_embd)
    if spec.get("pos_embd"):
        mat("position_embd.weight", 512, n_embd, dense=True)
    if spec.get("tok_embd_norm"):
        norm("token_embd_norm", n_embd, True)
    for i in range(n_layers):
        p = f"blk.{i}."
        h, kvh, nf = heads[i], kv_heads[i], ffs[i]
        nq, nk = h * hd, kvh * hd
        norm(p + "attn_norm", n_embd, ln_bias)
        if spec.get("fused_qkv"):
            mat(p + "attn_qkv.weight", nq + 2 * nk, n_embd)
            if spec.get("qkv_bias"):
                vec(p + "attn_qkv.bias", nq + 2 * nk, around=0.0)
        else:
            for t, n in (("q", nq), ("k", nk), ("v", nk)):
                mat(p + f"attn_{t}.weight", n, n_embd)
                if spec.get("qkv_bias"):
                    vec(p + f"attn_{t}.bias", n, around=0.0)
                if spec.get("bitnet"):
                    vec(p + f"attn_{t}.scale", 1, around=1.1)
        if spec.get("qk_norm") == "full":  # olmoe: RMS over the whole q / k vectors
            norm(p + "attn_q_norm", nq, False)
            norm(p + "attn_k_norm", nk, False)
        elif spec.get("qk_norm"):
            norm(p + "attn_q_norm", hd, spec["qk_norm"] == "head_ln")
            norm(p + "attn_k_norm", hd, spec["qk_norm"] == "head_ln")
        mat(p + "attn_output.weight", n_embd, nq)
        if spec.get("bo"):
            vec(p + "attn_output.bias", n_embd, around=0.0)
        if spec.get("bitnet"):
            vec(p + "attn_sub_norm.weight", nq)
            vec(p + "attn_output.scale", 1, around=0.9)
        if not spec.get("no_ffn_norm"):
            norm(p + "ffn_norm", n_embd, ln_bias)
        if spec.get("attn_out_norm"):  # dbrx: the norm before the experts
            vec(p + "attn_out_norm.weight", n_embd)
        if "moe" in spec:
            n_exp = spec["moe"][0]
            mat(p + "ffn_gate_inp.weight", n_exp, n_embd, scale=0.5, dense=True)
            mat(p + "ffn_gate_exps.weight", n_exp * nf, n_embd)
            mat(p + "ffn_up_exps.weight", n_exp * nf, n_embd)
            mat(p + "ffn_down_exps.weight", n_exp * n_embd, nf)
            if spec.get("shexp"):
                mat(p + "ffn_gate_inp_shexp.weight", 1, n_embd, dense=True)
                mat(p + "ffn_gate_shexp.weight", nf, n_embd)
                mat(p + "ffn_up_shexp.weight", nf, n_embd)
                mat(p + "ffn_down_shexp.weight", n_embd, nf)
        ffn = spec.get("ffn", "gated" if ("moe" not in spec or spec.get("arctic")) else None)
        if ffn == "gated":
            mat(p + "ffn_gate.weight", nf, n_embd)
            mat(p + "ffn_up.weight", nf, n_embd)
        elif ffn in ("gate_up_fused", "split"):
            mat(p + "ffn_up.weight", 2 * nf, n_embd)
        elif ffn == "plain":
            mat(p + "ffn_up.weight", nf, n_embd)
        if ffn is not None:
            mat(p + "ffn_down.weight", n_embd, nf)
        if spec.get("ffn_bias"):
            vec(p + "ffn_up.bias", nf, around=0.0)
            vec(p + "ffn_down.bias", n_embd, around=0.0)
        if spec.get("bitnet"):
            vec(p + "ffn_sub_norm.weight", nf)
            for t, a in (("gate", 1.3), ("up", 0.7), ("down", 1.2)):
                vec(p + f"ffn_{t}.scale", 1, around=a)
        if spec.get("arctic"):
            vec(p + "ffn_norm_exps.weight", n_embd)
        for pn in spec.get("post_norms", ()):
            vec(p + pn + ".weight", n_embd)
    norm("output_norm", n_embd, ln_bias)
    if not spec.get("tied"):
        mat("output.weight", n_vocab, n_embd)
    if spec.get("output_bias"):
        vec("output.bias", n_vocab, around=0.0)
    w.write()
    return str(path)


def run_both(path: str, b: int = 2, s: int = 10, steps: int = 16, seed: int = 1) -> dict:
    """Load the GGUF with both packages and run the same prompt through
    both forwards in f32: a prefill of s tokens on b rows, then `steps`
    greedy decode steps, each package following its own tokens. Returns
    the logits of every call and both token streams."""
    jm = JGGUFModel.open(path)
    jcfg = JModelConfig.from_gguf(jm)
    jparams = jload_params(jm, jcfg, dtype=jnp.float32)
    pm = GGUFModel.open(path)
    cfg = ModelConfig.from_gguf(pm)
    params = load_params(pm, cfg, "cpu", dtype=torch.float32)
    jfwd = jax.jit(lambda p, t, pos, kv, cp: jforward(p, jcfg, t, pos, kv, cp, JOPTS))
    toks = np.random.default_rng(seed).integers(0, cfg.n_vocab, (b, s)).astype(np.int32)
    jkv = jinit_kv(jcfg, b, T, jnp.float32)
    pkv = init_kv_caches(cfg, b, T, torch.float32, "cpu")
    jcur = pcur = toks
    out = {"cfg": cfg, "jax_logits": [], "port_logits": [], "jax": [], "port": []}
    pos0 = 0
    for _ in range(steps + 1):
        n = jcur.shape[1]
        pos = np.tile(np.arange(pos0, pos0 + n, dtype=np.int32), (b, 1))
        jl, jkv = jfwd(jparams, jcur, pos, jkv, np.full(b, pos0, np.int32))
        with torch.no_grad():
            pl, _ = forward(params, cfg, torch.from_numpy(pcur).long(), torch.from_numpy(pos),
                            pkv, torch.full((b,), pos0, dtype=torch.int32), OPTS)
        jl, pl = np.asarray(jl), pl.numpy()
        out["jax_logits"].append(jl)
        out["port_logits"].append(pl)
        jcur = jl[:, -1].argmax(-1).astype(np.int32)[:, None]
        pcur = pl[:, -1].argmax(-1).astype(np.int32)[:, None]
        out["jax"].append(jcur[:, 0].tolist())
        out["port"].append(pcur[:, 0].tolist())
        pos0 += n
    return out


def check_logits(run: dict, tol: float) -> None:
    want, got = run["jax_logits"][0], run["port_logits"][0]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


CASES = [("gemma2", F32), ("gemma2", Q4_K), ("phi3", Q8_0), ("chatglm", F32),
         ("chameleon", F32), ("chameleon-swin", F32), ("openelm", F32), ("bitnet", F32),
         ("minicpm", Q8_0)]


def _case_id(case) -> str:
    return f"{case[0]}-{case[1].name}"


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def run(request, tmp_path_factory):
    name, ftype = request.param
    wide = ftype == Q4_K  # Q4_K rows are whole blocks of 256
    path = write_model(tmp_path_factory.mktemp(name) / f"{name}.gguf", name, ftype,
                       n_embd=256 if wide else 64, n_ff=256 if wide else 96)
    return run_both(path)


def test_logits_match_jax(run):
    check_logits(run, TOL)


def test_greedy_tokens_match_jax(run):
    assert run["port"] == run["jax"]


def test_arch_flags_are_set(tmp_path):
    """The tiny models exercise the flags they are named for."""
    cfgs = {n: ModelConfig.from_gguf(GGUFModel.open(write_model(tmp_path / f"{n}.gguf", n)))
            for n, _ in CASES}
    g = cfgs["gemma2"]
    assert (g.attn_logit_softcap, g.final_logit_softcap, g.swa_window) == (0.5, 1.0, 4)
    assert g.post_norms and g.act == "gelu" and g.embd_scale == 8.0 and g.tie_embeddings
    assert cfgs["chatglm"].act == "swiglu_split" and cfgs["chatglm"].rope_dim == 8
    assert cfgs["chameleon"].qk_norm_head and not cfgs["chameleon"].swin_norm
    assert cfgs["chameleon-swin"].swin_norm
    assert cfgs["openelm"].n_kv_heads_arr == (1, 1, 2) and cfgs["openelm"].qk_norm_rms
    assert cfgs["openelm"].rope_type == RopeType.NEOX
    assert cfgs["bitnet"].sub_norms
    m = cfgs["minicpm"]
    assert m.embd_scale == 12.0 and m.residual_scale != 1.0 and m.logit_scale != 1.0


def test_openelm_caches_have_per_layer_heads(tmp_path):
    cfg = ModelConfig.from_gguf(GGUFModel.open(write_model(tmp_path / "o.gguf", "openelm")))
    kv = init_kv_caches(cfg, 2, 8, torch.float32, "cpu")
    assert [k.shape[2] for k, _ in kv] == [1, 1, 2]
    assert [k.shape[2] for k, _ in kv] == [c[0].shape[2] for c in jinit_kv(
        JModelConfig.from_gguf(JGGUFModel.open(str(tmp_path / "o.gguf"))), 2, 8, jnp.float32)]


def test_openelm_slot_file_crosses_packages(tmp_path):
    """A slot of a model with per-layer KV heads, saved by the port,
    restores in the port and in the JAX package: each layer's rows keep
    their own head count, and the file records them."""
    import json

    from prima_tpu.models.loader import load_model as jload_model
    from prima_tpu.runtime.engine import Engine as JEngine
    from prima_tpu.runtime.state import slot_restore as jslot_restore
    from prima_tpu_torch.models.loader import load_model
    from prima_tpu_torch.runtime.engine import Engine
    from prima_tpu_torch.runtime.state import slot_restore, slot_save

    path = write_model(tmp_path / "openelm.gguf", "openelm")
    m = load_model(path, device="cpu", dtype=torch.float32)
    eng = Engine(m.cfg, m.params, n_slots=2, max_seq=32, n_batch=16, opts=OPTS,
                 kv_dtype=torch.float32, device="cpu")
    eng.run_to_completion([5, 9, 13, 2, 7], n_predict=4)
    f = str(tmp_path / "slot.npz")
    n = slot_save(eng, 0, f)
    with np.load(f) as z:
        assert json.loads(str(z["meta"]))["n_kv_heads_arr"] == [1, 1, 2]
    assert slot_restore(eng, 1, f) == n
    for k, v in eng.kv.caches:
        assert torch.equal(k[1, :n], k[0, :n]) and torch.equal(v[1, :n], v[0, :n])
    jm = jload_model(path, dtype=jnp.float32)
    jeng = JEngine(jm.cfg, jm.params, n_slots=2, max_seq=32, n_batch=16, opts=JOPTS,
                   kv_dtype=jnp.float32, scan=False)
    assert jslot_restore(jeng, 1, f) == n
    for (jk, _), (k, _) in zip(jeng.kv.caches, eng.kv.caches):
        np.testing.assert_array_equal(np.asarray(jk)[1, :n], k[0, :n].numpy())
