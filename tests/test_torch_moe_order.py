"""The order in which the port sums a row's experts, and the MoE families
that pick more than two: the combine of `moe_ffn` bit for bit against the
JAX package's expression (top-k order for one row, ascending expert id for
more, prima_tpu/models/llama.py:1080-1094); a tiny Mixtral-style model,
olmoe (full-vector q/k RMS norms, raw top-k weights) and dbrx (LayerNorm,
clamped fused qkv, attn_out_norm before the experts) at top-4 of 8 against
the JAX package, decoded at 4 rows (16 pairs, the indexed branch); and the indexed GEMV's launch parameters, which depend
on the shapes alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.models import llama as L
from prima_tpu_torch.models.config import ModelConfig
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.quant import qmatmul as qm
from test_torch_archs import F32, MOE_TOL, Q8_0, check_logits, run_both, write_model

N_EXP, K_USED, WIDTH = 8, 4, 256
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


def _routing(rows: int, seed: int):
    """Every expert's output (rows, E, D) and a normalized top-4-of-8
    routing (weights f32, ids), as the router makes them."""
    rng = np.random.default_rng(seed)
    y_all = rng.standard_normal((rows, N_EXP, WIDTH)).astype(np.float32)
    logits = rng.standard_normal((rows, N_EXP)).astype(np.float32) * 2
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :K_USED]
    w = np.take_along_axis(probs, ids, -1)
    return y_all, (w / w.sum(-1, keepdims=True)).astype(np.float32), ids


def _jax_combine(y_all, w, ids, b: int, s: int, dtype):
    """prima_tpu/models/llama.py:1080-1094 on given expert outputs, op by
    op as the reference's expressions run: top-k order at b * s == 1, else
    every expert in id order under its summed weight (0 where not picked)."""
    e = y_all.shape[-1]
    y_all = jnp.asarray(y_all).astype(dtype).reshape(b, s, N_EXP, e)
    w, ids = jnp.asarray(w).reshape(b, s, K_USED), jnp.asarray(ids).reshape(b, s, K_USED)
    out = jnp.zeros((b, s, e), dtype)
    if b * s == 1:
        idv, wv = ids.reshape(-1), w.reshape(-1)
        for j in range(K_USED):
            out = out + wv[j].astype(dtype) * y_all[0, 0, idv[j]]
        return np.asarray(out.astype(jnp.float32)).reshape(1, e)
    weight_per_expert = jnp.sum(
        jnp.where(ids[..., None, :] == jnp.arange(N_EXP)[None, None, :, None],
                  w[..., None, :], 0.0), axis=-1)
    for eidx in range(N_EXP):
        out = out + weight_per_expert[..., eidx:eidx + 1].astype(dtype) * y_all[:, :, eidx]
    return np.asarray(out.astype(jnp.float32)).reshape(b * s, e)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("b,s", [(1, 1), (4, 1), (2, 3)], ids=["rows1", "rows4", "rows6"])
def test_combine_is_the_reference_bit_for_bit(b, s, dtype):
    tdt, jdt = DTYPES[dtype]
    rows = b * s
    y_all, w, ids = _routing(rows, seed=rows)
    want = _jax_combine(y_all, w, ids, b, s, jdt)
    y = torch.from_numpy(np.take_along_axis(y_all, ids[..., None], 1)).to(tdt)  # (R, k, D)
    wt, idt = torch.from_numpy(w), torch.from_numpy(ids)
    got = L.moe_combine(y, wt, idt, tdt)
    assert got.dtype == tdt and got.shape == (rows, WIDTH)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == "bf16" and rows > 1:
        # top-k order, which the reference keeps for one row only, rounds
        # otherwise: the test sees the order
        topk = torch.zeros((rows, WIDTH), dtype=tdt)
        for j in range(K_USED):
            topk = topk + wt[:, j:j + 1].to(tdt) * y[:, j]
        assert not np.array_equal(topk.float().numpy(), want)


def test_indexed_branch_bounds_pairs_by_rows(tmp_path, monkeypatch):
    """moe_ffn hands the indexed GEMV its row count as the most pairs one
    expert can hold (a row's k experts are distinct)."""
    model = load_model(write_model(tmp_path / "m.gguf", "mixtral-top4", Q8_0), device="cpu",
                       dtype=torch.float32)
    seen = []
    real = qm.qgemv_indexed_plain
    monkeypatch.setattr(L, "qgemv_indexed_plain",
                        lambda x, w, ids, n, per_expert=None:
                        seen.append((x.shape[0], per_expert)) or real(x, w, ids, n, per_expert))
    kv = L.init_kv_caches(model.cfg, 3, 16, torch.float32, "cpu")
    toks = torch.randint(0, model.cfg.n_vocab, (3, 1), generator=torch.Generator().manual_seed(0))
    L.forward(model.params, model.cfg, toks, torch.zeros(3, 1, dtype=torch.long), kv,
              torch.zeros(3, dtype=torch.int32),
              L.ForwardOptions(dtype=torch.float32, matmul_impl="plain"))
    assert seen == [(12, 3)] * 3 * model.cfg.n_layers


@pytest.mark.parametrize("layout,row_bytes", [("nib4", 2048), ("nib4", 7168), ("int8", 4352),
                                              ("int8", 15232), ("nib4", 128)])
@pytest.mark.parametrize("p,per_expert,n_exp", [(1, 1, 8), (2, 1, 8), (8, 4, 8), (8, 8, 8),
                                                (16, 4, 60), (30, 15, 8), (31, 31, 4),
                                                (32, 32, 64)])
def test_indexed_launch_depends_on_shapes_and_fits_staging(layout, row_bytes, p, per_expert,
                                                           n_exp):
    for n in (48, 1408, 4096, 14336):
        got = qm.indexed_launch(n, row_bytes, p, n_exp, per_expert, layout)
        assert got == qm.indexed_launch(n, row_bytes, p, n_exp, per_expert, layout)
        slots, cols, passes, ksplit, ksb = got
        assert slots == min(n_exp, p)
        assert cols in ((4,) if layout == "nib4" else (1, 2)) and cols * passes >= per_expert
        assert passes == 1 or cols * (passes - 1) < per_expert
        # x staged for `cols` rows (nib4 both nibble halves of 4 or 8 rows) fits 32 KB
        halves, nb = (2, 4) if layout == "nib4" else (1, cols)
        assert halves * nb * ksb <= qm.X_STAGE_FLOATS
        assert ksb % qm.STAGE_BYTES == 0 and ksb <= qm.MAX_SLICE_BYTES
        assert ksplit == -(-row_bytes // ksb)
    # the engine's 4-slot decode on the tensor cores: one pass of 4 columns
    if layout == "nib4" and per_expert <= 4:
        assert (cols, passes) == (4, 1)


def test_indexed_launch_at_mixtral_shapes():
    """Gate/up (K = 4096) and down (K = 14336) of Mixtral-8x7B Q4_K at the
    engine's 4-slot decode: 8 slots, 4 columns, one pass, 2 and 7 K slices;
    8 rows take two passes of 4; Q6_K down passes of 2."""
    assert qm.indexed_launch(14336, 2048, 8, 8, 4, "nib4") == (8, 4, 1, 2, 1024)
    assert qm.indexed_launch(4096, 7168, 8, 8, 4, "nib4") == (8, 4, 1, 7, 1024)
    assert qm.indexed_launch(4096, 7168, 16, 8, 8, "nib4")[:3] == (8, 4, 2)
    assert qm.indexed_launch(4096, 14336, 8, 8, 4, "int8")[:3] == (8, 2, 2)
    with pytest.raises(ValueError):
        qm.indexed_launch(4096, 7168, 8, 8, 9, "nib4")  # more pairs an expert than pairs


def test_indexed_plain_takes_per_expert():
    from prima_tpu.gguf.constants import GGMLType
    from test_torch_moe_paths import _stacked

    qt = _stacked(GGMLType.Q8_0, 4, 48, 64)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((6, 64)).astype(np.float32))
    ids = torch.tensor([3, 1, 1, 0, 3, 3], dtype=torch.int32)
    want = qm.qgemv_indexed_plain(x, qt, ids, 48)
    for per_expert in (None, 3, 6):
        torch.testing.assert_close(qm.qgemv_indexed(x, qt, ids, 48, per_expert=per_expert),
                                   want, rtol=0, atol=0)


@pytest.fixture(scope="module", params=["mixtral-top4", "olmoe", "dbrx"])
def run(request, tmp_path_factory):
    name = request.param
    return run_both(write_model(tmp_path_factory.mktemp(name) / f"{name}.gguf", name, F32),
                    b=4)


def test_top4_family_logits_match_jax(run):
    check_logits(run, MOE_TOL)
    for got, want in zip(run["port_logits"][1:], run["jax_logits"][1:]):
        assert np.abs(got - want).max() <= MOE_TOL * np.abs(want).max()


def test_top4_family_greedy_tokens_match_jax(run):
    assert run["port"] == run["jax"]


def test_top4_family_flags_are_set(tmp_path):
    cfgs = {n: ModelConfig.from_gguf(GGUFModel.open(write_model(tmp_path / f"{n}.gguf", n)))
            for n in ("olmoe", "dbrx", "mixtral-top4")}
    assert all((c.n_expert, c.n_expert_used) == (8, 4) for c in cfgs.values())
    assert not cfgs["olmoe"].moe_norm_w and not cfgs["olmoe"].qk_norm_head
    assert cfgs["dbrx"].moe_norm_w and cfgs["dbrx"].norm_type == "ln"
    assert cfgs["dbrx"].clamp_kqv == pytest.approx(0.3)
    layers = {n: load_model(str(tmp_path / f"{n}.gguf"), device="cpu",
                            dtype=torch.float32).params["layers"][0] for n in ("olmoe", "dbrx")}
    # olmoe: one norm over the whole q vector (4 heads of 16) and k vector (2 heads)
    assert layers["olmoe"]["attn_q_norm"].shape == (64,)
    assert layers["olmoe"]["attn_k_norm"].shape == (32,)
    assert layers["dbrx"]["ffn_norm"] is not None  # read from attn_out_norm
