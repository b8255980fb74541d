"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips without one. The machine with
the card has no JAX, so run this file without the suite's conftest (which
configures JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from prima_tpu_torch.gguf.constants import GGMLType
from prima_tpu_torch.models.llama import synth_qtensor_device
from prima_tpu_torch.ops import attention as attn
from prima_tpu_torch.ops import kv_write as kvw
from prima_tpu_torch.ops import kvquant as kvq
from prima_tpu_torch.quant import qmatmul as qm
from prima_tpu_torch.quant.device_format import SUPPORTED_TYPES, to_device_format
from prima_tpu_torch.quant.qtensor import QTensor
from prima_tpu_torch.utils import hbm_probe

pytestmark = pytest.mark.cuda

# (format, K, scale layout the port picks)
FORMATS = [(GGMLType.Q4_K, 512, "packed"), (GGMLType.Q4_K, 256, "grouped"),
           (GGMLType.Q6_K, 512, "grouped"), (GGMLType.Q8_0, 512, "flat"),
           (GGMLType.Q4_0, 512, "flat"), (GGMLType.Q5_K, 512, "packed")]
GEMV_TOL = 1e-4  # max |kernel - plain| / max |plain| in f32: sums in another order
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _weights(dev, t, n, k, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return synth_qtensor_device(gen, n, k, t, dev)


@pytest.mark.parametrize("n", [48, 259])  # 259: a ragged row count (tiny-pair head)
@pytest.mark.parametrize("b", [1, 4, 31])
@pytest.mark.parametrize("t,k,mode", FORMATS, ids=lambda v: getattr(v, "name", str(v)))
def test_qgemv_matches_plain(dev, t, k, mode, b, n):
    qt = _weights(dev, t, n, k)
    assert qm.scale_mode(qt) == mode
    x = torch.randn(b, k, device=dev)
    before = qm.launches.count
    y = qm.qgemv(x, qt)
    ref = qm.qmatmul_plain(x, qt)
    torch.cuda.synchronize()
    assert qm.launches.count == before + 1
    assert (y - ref).abs().max().item() <= GEMV_TOL * ref.abs().max().item()


@pytest.mark.parametrize("b", [1, 4, 31])
@pytest.mark.parametrize("t", sorted(SUPPORTED_TYPES, key=int), ids=lambda t: t.name)
def test_qgemv_on_gguf_blocks(dev, t, b):
    """Every format load_params routes to the GEMV, from real GGUF block
    bytes through to_device_format and QTensor.from_host, as a model file
    loads them (37 rows: a ragged row count)."""
    g = np.load(os.path.join(GOLDEN, f"dequant_{t.name.lower()}.npz"))
    k = int(g["n_per_row"]) // 4
    raw = np.tile(g["raw"].reshape(4, -1), (10, 1))[:37]
    qt = QTensor.from_host(to_device_format(raw, t, k), dev)
    x = torch.randn(b, k, generator=torch.Generator().manual_seed(b)).to(dev)
    before = qm.launches.count
    y = qm.qgemv(x, qt)
    ref = qm.qmatmul_plain(x, qt)
    torch.cuda.synchronize()
    assert qm.launches.count == before + 1
    assert (y - ref).abs().max().item() <= GEMV_TOL * ref.abs().max().item()


@pytest.mark.parametrize("b", [1, 4, 8, 31])
@pytest.mark.parametrize("t,n,k,ksplits", [
    (GGMLType.Q4_K, 300, 4096, (None, 2, 4, 16)),   # nib4, packed scales, ragged N
    (GGMLType.Q4_0, 256, 2048, (None, 1, 8)),        # nib4, flat scales
    (GGMLType.Q6_K, 130, 2048, (None, 4, 16)),       # int8, sub-blocks of 16
    (GGMLType.Q8_0, 1024, 4096, (None, 8, 32)),      # int8, flat scales, the narrow 8B N
], ids=lambda v: getattr(v, "name", str(v)))
def test_qgemv_split_k_matches_plain_and_repeats(dev, t, n, k, ksplits, b):
    """Every cut of K the staging area allows gives the plain version's
    answer, and the same bits on every run (the parts are merged in a
    fixed order, with no float atomics)."""
    qt = _weights(dev, t, n, k, seed=b)
    x = torch.randn(b, k, device=dev)
    ref = qm.qmatmul_plain(x, qt)
    for ksplit in ksplits:
        try:
            y = qm.qgemv(x, qt, ksplit=ksplit)
        except ValueError:  # fewer slices than the staged slice of x allows
            assert ksplit is not None and ksplit < qm.gemv_split(1 << 30, qt.qs.shape[1],
                                                                 b, qt.layout)[0]
            continue
        again = [qm.qgemv(x, qt, ksplit=ksplit) for _ in range(3)]
        torch.cuda.synchronize()
        assert (y - ref).abs().max().item() <= GEMV_TOL * ref.abs().max().item()
        assert all(torch.equal(y, a) for a in again)


def test_qmatmul_routes_wide_inputs_to_plain(dev):
    qt = _weights(dev, GGMLType.Q4_K, 64, 512)
    before = qm.launches.count
    y = qm.qmatmul(torch.randn(40, 512, device=dev, dtype=torch.bfloat16), qt)
    assert y.shape == (40, 64) and y.dtype == torch.bfloat16
    assert qm.launches.count == before  # B >= 32: dequantize + matmul
    qm.qmatmul(torch.randn(2, 3, 512, device=dev), qt)
    assert qm.launches.count == before + 1


def test_qgemv_rejects_what_it_cannot_take(dev):
    qt = _weights(dev, GGMLType.Q8_0, 64, 512)
    with pytest.raises(ValueError):
        qm.qgemv(torch.randn(4, 512, device=dev, dtype=torch.bfloat16), qt)
    with pytest.raises(ValueError):
        qm.qgemv(torch.randn(33, 512, device=dev), qt)
    with pytest.raises(ValueError):
        qm.qgemv(torch.randn(512, 4, device=dev).t(), qt)


def _top2_rows(rows: int, heavy: int = 0) -> list:
    """Top-2 of 4 experts for `rows` rows, the first `heavy` of them on expert 3."""
    rng = np.random.default_rng(rows)
    return [int(e) for r in range(rows) for e in (
        [3, rng.integers(0, 3)] if r < heavy else rng.choice(4, 2, replace=False))]


# ids and the most pairs one expert holds as moe_ffn bounds it (None: P)
IDS = {"top2": ([2, 0], None), "8 pairs, repeats": ([1, 1, 3, 0, 2, 2, 0, 3], None),
       "one expert": ([3] * 5, None), "31 pairs": ([(7 * i + 3) % 4 for i in range(31)], None),
       "4 rows on 2 experts": ([0, 1, 1, 0, 0, 1, 1, 0], 4),
       "8 rows top-2": (_top2_rows(8), 8), "15 rows top-2": (_top2_rows(15, heavy=10), 15)}


def _check_indexed(qt, x, idt, n, per_expert=None):
    """One launch against the plain version; equal bits over four runs; the
    arrival counters back at 0; and a pair that shares its expert gets the
    bits it gets alone under the same K cut (alone, an int8 pair takes the
    1-column template)."""
    p = x.shape[0]
    before = qm.indexed_launches.count
    y = qm.qgemv_indexed(x, qt, idt, n, per_expert=per_expert)
    ref = qm.qgemv_indexed_plain(x, qt, idt, n, per_expert)
    torch.cuda.synchronize()
    assert qm.indexed_launches.count == before + 1
    assert (y - ref).abs().max().item() <= GEMV_TOL * ref.abs().max().item()
    again = [qm.qgemv_indexed(x, qt, idt, n, per_expert=per_expert) for _ in range(3)]
    ids = idt.tolist()
    ksplit = qm.indexed_launch(n, qt.qs.shape[1], p, qt.n_rows // n, per_expert or p,
                               qt.layout)[3]
    for i in {next((i for i, e in enumerate(ids) if ids.count(e) > 1), 0), p - 1}:
        alone = qm.qgemv_indexed(x[i:i + 1], qt, idt[i:i + 1], n, ksplit=ksplit)
        assert torch.equal(alone[0], y[i])
    torch.cuda.synchronize()
    assert all(torch.equal(y, a) for a in again)
    assert all(int(c.count_nonzero()) == 0 for c in qm._done.values())


@pytest.mark.parametrize("ids", list(IDS.values()), ids=list(IDS))
@pytest.mark.parametrize("n", [48, 259])  # 259: a ragged row count
@pytest.mark.parametrize("t,k,mode", FORMATS, ids=lambda v: getattr(v, "name", str(v)))
def test_qgemv_indexed_matches_plain(dev, t, k, mode, n, ids):
    """Row p through expert ids[p] of 4 stacked experts, one launch."""
    ids, per_expert = ids
    qt = _weights(dev, t, 4 * n, k, seed=len(ids))
    x = torch.randn(len(ids), k, device=dev)
    _check_indexed(qt, x, torch.tensor(ids, dtype=torch.int32, device=dev), n, per_expert)


def test_qgemv_indexed_many_experts(dev):
    """Qwen1.5-MoE-A2.7B's gate/up (60 experts of 1408 x 2048, Q4_K), top-4
    of 4 rows: 16 pairs, so the grid holds 16 expert slots, not 60."""
    rng = np.random.default_rng(60)
    ids = [int(e) for _ in range(4) for e in rng.choice(60, 4, replace=False)]
    qt = _weights(dev, GGMLType.Q4_K, 60 * 1408, 2048, seed=60)
    x = torch.randn(len(ids), 2048, device=dev)
    _check_indexed(qt, x, torch.tensor(ids, dtype=torch.int32, device=dev), 1408, 4)


@pytest.mark.parametrize("t,k", [(GGMLType.Q6_K, 512), (GGMLType.Q8_0, 512),
                                 (GGMLType.Q4_K, 512)], ids=lambda v: getattr(v, "name", str(v)))
def test_qgemv_indexed_passes(dev, t, k):
    """Six pairs on one expert under bounds of 6 and 8 pairs an expert (nib4
    two passes of 4, int8 three or four of 2, the last empty): the plain
    answer, and under one K cut the same bits for every bound, as a
    column's sums are its own."""
    qt = _weights(dev, t, 4 * 64, k, seed=7)
    ids = torch.tensor([2, 2, 0, 2, 2, 2, 1, 2], dtype=torch.int32, device=dev)
    x = torch.randn(8, k, device=dev)
    ref = qm.qgemv_indexed_plain(x, qt, ids, 64)
    ys = [qm.qgemv_indexed(x, qt, ids, 64, ksplit=2, per_expert=b) for b in (6, 8)]
    torch.cuda.synchronize()
    for y in ys:
        assert (y - ref).abs().max().item() <= GEMV_TOL * ref.abs().max().item()
    assert torch.equal(ys[0], ys[1])
    assert all(int(c.count_nonzero()) == 0 for c in qm._done.values())


def test_qgemv_indexed_more_pairs_than_the_bound(dev):
    """An expert with more pairs than `per_expert` allows: the pairs past the
    launch's capacity come back NaN, the others right."""
    qt = _weights(dev, GGMLType.Q4_K, 4 * 64, 512, seed=8)
    ids = torch.tensor([1] * 6, dtype=torch.int32, device=dev)
    x = torch.randn(6, 512, device=dev)
    y = qm.qgemv_indexed(x, qt, ids, 64, per_expert=2)  # one pass of 4 columns
    ref = qm.qgemv_indexed_plain(x, qt, ids, 64)
    torch.cuda.synchronize()
    assert (y[:4] - ref[:4]).abs().max().item() <= GEMV_TOL * ref.abs().max().item()
    assert bool(y[4:].isnan().all())


@pytest.mark.parametrize("t,n,k,ksplits", [
    (GGMLType.Q4_K, 300, 4096, (None, 2, 4, 16)),
    (GGMLType.Q6_K, 130, 2048, (None, 4, 16)),
    (GGMLType.Q8_0, 256, 4096, (None, 8, 32)),
], ids=lambda v: getattr(v, "name", str(v)))
def test_qgemv_indexed_split_k_repeats(dev, t, n, k, ksplits):
    """Split K with pairs on one expert: each (expert slot, pass) has its
    own scratch and arrival counters, so every cut gives the plain answer,
    the same bits on every run, and the counters are back at 0 after each
    launch."""
    qt = _weights(dev, t, 3 * n, k, seed=5)
    ids = torch.tensor([2, 2, 0, 2, 1, 0, 2, 2], dtype=torch.int32, device=dev)
    x = torch.randn(len(ids), k, device=dev)
    ref = qm.qgemv_indexed_plain(x, qt, ids, n)
    for ksplit in ksplits:
        try:
            y = qm.qgemv_indexed(x, qt, ids, n, ksplit=ksplit)
        except ValueError:  # fewer slices than the staged slice of x allows
            assert ksplit is not None
            continue
        again = [qm.qgemv_indexed(x, qt, ids, n, ksplit=ksplit) for _ in range(3)]
        torch.cuda.synchronize()
        assert (y - ref).abs().max().item() <= GEMV_TOL * ref.abs().max().item()
        assert all(torch.equal(y, a) for a in again)
    assert all(int(c.count_nonzero()) == 0 for c in qm._done.values())


def test_qgemv_indexed_rejects_what_it_cannot_take(dev):
    qt = _weights(dev, GGMLType.Q8_0, 4 * 64, 512)
    x = torch.randn(2, 512, device=dev)
    with pytest.raises(ValueError):  # ids on the host
        qm.qgemv_indexed(x, qt, torch.zeros(2, dtype=torch.int32), 64)
    with pytest.raises(ValueError):  # int64 ids
        qm.qgemv_indexed(x, qt, torch.zeros(2, dtype=torch.int64, device=dev), 64)
    with pytest.raises(ValueError):  # not whole experts
        qm.qgemv_indexed(x, qt, torch.zeros(2, dtype=torch.int32, device=dev), 60)


def test_moe_decode_launches_the_indexed_gemv(dev):
    """A tiny Mixtral-shaped model on the card: a decode step of 4 rows
    (8 pairs) launches the indexed GEMV for gate, up and down of every
    layer, and its logits agree with the plain path's."""
    from prima_tpu_torch.models import llama as L
    from prima_tpu_torch.models.config import tiny_config

    cfg = tiny_config(n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64, rope_dim=64,
                      n_ff=256, n_expert=4, n_expert_used=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = L.synth_params_device(cfg, GGMLType.Q4_K, seed=0, device=dev)
    for layer in params["layers"]:
        for key in ("w_gate", "w_up", "w_down"):
            del layer[key]
        layer["ffn_gate_inp"] = torch.randn(4, 256, generator=gen, device=dev) * 0.5
        for key, rows, k in (("ffn_gate_exps", 4 * 256, 256), ("ffn_up_exps", 4 * 256, 256),
                             ("ffn_down_exps", 4 * 256, 256)):
            layer[key] = synth_qtensor_device(gen, rows, k, GGMLType.Q4_K, dev)
    toks = torch.randint(0, cfg.n_vocab, (4, 1), generator=gen, device=dev)
    logits = {}
    for impl in ("kernel", "plain"):
        kv = L.init_kv_caches(cfg, 4, 16, torch.float32, dev)
        before = qm.indexed_launches.count
        logits[impl], _ = L.forward(params, cfg, toks, torch.zeros((4, 1), dtype=torch.int32,
                                                                   device=dev),
                                    kv, torch.zeros(4, dtype=torch.int32, device=dev),
                                    L.ForwardOptions(matmul_impl=impl, dtype=torch.float32))
        launched = qm.indexed_launches.count - before
        assert launched == (3 * cfg.n_layers if impl == "kernel" else 0)
    err = (logits["kernel"] - logits["plain"]).abs().max().item()
    assert err <= 1e-3 * logits["plain"].abs().max().item()


KV_CASES = [(4, 1, 2048, 1024, [5, 700, 2047, 1300]), (1, 128, 2048, 1024, [256]),
            (4, 8, 64, 1024, [60, 0, 3000, 17]), (4, 1, 512, 256, [0, 1, 2, 511]),
            (4, 1, 512, 128, [3, 9, 27, 81]), (2, 3, 16, 24, [1, 14]),
            # a restored slot of the tiny pair's q8_0 cache: code rows, scale rows
            (1, 59, 512, 256, [0]), (1, 59, 512, 4, [0])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("b,s,t,p,pos", KV_CASES)
def test_kv_write_matches_plain(dev, b, s, t, p, pos, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cache = (torch.randn((b, t, p), generator=gen, device=dev) * 20).to(dtype)
    new = (torch.randn((b, s, p), generator=gen, device=dev) * 20).to(dtype)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = kvw.launches.count
    got = kvw.kv_write(cache.clone(), new, pos_t)
    want = kvw.kv_write_plain(cache.clone(), new, pos_t)
    torch.cuda.synchronize()
    assert kvw.launches.count == before + 1
    assert torch.equal(got, want)


def test_kv_write_on_a_slot_row_view(dev):
    """The engine's prefill writes one slot's row of a wider cache."""
    big = torch.zeros((3, 32, 4, 64), dtype=torch.bfloat16, device=dev)
    new = torch.randn((1, 5, 4, 64), device=dev).to(torch.bfloat16)
    pos = torch.tensor([30], dtype=torch.int32, device=dev)
    kvw.kv_write(big[1:2], new, pos)
    want = kvw.kv_write_plain(torch.zeros_like(big[1:2]), new, pos)
    torch.cuda.synchronize()
    assert torch.equal(big[1:2], want)
    assert not big[0].any() and not big[2].any()


def test_kv_write_rejects_host_positions_and_dtype_mismatch(dev):
    cache = torch.zeros((2, 16, 8), device=dev)
    new = torch.ones((2, 1, 8), device=dev)
    with pytest.raises(ValueError):
        kvw.kv_write(cache, new, torch.tensor([0, 1], dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        kvw.kv_write(cache, new.half(), torch.tensor([0, 1], dtype=torch.int32, device=dev))


# flash attention: (B, S, H, KVH, D, T, pos0 per batch row)
ATTN_CASES = [(4, 1, 32, 8, 128, 2048, [5, 1000, 2047, 700]),  # 8B decode
              (4, 4, 32, 8, 128, 2000, [0, 77, 1996, 1024]),  # multi-row, T % 256 != 0
              (4, 1, 4, 4, 64, 256, [0, 1, 100, 255]),        # the tiny pair
              (2, 8, 16, 2, 64, 300, [3, 290]),               # 64 folded rows: 2 row tiles
              (1, 129, 32, 8, 128, 1024, [300]),              # ragged prefill chunk
              (2, 16, 4, 4, 64, 256, [0, 200])]               # tiny-pair prefill


def _attn_inputs(dev, b, s, h, kvh, d, t, pos0, dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, s, h, d), (b, t, kvh, d), (b, t, kvh, d)))
    pos = (torch.tensor(pos0, dtype=torch.int32, device=dev)[:, None]
           + torch.arange(s, dtype=torch.int32, device=dev))
    return q, k, v, pos


def _attn_tol(ref, dtype):
    # f32: sums in another order; bf16: one output rounding apart
    m = ref.float().abs().max().item()
    return 2e-5 * max(1.0, m) if dtype == torch.float32 else 1e-2 * m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kvh,d,t,pos0", ATTN_CASES)
def test_flash_attention_matches_plain(dev, b, s, h, kvh, d, t, pos0, dtype):
    q, k, v, pos = _attn_inputs(dev, b, s, h, kvh, d, t, pos0, dtype)
    plain = attn.flash_decode_plain if s <= 8 else attn.flash_prefill_plain
    counter = attn.decode_launches if s <= 8 else attn.prefill_launches
    before = counter.count
    got = attn.flash_attention(q, k, v, pos, 0.125)
    want = plain(q, k, v, pos, 0.125)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= _attn_tol(want, dtype)


def test_flash_reads_only_the_visible_prefix(dev):
    """Cells past the last visible one are never read: NaN there changes
    nothing, in decode and prefill."""
    for s, pos0 in ((1, [10, 300]), (4, [0, 250]), (32, [10, 300])):
        q, k, v, pos = _attn_inputs(dev, 2, s, 8, 2, 128, 512, pos0, torch.bfloat16)
        lim = pos0[1] + s  # one past the last query position of row 1
        want = attn.flash_attention(q, k, v, pos, 0.1)
        k[1, lim:] = float("nan")
        v[1, lim:] = float("nan")
        k[0, 64:] = float("nan")
        v[0, 64:] = float("nan")
        got = attn.flash_attention(q, k, v, pos, 0.1)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_flash_on_a_slot_row_view(dev):
    """The engine's prefill hands in one slot's row of the full cache."""
    q, k, v, pos = _attn_inputs(dev, 3, 16, 8, 2, 64, 128, [0, 40, 90], torch.float32)
    got = attn.flash_prefill(q[1:2], k[1:2], v[1:2], pos[1:2], 0.125)
    want = attn.flash_prefill_plain(q[1:2], k[1:2].clone(), v[1:2].clone(), pos[1:2], 0.125)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= _attn_tol(want, torch.float32)


def test_flash_rejects_what_it_cannot_take(dev):
    q, k, v, pos = _attn_inputs(dev, 2, 1, 8, 2, 64, 64, [1, 2], torch.float32)
    for args in [(q.bfloat16(), k, v, pos), (q, k, v, pos.long()),
                 (q, k.transpose(1, 2).contiguous().transpose(1, 2), v, pos),
                 (q, k.cpu(), v, pos)]:
        with pytest.raises(ValueError):
            attn.flash_decode(*args, 0.125)


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
def test_quantized_update_kv_matches_cpu(dev, kind):
    """KVQ8 / KVQ4 codes written through the kv_write kernel equal the CPU
    path's (plain index writes)."""
    cls = kvq.KVQ8 if kind == "q8_0" else kvq.KVQ4
    new = torch.randn((4, 3, 8, 128), generator=torch.Generator().manual_seed(5))
    pos = torch.tensor([0, 9, 30, 2045], dtype=torch.int32)
    caches = []
    for d in ("cpu", dev):
        c = cls.zeros((4, 2048, 8, 128), d)
        kvq.update_kv(c, new.to(d), pos.to(d))
        caches.append(c)
    torch.cuda.synchronize()
    assert torch.equal(caches[0].qs, caches[1].qs.cpu())
    assert torch.equal(caches[0].scale, caches[1].scale.cpu())


# flash_decode: (B, S, H, KVH, D, T, pos0 per batch row)
DECODE_CASES = [(4, 1, 32, 8, 128, 8192, [4000, 4031, 3990, 4060]),  # the long-context step
                (4, 4, 32, 8, 128, 2000, [0, 77, 1996, 1024]),       # S = 4, T % 64 != 0
                (2, 8, 32, 8, 128, 1024, [3, 1016]),                 # 32 folded rows
                (4, 1, 4, 4, 64, 256, [0, 1, 100, 255]),             # the tiny pair, group 1
                (2, 8, 16, 2, 64, 300, [3, 290]),                    # 64 rows: 2 row tiles
                (3, 1, 8, 8, 64, 2048, [17, 2047, 600])]             # one chunk shorter than a tile
KINDS = {"dense": None, "q8_0": kvq.KVQ8, "q4_0": kvq.KVQ4}


def _decode_caches(cls, k, v, pos0, s, dtype):
    """(caches for the kernel, caches for the plain version): the first hold
    NaN in every cell past a row's last query position (NaN scales for a
    quantized cache), the second zeros there."""
    out = []
    for fill in (float("nan"), 0.0):
        pair = []
        for x in (k, v):
            if cls is None:
                c = x.clone()
                for i, p0 in enumerate(pos0):
                    c[i, p0 + s:] = fill
            else:
                c = cls(*cls.quantize(x))
                for i, p0 in enumerate(pos0):
                    c.scale[i, p0 + s:] = fill
            pair.append(c)
        out.append(pair)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("b,s,h,kvh,d,t,pos0", DECODE_CASES)
def test_flash_decode_matches_plain_and_repeats(dev, b, s, h, kvh, d, t, pos0, kind, dtype):
    """Dense, q8_0 and q4_0 caches against flash_decode_plain on
    cache.to(dtype); cells past each prefix (NaN) are never read; four runs
    give the same bits (the chunks are merged in index order)."""
    q, k, v, pos = _attn_inputs(dev, b, s, h, kvh, d, t, pos0, dtype, seed=s + d)
    (kn, vn), (kz, vz) = _decode_caches(KINDS[kind], k, v, pos0, s, dtype)
    want = attn.flash_decode_plain(q, kz, vz, pos, 0.125)
    before = attn.decode_launches.count
    runs = [attn.flash_decode(q, kn, vn, pos, 0.125) for _ in range(4)]
    torch.cuda.synchronize()
    assert attn.decode_launches.count == before + 4
    assert runs[0].dtype == dtype and runs[0].shape == q.shape
    assert (runs[0].float() - want.float()).abs().max().item() <= _attn_tol(want, dtype)
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.parametrize("kind", list(KINDS))
def test_flash_decode_on_a_slot_row_view(dev, kind):
    """The engine hands in one slot's row of the full cache: codes and scales
    arrive with their own batch strides."""
    q, k, v, pos = _attn_inputs(dev, 3, 1, 8, 2, 128, 512, [40, 300, 511], torch.bfloat16)
    cls = KINDS[kind]
    kc, vc = (k, v) if cls is None else (cls(*cls.quantize(k)), cls(*cls.quantize(v)))
    got = attn.flash_decode(q[1:2].contiguous(), kc[1:2], vc[1:2], pos[1:2], 0.125)
    want = attn.flash_decode_plain(q[1:2], kc[1:2], vc[1:2], pos[1:2], 0.125)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _attn_tol(want, torch.bfloat16)


def test_flash_decode_rejects_mixed_caches(dev):
    q, k, v, pos = _attn_inputs(dev, 2, 1, 8, 2, 64, 64, [1, 2], torch.float32)
    k8 = kvq.KVQ8(*kvq.KVQ8.quantize(k))
    with pytest.raises(ValueError):
        attn.flash_decode(q, k8, v, pos, 0.125)
    with pytest.raises(ValueError):
        attn.flash_decode(q, k8, kvq.KVQ4(*kvq.KVQ4.quantize(v)), pos, 0.125)
    with pytest.raises(ValueError):
        attn.flash_decode(q.repeat(1, 9, 1, 1), k, v, pos.repeat(1, 9), 0.125)


def _store_caches(dev, kind, shape, dtype):
    if kind == "dense":
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(2))
    cls = KINDS[kind]
    return cls.zeros(shape, dev), cls.zeros(shape, dev)


def _cache_tensors(c):
    return (c.qs, c.scale) if kvq.is_quantized(c) else (c,)


# kv_store: (B, S, T, H, D, positions), one of them past T - S
STORE_CASES = [(4, 1, 2048, 8, 128, [5, 700, 2047, 3000]),   # the 8B decode step
               (1, 256, 2048, 8, 128, [1900]),               # a prefill chunk, clamped
               (4, 3, 64, 4, 64, [0, 9, 30, 62]),            # the tiny pair
               (2, 5, 16, 2, 24, [1, 14]),                   # head_dim 24: 12 codes a half
               (2, 5, 16, 3, 20, [1, 14])]                   # rows of 120 bytes: no 16-byte copies


@pytest.mark.parametrize("new_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,dtype", [("dense", torch.float32), ("dense", torch.bfloat16),
                                        ("q8_0", None), ("q4_0", None)])
@pytest.mark.parametrize("b,s,t,h,d,pos", STORE_CASES)
def test_kv_store_matches_plain_bit_for_bit(dev, b, s, t, h, d, pos, kind, dtype, new_dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(s)
    k_new, v_new = ((torch.randn((b, s, h, d), generator=gen, device=dev)
                     * 10.0 ** torch.randint(-3, 3, (b, s, h, 1), generator=gen, device=dev))
                    .to(new_dtype) for _ in range(2))
    k_new[0, 0, 0] = 0  # a zero vector: scale 0, codes 0
    v_new[0, 0, 1] = torch.arange(d, device=dev) * 0.5 - 2.75  # ties: round half to even
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    got = _store_caches(dev, kind, (b, t, h, d), dtype)
    want = _store_caches(dev, kind, (b, t, h, d), dtype)
    before = kvw.store_launches.count
    if kind != "dense" and d % 8:
        with pytest.raises(ValueError):  # the quantizing kernel takes head_dim % 8 == 0
            kvw.kv_store(*got, k_new, v_new, pos_t)
        return
    out = kvw.kv_store(*got, k_new, v_new, pos_t)
    kvw.kv_store_plain(*want, k_new, v_new, pos_t)
    torch.cuda.synchronize()
    assert kvw.store_launches.count == before + 1
    assert out[0] is got[0] and out[1] is got[1]  # in place
    for g, w in zip(got, want):
        for x, y in zip(_cache_tensors(g), _cache_tensors(w)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["dense", "q8_0", "q4_0"])
def test_kv_store_on_a_slot_row_view(dev, kind):
    """The engine's prefill writes one slot's row of the full caches."""
    shape = (3, 32, 4, 64)
    got = _store_caches(dev, kind, shape, torch.bfloat16)
    want = _store_caches(dev, kind, shape, torch.bfloat16)
    new = torch.randn((2, 1, 5, 4, 64), device=dev).to(torch.bfloat16)
    pos = torch.tensor([30], dtype=torch.int32, device=dev)
    kvw.kv_store(got[0][1:2], got[1][1:2], new[0], new[1], pos)
    kvw.kv_store_plain(want[0][1:2], want[1][1:2], new[0], new[1], pos)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        for x, y in zip(_cache_tensors(g), _cache_tensors(w)):
            assert torch.equal(x, y)


def test_kv_store_rejects_what_it_cannot_take(dev):
    k, v = _store_caches(dev, "dense", (2, 16, 2, 64), torch.float32)
    new = torch.ones((2, 1, 2, 64), device=dev)
    pos = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kvw.kv_store(k, v, new, new, pos.long())
    with pytest.raises(ValueError):
        kvw.kv_store(k, kvq.KVQ8.zeros((2, 16, 2, 64), dev), new, new, pos)
    with pytest.raises(ValueError):
        kvw.kv_store(k, v, new, new.half(), pos)
    with pytest.raises(ValueError):
        kvw.kv_store(k, v, new[:, :, :1], new[:, :, :1], pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
@pytest.mark.parametrize("b,s,h,kvh,d,t,pos0", [
    (1, 256, 32, 8, 128, 2048, [1500]),   # an 8B chunk: whole row tiles
    (2, 129, 8, 2, 128, 1024, [0, 700]),  # ragged rows; position 0 leaves later splits empty
    (2, 9, 4, 4, 64, 512, [100, 503]),    # S = 9 up to the cache's end, D = 64
])
def test_flash_prefill_splits_match_plain(dev, b, s, h, kvh, d, t, pos0, n_split, dtype):
    """Any split of the KV axis gives the plain version's answer, and cells
    past each prefix (NaN here) are never read."""
    q, k, v, pos = _attn_inputs(dev, b, s, h, kvh, d, t, pos0, dtype, seed=n_split)
    for i, p0 in enumerate(pos0):
        k[i, p0 + s:] = 0
        v[i, p0 + s:] = 0
    want = attn.flash_prefill_plain(q, k, v, pos, 0.125)
    for i, p0 in enumerate(pos0):
        k[i, p0 + s:] = float("nan")
        v[i, p0 + s:] = float("nan")
    before = attn.prefill_launches.count
    got = attn.flash_prefill(q, k, v, pos, 0.125, n_split=n_split)
    again = attn.flash_prefill(q, k, v, pos, 0.125, n_split=n_split)
    torch.cuda.synchronize()
    assert attn.prefill_launches.count == before + 2
    assert (got.float() - want.float()).abs().max().item() <= _attn_tol(want, dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("nbytes", [16, 4096 + 16, 1 << 26])
def test_hbm_probe_sum_is_exact(dev, nbytes):
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (nbytes // 4,), dtype=torch.int32, device=dev)
    before = hbm_probe.launches.count
    got = hbm_probe.read_sum(x)
    assert hbm_probe.launches.count == before + 1
    assert int(got) == int(hbm_probe.read_sum_plain(x))
    with pytest.raises(ValueError):
        hbm_probe.read_sum(x[1:])  # not 16-byte aligned
