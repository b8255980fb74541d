"""The port's flash attention (ops/attention.py) against the JAX package's
Pallas kernels (ops/attention_pallas.py, interpret mode on the CPU), on the
same numpy inputs. On the CPU the port's wrappers run their plain
versions; tests/test_torch_cuda.py holds the CUDA kernels against those on
the card. Tolerances: f32 max |err| <= 2e-5 * max(1, max |ref|) (sums in
another order, as tests/test_attention_pallas.py allows the kernel against
XLA); bf16 outputs within 1e-2 * max |ref| (one bf16 rounding apart)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prima_tpu.models.llama import ForwardOptions as JOpts
from prima_tpu.models.llama import forward as jforward
from prima_tpu.models.llama import init_kv_caches as jinit_kv
from prima_tpu.models.loader import load_model as jload_model
from prima_tpu.ops import attention_pallas as jattn
from prima_tpu.ops import kvquant as jkvq
from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
from prima_tpu_torch.models.loader import load_model
from prima_tpu_torch.ops import attention as attn
from prima_tpu_torch.ops import kvquant as kvq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(ROOT, "models_tiny_pair", "target.gguf")
F32_TOL = 2e-5


def _inputs(b, s, t, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kvh, d)).astype(np.float32)
    return q, k, v


def _compare(q, k, v, positions, dtype="float32"):
    scale = 1.0 / np.sqrt(q.shape[-1])
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(positions, jnp.int32), scale).astype(jnp.float32))
    got = attn.flash_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.from_numpy(np.asarray(positions, np.int32)),
        scale)
    assert got.dtype == td and got.shape == q.shape
    err = np.abs(got.float().numpy() - want).max()
    ref = np.abs(want).max()
    tol = F32_TOL * max(1.0, ref) if dtype == "float32" else 1e-2 * ref
    assert err <= tol, (err, ref)


def _contiguous(pos0, s):
    return np.asarray(pos0, np.int32)[:, None] + np.arange(s, dtype=np.int32)


@pytest.mark.parametrize("b,s,t,h,kvh,d", [
    (1, 1, 128, 8, 2, 64),    # decode step
    (2, 16, 64, 4, 4, 32),    # prefill, MHA
    (1, 8, 256, 8, 2, 64),    # s_q = 8: still the decode kernel
])
def test_matches_jax_at_the_pallas_test_shapes(b, s, t, h, kvh, d):
    _compare(*_inputs(b, s, t, h, kvh, d), _contiguous([20] * b, s))


@pytest.mark.parametrize("b,s,t,h,kvh,d,pos0", [
    (4, 1, 64, 8, 2, 64, [0, 17, 40, 63]),      # per-row positions, 0 and T - 1
    (4, 4, 64, 8, 2, 64, [0, 9, 30, 60]),       # s_q = 4
    (3, 1, 96, 4, 1, 128, [95, 0, 50]),         # T = 96: one block of 96
    (2, 2, 320, 4, 2, 64, [63, 250]),           # T = 320: kv_blk halves to 64
    (2, 1, 2000, 4, 2, 64, [5, 1999]),          # T = 2000: kv_blk 16
])
def test_decode_matches_jax(b, s, t, h, kvh, d, pos0):
    _compare(*_inputs(b, s, t, h, kvh, d, seed=b + s + t), _contiguous(pos0, s))


@pytest.mark.parametrize("pos0", [[3, 600], [0, 1000]])
def test_prefill_with_masked_blocks_matches_jax(pos0):
    """T = 1024 (blocks of 512): the later blocks are wholly masked for
    some rows, which the port's kernel skips and the TPU kernel scans."""
    _compare(*_inputs(2, 16, 1024, 4, 2, 64, seed=7), _contiguous(pos0, 16))


@pytest.mark.parametrize("s", [1, 4, 24])
def test_bf16_matches_jax(s):
    _compare(*_inputs(2, s, 128, 8, 2, 64, seed=s), _contiguous([5, 100], s), "bfloat16")


QUANT = {"q8_0": (kvq.KVQ8, jkvq.KVQ8, jkvq.quantize_kv),
         "q4_0": (kvq.KVQ4, jkvq.KVQ4, jkvq.quantize_kv4)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(QUANT))
@pytest.mark.parametrize("b,s,t,h,kvh,d,pos0", [
    (4, 1, 64, 8, 2, 64, [0, 17, 40, 63]),     # a decode step, per-row positions
    (2, 4, 320, 4, 2, 128, [63, 250]),         # s_q = 4, head_dim 128, kv_blk 64
    (2, 8, 96, 4, 4, 64, [0, 88]),             # s_q = 8, group 1, up to the cache's end
    (2, 1, 2000, 4, 2, 64, [5, 1999]),         # T = 2000: kv_blk 16
])
def test_decode_over_quantized_caches_matches_jax(b, s, t, h, kvh, d, pos0, kind, dtype):
    """flash_decode handed KVQ8 / KVQ4 caches as they are against the JAX
    kernel on cache.astype(dtype), as prima_tpu/models/llama.py calls it."""
    q, k, v = _inputs(b, s, t, h, kvh, d, seed=b + s + t)
    cls, jcls, jquantize = QUANT[kind]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    positions = _contiguous(pos0, s)
    scale = 1.0 / np.sqrt(d)
    jk, jv = (jcls(*jquantize(jnp.asarray(x))) for x in (k, v))
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q, jd), jk.astype(jd), jv.astype(jd), jnp.asarray(positions),
        scale).astype(jnp.float32))
    ck, cv = (cls(*cls.quantize(torch.from_numpy(x))) for x in (k, v))
    np.testing.assert_array_equal(ck.qs.numpy(), np.asarray(jk.qs))  # the same codes go in
    before = kvq.KVQ8.materialized
    got = attn.flash_attention(torch.from_numpy(q).to(td), ck, cv,
                               torch.from_numpy(positions), scale)
    assert kvq.KVQ8.materialized == before + 2  # only the plain version's two copies
    assert got.dtype == td and got.shape == q.shape
    err = np.abs(got.float().numpy() - want).max()
    ref = np.abs(want).max()
    assert err <= (F32_TOL * max(1.0, ref) if dtype == "float32" else 1e-2 * ref), (err, ref)


@pytest.mark.parametrize("shape,dtype,want", [
    ((4, 1, 32, 8, 8192), torch.bfloat16, (8, 1024)),    # the 8B long step: 256 blocks
    ((8, 1, 32, 8, 8192), torch.bfloat16, (4, 2048)),    # 8 slots: the same 256
    ((4, 8, 32, 8, 8192), torch.bfloat16, (8, 1024)),    # 32 rows: still one row tile
    ((1, 1, 32, 8, 8192), torch.bfloat16, (32, 256)),    # one slot: the least chunk
    ((4, 1, 32, 8, 2000), torch.bfloat16, (8, 256)),     # T = 2000
    ((4, 1, 4, 4, 256), torch.float32, (1, 256)),        # the tiny pair
    ((2, 8, 16, 2, 300), torch.float32, (2, 192)),       # 64 rows in 4 f32 row tiles
], ids=["8b-long", "8b-8-slots", "8b-s8", "one-slot", "t2000", "tiny-pair", "t300"])
def test_decode_split_is_a_pure_function_of_the_shapes(shape, dtype, want):
    assert attn.decode_split(*shape, dtype) == want
    assert attn.decode_split(*shape, dtype) == want  # no state between calls
    n_split, split_len = want
    assert split_len % 64 == 0 and (n_split - 1) * split_len < shape[4] <= n_split * split_len


def test_decode_rows_per_block():
    bf16, f32 = torch.bfloat16, torch.float32
    assert [attn.decode_rows_per_block(r, bf16) for r in (1, 4, 16, 17, 64)] == [16, 16, 16, 32, 32]
    assert [attn.decode_rows_per_block(r, f32) for r in (1, 2, 4, 5, 16, 64)] == [1, 4, 4, 16, 16, 16]


@pytest.mark.parametrize("n_split", [1, 2, 4])
@pytest.mark.parametrize("b,s,t,h,kvh,d,pos0,tile", [
    (2, 16, 1024, 4, 2, 64, [3, 600], 64),    # later splits empty for row 0
    (1, 40, 512, 8, 2, 64, [100], 32),        # 160 folded rows: 3 row tiles, one ragged
    (2, 9, 256, 4, 4, 32, [0, 247], 32),      # position 0 and the cache's end
])
def test_split_and_merge_matches_jax(b, s, t, h, kvh, d, pos0, tile, n_split):
    """The KV split of the prefill kernel in plain PyTorch (interleaved
    tiles, parts merged in order, splits past the visible prefix empty)
    against the Pallas kernel, f32, within 2e-5 * max(1, max |ref|)."""
    q, k, v = _inputs(b, s, t, h, kvh, d, seed=n_split + t)
    positions = _contiguous(pos0, s)
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions), scale))
    got = attn.flash_prefill_split_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(positions), scale, n_split, tile).numpy()
    assert np.abs(got - want).max() <= F32_TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("shape,tile,want", [
    ((1, 256, 32, 8, 8192), 64, 2),   # the 8B chunk: 128 row-tile blocks -> 256
    ((1, 129, 32, 8, 8192), 64, 3),   # the ragged 8B chunk: 72 blocks -> 216
    ((1, 64, 4, 4, 256), 32, 2),      # the tiny pair: a split keeps 4 tiles
    ((4, 256, 32, 8, 8192), 64, 1),   # 512 blocks fill the card without a split
    ((2, 9, 32, 8, 8192), 64, 8),     # few rows: the cap of 8
], ids=["8b-256", "8b-129", "tiny-pair", "8b-batch-4", "s9"])
def test_prefill_n_split_is_a_pure_function_of_the_shapes(shape, tile, want):
    assert attn.prefill_n_split(*shape, tile) == want
    assert attn.prefill_n_split(*shape, tile) == want  # no state between calls
    assert attn.prefill_tile(torch.bfloat16) == 64 and attn.prefill_tile(torch.float32) == 32


def test_check_rejects_what_the_kernels_cannot_take():
    q = torch.zeros(2, 1, 8, 64)
    k = torch.zeros(2, 16, 2, 64)
    pos = torch.zeros(2, 1, dtype=torch.int32)
    attn._check(q, k, k, pos, "t")
    bad = [(q.bfloat16(), k, k, pos), (q, k, k, pos.long()),
           (torch.zeros(2, 1, 8, 96), torch.zeros(2, 16, 2, 96), torch.zeros(2, 16, 2, 96), pos),
           (q, k.transpose(1, 2).contiguous().transpose(1, 2), k, pos),
           (q.transpose(2, 3).contiguous().transpose(2, 3), k, k, pos),
           (q, torch.zeros(2, 16, 3, 64), torch.zeros(2, 16, 3, 64), pos)]
    for args in bad:
        with pytest.raises(ValueError):
            attn._check(*args, "t")


@pytest.mark.parametrize("kind", list(QUANT))
def test_check_takes_quantized_caches_of_one_kind(kind):
    cls = QUANT[kind][0]
    q = torch.zeros(2, 1, 8, 64, dtype=torch.bfloat16)
    pos = torch.zeros(2, 1, dtype=torch.int32)
    k, v = cls.zeros((3, 16, 2, 64)), cls.zeros((3, 16, 2, 64))
    attn._check(q, k[1:3], v[:2], pos, "t")  # slot views keep their strides
    assert attn._cache_parts(k)[2] == {"q8_0": 1, "q4_0": 2}[kind]
    other = kvq.KVQ4 if cls is kvq.KVQ8 else kvq.KVQ8
    bad = [(q, k[:2], torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16), pos),
           (q, k[:2], other.zeros((2, 16, 2, 64)), pos),
           (q, k[:2], cls(v.qs[:2], v.scale[:2].double()), pos),
           (q, k[:2], cls(v.qs[:2], v.scale[:2, :, :1]), pos)]
    for args in bad:
        with pytest.raises(ValueError):
            attn._check(*args, "t")


@pytest.fixture(scope="module")
def pair():
    return jload_model(PAIR), load_model(PAIR, device="cpu")


@pytest.mark.parametrize("kv_dtype", ["q8_0", "q4_0"])
def test_forward_over_quantized_caches_matches_jax_pallas(pair, kv_dtype):
    """A 12-token prefill and 6 greedy decode steps through forward with
    attn_impl "kernel" over a q8_0 / q4_0 cache (one fused KV store a layer,
    the decode kernel handed the caches as they are) against JAX "pallas":
    logits within 1e-4 * max |logit|, the same greedy tokens, and (but for
    rounding ties) the same codes in the caches."""
    jm, m = pair
    jopts = JOpts(matmul_impl="xla", attn_impl="pallas", dtype=jnp.float32)
    opts = ForwardOptions(attn_impl="kernel", dtype=torch.float32)
    jkv = jinit_kv(jm.cfg, 1, 64, kv_dtype)
    kv = init_kv_caches(m.cfg, 1, 64, kv_dtype, "cpu")
    chunk = m.tokenizer.encode("def main(): return 42", add_special=True)[:12]
    p0, jstream, stream = 0, [], []
    for _ in range(7):
        pos = np.arange(p0, p0 + len(chunk), dtype=np.int32)[None]
        want, jkv = jforward(jm.params, jm.cfg, np.asarray([chunk], np.int32), pos, jkv,
                             np.asarray([p0], np.int32), jopts)
        got, kv = forward(m.params, m.cfg, torch.tensor([chunk]), torch.from_numpy(pos),
                          kv, torch.tensor([p0], dtype=torch.int32), opts)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        jstream.append(int(want[0, -1].argmax()))
        stream.append(int(got[0, -1].argmax()))
        p0 += len(chunk)
        chunk = [jstream[-1]]
    assert stream == jstream
    # the caches hold the same codes up to a tie that the two frameworks'
    # activations (1e-6 apart) round the other way
    for (k, v), (jk, jv) in zip(kv, jkv):
        for a, ja in ((k, jk), (v, jv)):
            diff = np.abs(a.qs.numpy()[:, :p0].astype(np.int32) - np.asarray(ja.qs)[:, :p0])
            assert diff.max() <= (1 if kv_dtype == "q8_0" else 0x11) and (diff != 0).mean() < 1e-2


def test_forward_with_kernel_attention_matches_jax_pallas(pair):
    """A 12-token prefill (flash prefill) and a decode step (flash decode)
    through forward, attn_impl "kernel" against JAX "pallas", f32."""
    jm, m = pair
    jopts = JOpts(matmul_impl="xla", attn_impl="pallas", dtype=jnp.float32)
    opts = ForwardOptions(attn_impl="kernel", dtype=torch.float32)
    jkv = jinit_kv(jm.cfg, 1, 64, jnp.float32)
    kv = init_kv_caches(m.cfg, 1, 64, torch.float32, "cpu")
    toks = m.tokenizer.encode("def main(): return 42", add_special=True)[:12]
    steps = [(toks, 0), ([toks[3]], 12)]
    for chunk, p0 in steps:
        pos = np.arange(p0, p0 + len(chunk), dtype=np.int32)[None]
        want, jkv = jforward(jm.params, jm.cfg, np.asarray([chunk], np.int32), pos, jkv,
                             np.asarray([p0], np.int32), jopts)
        got, kv = forward(m.params, m.cfg, torch.tensor([chunk]), torch.from_numpy(pos),
                          kv, torch.tensor([p0], dtype=torch.int32), opts)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
