"""The reference's dequantizers against ggml's block layouts: a scalar
transcription of ggml-quants.c's dequantize_row_* on hand-made and on
generated blocks, and the generated weights' statistics."""

import numpy as np
import pytest
import torch

from benchmark.blocks import Q4_K, Q5_0, Q5_K, Q6_K, Q8_0, WEIGHT_RMS, make_blocks, make_dense
from benchmark.reference import DEQUANT

f32 = np.float32


def _f16(b) -> f32:
    return f32(np.frombuffer(bytes(b), np.float16)[0])


def _scale_min_k4(j, q):
    if j < 4:
        return q[j] & 63, q[j + 4] & 63
    return (q[j + 4] & 0xF) | ((q[j - 4] >> 6) << 4), (q[j + 4] >> 4) | ((q[j] >> 6) << 4)


def ggml_q4_k(b):
    d, dmin, sc, q = _f16(b[0:2]), _f16(b[2:4]), b[4:16], b[16:144]
    y, i = [], 0
    for j in range(0, 256, 64):
        s1, m1 = _scale_min_k4(i, sc)
        s2, m2 = _scale_min_k4(i + 1, sc)
        d1, mm1, d2, mm2 = d * f32(s1), dmin * f32(m1), d * f32(s2), dmin * f32(m2)
        y += [d1 * f32(q[l] & 0xF) - mm1 for l in range(32)]
        y += [d2 * f32(q[l] >> 4) - mm2 for l in range(32)]
        q, i = q[32:], i + 2
    return np.array(y, f32)


def ggml_q5_k(b):
    d, dmin, sc, qh, ql = _f16(b[0:2]), _f16(b[2:4]), b[4:16], b[16:48], b[48:176]
    y, i, u1, u2 = [], 0, 1, 2
    for j in range(0, 256, 64):
        s1, m1 = _scale_min_k4(i, sc)
        s2, m2 = _scale_min_k4(i + 1, sc)
        d1, mm1, d2, mm2 = d * f32(s1), dmin * f32(m1), d * f32(s2), dmin * f32(m2)
        y += [d1 * f32((ql[l] & 0xF) + (16 if qh[l] & u1 else 0)) - mm1 for l in range(32)]
        y += [d2 * f32((ql[l] >> 4) + (16 if qh[l] & u2 else 0)) - mm2 for l in range(32)]
        ql, i, u1, u2 = ql[32:], i + 2, u1 << 2, u2 << 2
    return np.array(y, f32)


def ggml_q6_k(b):
    ql, qh = b[0:128], b[128:192]
    sc = np.frombuffer(bytes(b[192:208]), np.int8).astype(np.int64)
    d = _f16(b[208:210])
    y = np.zeros(256, f32)
    for n in range(2):
        o, L, H, S = 128 * n, ql[64 * n:], qh[32 * n:], sc[8 * n:]
        for l in range(32):
            i = l // 16
            q1 = ((L[l] & 0xF) | (((H[l] >> 0) & 3) << 4)) - 32
            q2 = ((L[l + 32] & 0xF) | (((H[l] >> 2) & 3) << 4)) - 32
            q3 = ((L[l] >> 4) | (((H[l] >> 4) & 3) << 4)) - 32
            q4 = ((L[l + 32] >> 4) | (((H[l] >> 6) & 3) << 4)) - 32
            y[o + l] = d * f32(S[i]) * f32(q1)
            y[o + l + 32] = d * f32(S[i + 2]) * f32(q2)
            y[o + l + 64] = d * f32(S[i + 4]) * f32(q3)
            y[o + l + 96] = d * f32(S[i + 6]) * f32(q4)
    return y


def ggml_q5_0(b):
    d, qh, qs = _f16(b[0:2]), int.from_bytes(bytes(b[2:6]), "little"), b[6:22]
    y = np.zeros(32, f32)
    for j in range(16):
        xh_0 = ((qh >> j) << 4) & 0x10
        xh_1 = (qh >> (j + 12)) & 0x10
        y[j] = f32(((qs[j] & 0x0F) | xh_0) - 16) * d
        y[j + 16] = f32(((qs[j] >> 4) | xh_1) - 16) * d
    return y


def ggml_q8_0(b):
    return _f16(b[0:2]) * np.frombuffer(bytes(b[2:34]), np.int8).astype(f32)


GGML = {Q4_K: (ggml_q4_k, 144), Q5_K: (ggml_q5_k, 176), Q6_K: (ggml_q6_k, 210),
        Q5_0: (ggml_q5_0, 22), Q8_0: (ggml_q8_0, 34)}


@pytest.mark.parametrize("t", [Q4_K, Q5_K, Q6_K, Q5_0, Q8_0])
def test_random_bytes_match_ggml(t):
    fn, nb = GGML[t]
    rng = np.random.default_rng(t)
    raw = rng.integers(0, 256, (6, nb), dtype=np.uint8)
    raw[:, [0, 1]] = np.frombuffer(np.float16([0.125, -0.5, 3.0, 1e-4, 0.0, 2.5]).tobytes(),
                                   np.uint8).reshape(6, 2)
    if t == Q6_K:  # its d is last
        raw[:, [208, 209]] = raw[:, [0, 1]]
    got = DEQUANT[t](torch.from_numpy(raw)).numpy()
    want = np.stack([fn(r.tolist()) for r in raw])
    assert np.array_equal(got, want)


def test_hand_made_blocks():
    # Q8_0: d = 0.5 and q = -16..15
    b = np.frombuffer(np.float16(0.5).tobytes(), np.uint8).tolist() + \
        [int(v) & 0xFF for v in range(-16, 16)]
    assert np.array_equal(DEQUANT[Q8_0](torch.tensor([b], dtype=torch.uint8))[0].numpy(),
                          np.arange(-16, 16, dtype=f32) * 0.5)
    # Q5_0: d = 0.25, every nibble 0x21 (element j: 1, j + 16: 2), fifth
    # bits set for the odd elements (qh 0xAAAAAAAA)
    b = np.frombuffer(np.float16(0.25).tobytes(), np.uint8).tolist() + [0xAA] * 4 + [0x21] * 16
    q = np.array([1] * 16 + [2] * 16) + 16 * (np.arange(32) % 2)
    assert np.array_equal(DEQUANT[Q5_0](torch.tensor([b], dtype=torch.uint8))[0].numpy(),
                          (q - 16).astype(f32) * f32(0.25))
    # Q4_K: d = 1, dmin = 0.5, sub-block j has sc = j + 1 and m = 2 j; every
    # nibble holds 3 in its low half and 5 in its high half
    sc, m = list(range(1, 9)), [2 * j for j in range(8)]
    s = [0] * 12
    for j in range(4):
        s[j] = sc[j] | ((sc[j + 4] >> 4) << 6)
        s[j + 4] = m[j] | ((m[j + 4] >> 4) << 6)
        s[j + 8] = (sc[j + 4] & 15) | ((m[j + 4] & 15) << 4)
    b = (np.frombuffer(np.float16([1.0, 0.5]).tobytes(), np.uint8).tolist() + s
         + [0x53] * 128)
    y = DEQUANT[Q4_K](torch.tensor([b], dtype=torch.uint8))[0].numpy().reshape(8, 32)
    for j in range(8):
        q = 3 if j % 2 == 0 else 5
        assert np.all(y[j] == f32((j + 1) * q - 0.5 * 2 * j))


@pytest.mark.parametrize("t", [Q4_K, Q5_K, Q6_K, Q5_0, Q8_0])
def test_generated_weights_are_centred(t):
    _, nb = GGML[t]
    raw = make_blocks(11, "w", t, (64, 512), "cpu")
    w = DEQUANT[t](raw.reshape(-1, nb))
    rms = float(w.square().mean().sqrt())
    assert 0.7 * WEIGHT_RMS < rms < 1.3 * WEIGHT_RMS
    assert abs(float(w.mean())) < 0.03 * rms
    assert torch.equal(raw, make_blocks(11, "w", t, (64, 512), "cpu"))
    assert not torch.equal(raw, make_blocks(12, "w", t, (64, 512), "cpu"))


def test_program_decodes_the_same_weights():
    """The port's numpy dequantizer reads the generated blocks as the
    reference does (the loader's other route, a cross-check)."""
    from prima_tpu_torch.gguf.constants import GGMLType
    from prima_tpu_torch.gguf.reader import TensorInfo
    from prima_tpu_torch.quant.dequant_np import dequantize_tensor

    for t, nb in ((Q4_K, 144), (Q5_K, 176), (Q6_K, 210), (Q5_0, 22), (Q8_0, 34)):
        raw = make_blocks(3, "x", t, (8, 512), "cpu")
        ti = TensorInfo("x", (512, 8), GGMLType(t), 0, raw.numpy())
        assert np.array_equal(dequantize_tensor(ti).reshape(8, 512),
                              DEQUANT[t](raw.reshape(-1, nb)).reshape(8, 512).numpy())


def test_dense_kinds():
    n = make_dense(1, "n", "norm", (1000,), "cpu")
    assert float(n.min()) >= 0.8 and float(n.max()) <= 1.2
    r = make_dense(1, "r", "router", (8, 1000), "cpu")
    assert 0.015 < float(r.std()) < 0.025
