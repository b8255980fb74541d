"""The metric arithmetic on hand-worked cases: tails and rates from event
times, block bytes, the GEMV launches' and the model's least times, the
device trace's busy union, its top operations and its labelled gaps."""

from types import SimpleNamespace

import pytest

from benchmark import measure
from benchmark.blocks import F32, Q4_K, Q5_K, Q6_K, Q8_0, row_bytes
from benchmark.layout import tensor_table
from benchmark.roofline import (PEAK_BYTES_PER_S, PEAK_FLOPS, ModelCost, device_ops,
                                gemv_weight_bytes, gemv_work, least_time, union_seconds)
from benchmark.serve import Profile, Recorder, Run, Served, Span, TimedQueue
from benchmark.traffic import Request

TINY = {"arch": "llama", "n_layers": 2, "n_embd": 256, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 64, "n_ff": 512, "n_vocab": 512}
ALL_Q4_K = {k: "Q4_K" for k in ("token_embd.weight", "output.weight", "attn_q.weight",
                                "attn_k.weight", "attn_v.weight", "attn_output.weight",
                                "ffn_gate.weight", "ffn_up.weight", "ffn_down.weight")}


def test_block_bytes():
    assert row_bytes(Q4_K, 256) == 144  # 144 B / 256 weights
    assert row_bytes(Q6_K, 256) == 210
    assert row_bytes(Q5_K, 512) == 352
    assert row_bytes(Q8_0, 32) == 34 and row_bytes(Q8_0, 256) == 272
    assert row_bytes(F32, 3) == 12
    with pytest.raises(ValueError):
        row_bytes(Q4_K, 100)


def test_gemv_launch_work():
    # 4 rows through a (128, 256) Q8_0 weight: 128 rows of 272 B, x and y in f32
    flops, nbytes = gemv_work(4, 128, 256, Q8_0)
    assert flops == 2 * 4 * 128 * 256
    assert nbytes == 128 * 272 + 4 * 4 * (128 + 256)
    # an indexed launch reads only its 3 distinct experts of 512 rows
    assert gemv_weight_bytes(512, 256, Q6_K, distinct=3) == 3 * 512 * 210
    assert least_time(1e12, 1e9) == pytest.approx(max(1e12 / PEAK_FLOPS, 1e9 / PEAK_BYTES_PER_S))


def test_model_least_times():
    cost = ModelCost(TINY, tensor_table(TINY, ALL_Q4_K))
    layer = 256 * 8 * 64 + 4 * 64 * 256 + 3 * 256 * 512  # q, k, v, o, gate, up, down
    assert layer == 589824 and cost.layer_flops == 2 * 2 * layer
    # one token at 10 visible cells with the head: 2 layers of matmuls and attention
    assert cost.token_flops(10, head=True) == 2 * (2 * layer + 4 * 64 * 4 * 10) + 2 * 256 * 512
    # Q4_K: q 36864, k / v 18432, o 36864, gate / up 73728, down 73728 (2 blocks a row)
    assert cost.weight_bytes == 2 * 331776
    assert cost.head_bytes == 512 * 144 and cost.embd_row_bytes == 144
    assert cost.kv_bytes_cell == 2 * 2 * 64 * 2 * 2
    # a 2-row chunk at positions 3, 4 on the dense route: every weight once
    flops = cost.token_flops(4, False) + cost.token_flops(5, False)
    nbytes = 663552 + 2 * 144 + 5 * 1024
    assert cost.prefill_chunk(2, 3, None) == pytest.approx(least_time(flops, nbytes))
    assert cost.prefill_chunk(2, 3, None) == pytest.approx(nbytes / PEAK_BYTES_PER_S)
    # one decode step of rows at 4 and 7 visible cells, head included
    flops = cost.token_flops(4, True) + cost.token_flops(7, True)
    nbytes = 663552 + 73728 + 11 * 1024 + 2 * 144
    assert cost.decode_steps([4, 7], 1, None) == pytest.approx(least_time(flops, nbytes))
    # the same step from its launches' bytes
    assert cost.decode_steps([4, 7], 1, 1000.0) == pytest.approx(
        least_time(flops, 1000.0 + 11 * 1024 + 2 * 144))


def test_moe_params_count_the_experts_used():
    moe = dict(TINY, n_expert=4, n_expert_used=2)
    types = dict(ALL_Q4_K, **{k: "Q4_K" for k in ("ffn_gate_exps.weight", "ffn_up_exps.weight",
                                                  "ffn_down_exps.weight")})
    cost = ModelCost(moe, tensor_table(moe, types))
    assert cost.layer_flops == 2 * 2 * (256 * 8 * 64 + 4 * 64 * 256 + 2 * 3 * 256 * 512 + 256 * 4)
    # every expert's weights in the whole-model bytes
    assert cost.weight_bytes == 2 * (36864 + 2 * 18432 + 36864 + 4 * 3 * 73728)


def _served(index, due, stamps, n_out, in_window, done="length"):
    q = TimedQueue()
    q.stamps = [(t, SimpleNamespace(token=1)) for t in stamps]
    gen = SimpleNamespace(events=q, done_reason=done, tokens_out=[1] * len(stamps),
                          request_id=index)
    return Served(Request(index, due, [1], n_out, False, 0, in_window), gen, due)


def _run():
    run = Run({}, {}, 10.0, None, 0.0, t0=5.0, w0=10.0, w1=20.0, t_end=30.0)
    run.served = [_served(0, 9.0, [9.5, 10.1], 2, False),
                  _served(1, 10.0, [10.5, 11.0, 11.5], 3, True),
                  _served(2, 12.0, [13.0, 13.2], 2, True),
                  _served(3, 15.0, [16.0], 4, True, done=None)]
    return run


def test_end_to_end_readings_hand_worked():
    run = _run()
    # first tokens 0.5 s and 1.0 s after due; the unfinished one waited to 30 s
    assert measure.window_p90_ms(run, measure.ttft_s) == pytest.approx(
        1e3 * (1.0 + 0.8 * (15.0 - 1.0)))
    # per-token gaps 0.5 s and 0.2 s; the unfinished one 15 s
    assert measure.window_p90_ms(run, measure.tpot_s) == pytest.approx(
        1e3 * (0.5 + 0.8 * (15.0 - 0.5)))
    # gaps of the window's requests 0.5, 0.5, 0.2, and the unfinished one's 30 - 16
    assert measure.itl_mean_ms(run) == pytest.approx(1e3 * (0.5 + 0.5 + 0.2 + 14.0) / 4)
    # events inside [10, 20): 1 + 3 + 2 + 1 of every request, over 10 s
    assert measure.output_tok_s(run) == pytest.approx(0.7)
    assert run.setup_s == 5.0


def test_device_trace_reduction():
    total, merged = union_seconds([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)])
    assert total == pytest.approx(3.0) and merged == [[0.0, 2.0], [3.0, 4.0]]
    ops = device_ops([("void qgemv_mma_kernel<4>", 0.0, 0.5),
                      ("qgemv_mma_indexed_kernel", 1.0, 1.25), ("elementwise", 2.0, 2.75)])
    assert ops == [["elementwise", 0.75], ["qgemv", 0.5], ["qgemv_indexed", 0.25]]


def test_idle_share_and_labelled_gaps():
    run = _run()
    run.rec = Recorder()
    run.rec.spans = [Span("decode call", 100.0, 101.0), Span("decode issue", 100.1, 100.3),
                     Span("read-back", 100.3, 100.9), Span("emit", 101.2, 101.4)]
    # busy 100.0-100.2 and 100.5-100.6; a gap goes to the innermost span
    # at its middle: 100.2-100.5 to read-back, 100.6-102.0 (middle 101.3) to emit
    run.rec.profile = Profile(100.0, 102.0, [("a", 100.0, 100.2), ("b", 100.5, 100.6)])
    assert measure.idle_share(run) == pytest.approx(100.0 * (1 - 0.3 / 2.0))
    bd = measure.breakdown(run)
    assert dict(bd["idle_gaps"]) == pytest.approx({"read-back": 0.3, "emit": 1.4})
    assert dict(bd["device_ops"]) == pytest.approx({"a": 0.2, "b": 0.1})
    run.rec.profile = Profile(100.0, 102.0, [])
    assert measure.idle_share(run) is None
