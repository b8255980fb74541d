"""The port's train_tiny_pair against the JAX tool: the same init draws, the
loss and every gradient at init against jax.value_and_grad (1e-5
relative), the schedule's rates against optax at every step, three clip +
AdamW steps on fixed batches against optax (params within 1e-6), and
save_gguf's bytes; then the tool's main on the CPU into a scratch
directory, whose target loads through the port's loader and runs a
forward."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prima_tpu.ops.layers import rope_freqs as jrope_freqs
from prima_tpu.tools import train_tiny_pair as jtool
from prima_tpu_torch.ops.layers import rope_freqs
from prima_tpu_torch.tools import train_tiny_pair as tool

SHAPE = (2, 64, 2, 96)


def jparams_of(cfg, seed):
    return jax.tree.map(jnp.asarray, jtool.init_params(cfg, seed))


def as_np(p):
    return tool._map(p, lambda t: t.detach().numpy())


def batches(n, b=3, t=17, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, tool.N_VOCAB, size=(b, t + 1)).astype(np.int32) for _ in range(n)]


def jloss(cfg, inv):
    def f(p, toks):
        logits = jtool.train_forward(p, cfg, toks[:, :-1], inv)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(lp, toks[:, 1:, None], axis=-1).mean()
    return f


def test_corpus_and_init_draws():
    assert tool.gather_corpus(1 << 14) == jtool.gather_corpus(1 << 14)
    ids = tool.encode_bytes(b"hello")
    assert np.array_equal(ids, jtool.encode_bytes(b"hello"))
    cfg = tool.make_cfg(*SHAPE)
    got, want = as_np(tool.init_params(cfg, 3)), jtool.init_params(jtool.make_cfg(*SHAPE), 3)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


def test_loss_and_grads_at_init():
    cfg, jcfg = tool.make_cfg(*SHAPE), jtool.make_cfg(*SHAPE)
    toks = batches(1)[0]
    jp = jparams_of(jcfg, 1)
    jl, jg = jax.value_and_grad(jloss(jcfg, jrope_freqs(jcfg)[0]))(jp, jnp.asarray(toks))
    p = tool._map(tool.init_params(cfg, 1), lambda t: t.requires_grad_(True))
    loss = tool.loss_fn(p, cfg, torch.from_numpy(toks.astype(np.int64)), rope_freqs(cfg)[0])
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    got = [t.grad.numpy() for t in tool.leaves(p)]
    want = [np.asarray(jg[k]) for k in ("tok_embd", "output", "output_norm")]
    for layer in jg["layers"]:
        want += [np.asarray(layer[k]) for k in tool.LAYER_KEYS]
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12


@pytest.mark.parametrize("steps", [30, 100, 1500])
def test_schedule_equals_optax(steps):
    """Equal over the warmup; over the cosine within f32 rounding (numpy's
    f32 cos and XLA's differ by an ulp or two)."""
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, max(steps // 20, 10), steps,
                                               3e-3 * 0.05)
    for i in range(steps + 5):
        got, want = tool.lr_schedule(i, 3e-3, steps), float(sched(jnp.int32(i)))
        if i < max(steps // 20, 10):
            assert got == want, i
        else:
            assert abs(got - want) <= 1e-6 * want, i


def test_three_optimizer_steps_equal_optax():
    """steps=12 puts every step of the warmup at a nonzero rate after the
    first (whose rate is 0)."""
    cfg, jcfg = tool.make_cfg(*SHAPE), jtool.make_cfg(*SHAPE)
    lr, steps = 3e-2, 12
    data = batches(3, seed=4)
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, max(steps // 20, 10), steps, lr * 0.05)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=0.01))
    jp = jparams_of(jcfg, 2)
    state = opt.init(jp)
    vg = jax.value_and_grad(jloss(jcfg, jrope_freqs(jcfg)[0]))
    p = tool._map(tool.init_params(cfg, 2), lambda t: t.requires_grad_(True))
    tr = tool.Trainer(p, cfg, lr, steps, "cpu")
    for toks in data:
        _, g = vg(jp, jnp.asarray(toks))
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        tr.step(torch.from_numpy(toks.astype(np.int64)))
    got = [t.detach().numpy() for t in tool.leaves(p)]
    want = [np.asarray(jp[k]) for k in ("tok_embd", "output", "output_norm")]
    for layer in jp["layers"]:
        want += [np.asarray(layer[k]) for k in tool.LAYER_KEYS]
    moved = max(np.abs(w - i).max() for w, i in zip(want, jax.tree.leaves(
        [jtool.init_params(jcfg, 2)[k] for k in ("tok_embd", "output", "output_norm")])))
    assert moved > 1e-4  # the steps did move the params
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-6


@pytest.mark.parametrize("ftype", ["Q8_0", "F32"])
def test_save_gguf_writes_the_jax_bytes(tmp_path, ftype):
    cfg, jcfg = tool.make_cfg(*SHAPE), jtool.make_cfg(*SHAPE)
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    tool.save_gguf(a, cfg, tool.init_params(cfg, 5), "t", ftype)
    jtool.save_gguf(b, jcfg, jtool.init_params(jcfg, 5), "t", ftype)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_main_trains_and_the_gguf_decodes(tmp_path, capsys):
    from prima_tpu_torch.models.llama import ForwardOptions, forward, init_kv_caches
    from prima_tpu_torch.models.loader import load_model

    out = tmp_path / "pair"
    assert tool.main(["--out-dir", str(out), "--steps", "3", "--corpus-mb", "0.1",
                      "--batch", "2", "--seq", "16", "--ftype", "F32", "--device", "cpu",
                      "--target-shape", "1,64,2,96", "--draft-shape", "1,32,2,64"]) == 0
    assert sorted(os.listdir(out)) == ["draft.gguf", "target.gguf", "train_report.json"]
    m = load_model(str(out / "target.gguf"), device="cpu", dtype=torch.float32)
    assert m.cfg.n_layers == 1 and m.cfg.n_vocab == tool.N_VOCAB
    toks = torch.tensor([[5, 99, 200, 31, 77, 4, 250, 12]])
    logits, _ = forward(m.params, m.cfg, toks, torch.arange(8)[None],
                        init_kv_caches(m.cfg, 1, 16, torch.float32),
                        torch.zeros(1, dtype=torch.int32),
                        ForwardOptions(matmul_impl="plain", dtype=torch.float32))
    assert torch.isfinite(logits).all() and logits.shape == (1, 8, tool.N_VOCAB)
    assert '"backend": "cpu"' in capsys.readouterr().out
