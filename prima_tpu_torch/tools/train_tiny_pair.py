"""Train a real tiny draft / target llama pair on local text.

Counterpart of prima_tpu/tools/train_tiny_pair.py. Two byte-level
llama-arch models (a target and a ~6x smaller draft) train on the same
local corpus (the Python stdlib's sources), then go through the port's
quantizer into GGUFs, so the speculative acceptance measured on them runs
the production path (loader -> Engine -> speculative decoding).

The training forward is built from the port's ops/layers primitives
(rms_norm, apply_rope, gqa_attention, swiglu, rope_freqs of the same
ModelConfig), so trained weights decode alike through models/llama.forward.
The JAX package has no custom_vjp: torch autograd is the whole port of its
backward pass. The optimizer is the JAX tool's optax chain written out:
the global-norm clip at 1.0 (clip_grad_norm_), AdamW with weight decay
0.01, and warmup_cosine_decay_schedule (0 -> lr over max(steps // 20, 10)
steps, cosine to 0.05 * lr at `steps`) in f32 as optax computes it.

One departure: the JAX tool draws its batch offsets from jax.random, which
the port cannot reproduce without JAX; it draws them from a torch.Generator
seeded by seed + 1. Training runs on the card unless --device cpu.

    python -m prima_tpu_torch.tools.train_tiny_pair --out-dir /tmp/pair --steps 1500

The default --out-dir, models_tiny_pair, overwrites the committed pair, as
the JAX tool's does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device

N_SPECIALS = 3  # <unk>, <s>, </s>: tools/make_tiny_gguf._byte_vocab
N_VOCAB = N_SPECIALS + 256
LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm", "w_gate", "w_up", "w_down")


def gather_corpus(max_bytes: int = 4 << 20, root: str | None = None) -> bytes:
    """Concatenate local Python sources (the stdlib by default): English
    prose (docstrings, comments) and code, no network needed."""
    import sysconfig

    root = root or sysconfig.get_paths()["stdlib"]
    chunks, total = [], 0
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        if "site-packages" in dirpath or "__pycache__" in dirpath:
            continue
        dirnames.sort()
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            try:
                with open(os.path.join(dirpath, fn), "rb") as f:
                    b = f.read()
            except OSError:
                continue
            chunks.append(b)
            total += len(b)
            if total >= max_bytes:
                return b"\n".join(chunks)[:max_bytes]
    return b"\n".join(chunks)[:max_bytes]


def encode_bytes(data: bytes) -> np.ndarray:
    """Byte-level SPM ids: token id = 3 + byte (make_tiny_gguf's byte vocab)."""
    return np.frombuffer(data, np.uint8).astype(np.int32) + N_SPECIALS


def make_cfg(n_layers, n_embd, n_heads, n_ff, n_ctx=512):
    from ..models.config import tiny_config

    return tiny_config(n_layers=n_layers, n_embd=n_embd, n_heads=n_heads,
                       n_kv_heads=n_heads, head_dim=n_embd // n_heads, n_ff=n_ff,
                       n_vocab=N_VOCAB, n_ctx_train=n_ctx, rope_base=10000.0,
                       rope_dim=n_embd // n_heads)


def init_params(cfg, seed: int) -> dict:
    """f32 training params (CPU tensors), the JAX tool's numpy draws, under
    the tensor names / shapes the GGUF will carry."""
    rng = np.random.default_rng(seed)
    e, hd, f = cfg.n_embd, cfg.head_dim, cfg.n_ff

    def w(rows, k):
        return (rng.standard_normal((rows, k)) * (k ** -0.5)).astype(np.float32)

    p = {"tok_embd": (rng.standard_normal((cfg.n_vocab, e)) * 0.02).astype(np.float32),
         "output": (rng.standard_normal((cfg.n_vocab, e)) * 0.02).astype(np.float32),
         "output_norm": np.ones(e, np.float32), "layers": []}
    for _ in range(cfg.n_layers):
        p["layers"].append({
            "attn_norm": np.ones(e, np.float32), "wq": w(cfg.n_heads * hd, e),
            "wk": w(cfg.n_kv_heads * hd, e), "wv": w(cfg.n_kv_heads * hd, e),
            "wo": w(e, cfg.n_heads * hd), "ffn_norm": np.ones(e, np.float32),
            "w_gate": w(f, e), "w_up": w(f, e), "w_down": w(e, f)})
    return _map(p, torch.from_numpy)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def leaves(params: dict) -> list[torch.Tensor]:
    """The params in a fixed order (the head, then layer by layer)."""
    out = [params["tok_embd"], params["output"], params["output_norm"]]
    for layer in params["layers"]:
        out += [layer[k] for k in LAYER_KEYS]
    return out


def train_forward(params: dict, cfg, tokens: torch.Tensor, inv_freq: torch.Tensor):
    """Teacher-forcing forward over (B, T) token ids -> (B, T, V) logits,
    differentiable; the math of models/llama.forward."""
    from ..ops.layers import apply_rope, causal_mask, gqa_attention, rms_norm, swiglu

    B, T = tokens.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = torch.arange(T, dtype=torch.int32, device=tokens.device)[None].expand(B, T)
    mask = causal_mask(pos, T)
    x = params["tok_embd"][tokens]
    scale = hd ** -0.5
    for layer in params["layers"]:
        xa = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q = (xa @ layer["wq"].T).reshape(B, T, h, hd)
        k = (xa @ layer["wk"].T).reshape(B, T, kvh, hd)
        v = (xa @ layer["wv"].T).reshape(B, T, kvh, hd)
        q = apply_rope(q, pos, inv_freq, cfg.rope_type)
        k = apply_rope(k, pos, inv_freq, cfg.rope_type)
        att = gqa_attention(q, k, v, mask, scale)
        x = x + att.reshape(B, T, h * hd) @ layer["wo"].T
        xf = rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
        x = x + swiglu(xf @ layer["w_gate"].T, xf @ layer["w_up"].T) @ layer["w_down"].T
    x = rms_norm(x, params["output_norm"], cfg.rms_eps)
    return x @ params["output"].T


def loss_fn(params: dict, cfg, toks: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL over (B, T + 1) windows."""
    logits = train_forward(params, cfg, toks[:, :-1], inv_freq)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, toks[:, 1:, None].long()).mean()


def lr_schedule(step: int, lr: float, steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, max(steps // 20, 10),
    steps, 0.05 * lr) at `step`, in f32 as optax computes it: a linear ramp
    from 0, then (1 - alpha) * 0.5 * (1 + cos(pi k / D)) + alpha times lr."""
    f32 = np.float32
    warm = max(steps // 20, 10)
    if step < warm:
        frac = f32(1) - f32(min(max(step, 0), warm)) / f32(warm)
        return float(f32(0.0 - lr) * frac + f32(lr))
    alpha = f32(lr * 0.05 / lr)
    decay = float(steps - warm)
    count = np.minimum(f32(step - warm), f32(decay))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * count / f32(decay)))
    return float(f32(lr) * ((f32(1) - alpha) * cosine + alpha))


class Trainer:
    """The clip + AdamW step of the JAX tool's optax chain on `params`
    (leaf tensors that require grad)."""

    def __init__(self, params: dict, cfg, lr: float, steps: int, device):
        from ..ops.layers import rope_freqs

        self.params, self.cfg, self.lr, self.steps = params, cfg, lr, steps
        self.inv_freq, _ = rope_freqs(cfg, device)
        self.opt = torch.optim.AdamW(leaves(params), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=0.01)
        self.step_i = 0

    def step(self, toks: torch.Tensor) -> float:
        loss = loss_fn(self.params, self.cfg, toks, self.inv_freq)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(leaves(self.params), 1.0)
        for g in self.opt.param_groups:
            g["lr"] = lr_schedule(self.step_i, self.lr, self.steps)
        self.opt.step()
        self.step_i += 1
        return loss.detach()


def train(cfg, data: np.ndarray, seed: int = 0, steps: int = 1500, batch: int = 8,
          seq: int = 128, lr: float = 3e-3, chunk: int = 25, device=None, log=print):
    """AdamW + the cosine schedule over batches of `seq + 1` tokens at
    offsets drawn from a generator seeded by seed + 1; the mean loss of
    every `chunk` steps is logged (one host read a chunk)."""
    device = resolve_device(device)
    params = _map(init_params(cfg, seed),
                  lambda t: t.to(device).requires_grad_(True))
    n_hold = max(4 * batch * seq, 16384)
    train_ids = torch.from_numpy(data[:-n_hold].astype(np.int64)).to(device)
    tr = Trainer(params, cfg, lr, steps, device)
    gen = torch.Generator().manual_seed(seed + 1)
    n = train_ids.shape[0] - seq - 1
    window = torch.arange(seq + 1, device=device)
    t0 = time.time()
    hist = []
    for i in range(0, steps, chunk):
        losses = []
        for _ in range(min(chunk, steps - i)):
            off = torch.randint(0, n, (batch,), generator=gen).to(device)
            losses.append(tr.step(train_ids[off[:, None] + window]))
        mean_l = float(torch.stack(losses).mean())
        hist.append(round(mean_l, 4))
        log(f"step {min(i + chunk, steps):5d}/{steps}  loss {mean_l:.4f}  "
            f"({time.time() - t0:.0f}s)")
    hold = torch.from_numpy(data[-n_hold:].astype(np.int64)).to(device)
    b_ev = max(n_hold // (seq + 1) // 4, 1)
    with torch.no_grad():
        ev_loss = float(loss_fn(params, cfg, hold[: b_ev * (seq + 1)].reshape(b_ev, seq + 1),
                                tr.inv_freq))
    return params, {"final_train_loss": hist[-1] if hist else None,
                    "holdout_loss": round(ev_loss, 4), "loss_history": hist[::4],
                    "train_s": round(time.time() - t0, 1)}


def save_gguf(path: str, cfg, params, name: str, ftype_name: str = "Q8_0"):
    """Write trained weights through the port's GGUF writer (byte vocab),
    quantized with the port's quantizer; the JAX tool's bytes."""
    from ..gguf.constants import GGMLType
    from ..gguf.writer import GGUFWriter
    from ..quant.quantize_np import quantize
    from .make_tiny_gguf import _byte_vocab

    ftype = GGMLType[ftype_name]
    params = _map(params, lambda t: t.detach().float().cpu().numpy()
                  if isinstance(t, torch.Tensor) else np.asarray(t))
    w = GGUFWriter(path, arch="llama")
    w.add_kv("general.name", name)
    w.add_kv("llama.block_count", cfg.n_layers)
    w.add_kv("llama.embedding_length", cfg.n_embd)
    w.add_kv("llama.attention.head_count", cfg.n_heads)
    w.add_kv("llama.attention.head_count_kv", cfg.n_kv_heads)
    w.add_kv("llama.feed_forward_length", cfg.n_ff)
    w.add_kv("llama.context_length", cfg.n_ctx_train)
    w.add_kv("llama.attention.layer_norm_rms_epsilon", cfg.rms_eps)
    w.add_kv("llama.rope.freq_base", cfg.rope_base)
    w.add_kv("llama.rope.dimension_count", cfg.rope_dim)
    for key, val in _byte_vocab().items():
        w.add_kv(key, val)
    w.add_kv("llama.vocab_size", cfg.n_vocab)

    def q(tname, x):
        x = np.ascontiguousarray(x, np.float32)
        if ftype == GGMLType.F32:
            w.add_tensor(tname, x)
            return
        w.add_tensor(tname, quantize(x, ftype), ne=(x.shape[1], x.shape[0]), ggml_type=ftype)

    def dense(tname, x):
        w.add_tensor(tname, np.ascontiguousarray(x, np.float32))

    q("token_embd.weight", params["tok_embd"])
    for i, layer in enumerate(params["layers"]):
        p = f"blk.{i}."
        dense(p + "attn_norm.weight", layer["attn_norm"])
        q(p + "attn_q.weight", layer["wq"])
        q(p + "attn_k.weight", layer["wk"])
        q(p + "attn_v.weight", layer["wv"])
        q(p + "attn_output.weight", layer["wo"])
        dense(p + "ffn_norm.weight", layer["ffn_norm"])
        q(p + "ffn_gate.weight", layer["w_gate"])
        q(p + "ffn_up.weight", layer["w_up"])
        q(p + "ffn_down.weight", layer["w_down"])
    dense("output_norm.weight", params["output_norm"])
    q("output.weight", params["output"])
    w.write()
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="models_tiny_pair")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--draft-steps", type=int, default=0, help="0 = same as --steps")
    ap.add_argument("--corpus-mb", type=float, default=4.0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ftype", default="Q8_0")
    ap.add_argument("--target-shape", default="4,256,4,704", help="layers,embd,heads,ff")
    ap.add_argument("--draft-shape", default="2,128,2,352")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    data = encode_bytes(gather_corpus(int(args.corpus_mb * (1 << 20))))
    print(f"corpus: {data.shape[0]/1e6:.2f}M tokens", flush=True)
    report = {"corpus_tokens": int(data.shape[0]), "backend": device.type, "models": {}}
    for role, shape_s, steps in (("target", args.target_shape, args.steps),
                                 ("draft", args.draft_shape, args.draft_steps or args.steps)):
        L, E, H, F = map(int, shape_s.split(","))
        cfg = make_cfg(L, E, H, F)
        n_par = sum(t.numel() for t in leaves(init_params(cfg, 0)))
        print(f"training {role}: {L}L/{E}e/{H}h/{F}f = {n_par/1e6:.2f}M params, "
              f"{steps} steps", flush=True)
        params, stats = train(cfg, data, seed=0, steps=steps, batch=args.batch, seq=args.seq,
                              device=device)
        path = os.path.join(args.out_dir, f"{role}.gguf")
        save_gguf(path, cfg, params, f"tiny-pair-{role}", args.ftype)
        stats.update({"params_m": round(n_par / 1e6, 3), "shape": [L, E, H, F], "gguf": path,
                      "file_mb": round(os.path.getsize(path) / 1e6, 2)})
        report["models"][role] = stats
        print(json.dumps({role: stats}), flush=True)
    with open(os.path.join(args.out_dir, "train_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
