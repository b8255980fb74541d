"""RWKV-v6 ("Finch"), the recurrent linear-attention family.

Counterpart of prima_tpu/models/rwkv6.py on one device (CUDA unless the
caller asks for the CPU). The LLM_ARCH_RWKV6 analogue (build_rwkv6
src/llama.cpp:16617, llm_build_rwkv6_time_mix @10371,
llm_build_rwkv6_channel_mix @10514, and the WKV recurrence
ggml_compute_forward_rwkv_wkv_f32 ggml/src/ggml.c:16595). Per layer:

  time-mix   token-shift lerp with data-dependent 5-way LoRA mixes
             (w1/w2), per-token decay w = exp(-exp(lora(xw)+decay)),
             per-head WKV state recurrence
               out_t = r_t @ (u * (k_t v_t^T) + S);  S = diag(w_t) S + k_t v_t^T
             then per-head LayerNorm (group norm, eps 64e-5), affine
             time_mix_ln, silu-gate, output projection.
  channel-mix token-shift lerp; out = sigmoid(r) * (relu(k)^2 @ Wv^T).

Every projection runs over the whole sequence at once; only the (H, N, N)
state update is a loop over tokens. The hidden state replaces the KV
cache: decode carries (att_shift, ffn_shift, wkv) per layer and never
recomputes the prefix. As in the JAX package the weights are dequantized
on the host and held dense.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFModel
from ..ops.layers import mm_t
from .family import dense_getter, open_runtime, tokens_tensor


@dataclass
class Rwkv6Config:
    arch: str
    n_layers: int
    n_embd: int
    head_size: int
    n_ff: int
    n_vocab: int
    ln_eps: float
    rescale_every: int
    time_mix_extra_dim: int
    time_decay_extra_dim: int

    @property
    def n_heads(self) -> int:
        return self.n_embd // self.head_size

    @classmethod
    def from_gguf(cls, m: GGUFModel) -> "Rwkv6Config":
        assert m.arch == "rwkv6", m.arch
        g = m.arch_key
        tokens = m.get("tokenizer.ggml.tokens")
        return cls(
            arch=m.arch,
            n_layers=int(g("{arch}.block_count")),
            n_embd=int(g("{arch}.embedding_length")),
            head_size=int(g("{arch}.wkv.head_size")),
            n_ff=int(g("{arch}.feed_forward_length")),
            n_vocab=int(g("{arch}.vocab_size", len(tokens) if tokens is not None else 0)),
            ln_eps=float(g("{arch}.attention.layer_norm_epsilon", 1e-5)),
            rescale_every=int(g("{arch}.rescale_every_n_layers", 0) or 0),
            time_mix_extra_dim=int(g("{arch}.time_mix_extra_dim", 32)),
            time_decay_extra_dim=int(g("{arch}.time_decay_extra_dim", 64)),
        )


def load_rwkv6_params(m: GGUFModel, cfg: Rwkv6Config, dtype=torch.float32,
                      device=None) -> dict:
    """The reference loader's tensor table (LLM_ARCH_RWKV6). The lerp
    tensors, stored ne={n_embd,1,1}, are flattened to (e,)."""
    get = dense_getter(m, dtype, device)
    params: dict = {
        "tok_embd": get("token_embd.weight"),
        "tok_norm": get("token_embd_norm.weight", flat=True),
        "tok_norm_b": get("token_embd_norm.bias", flat=True),
        "output_norm": get("output_norm.weight", flat=True),
        "output_norm_b": get("output_norm.bias", flat=True),
        "output": get("output.weight"),
        "layers": [],
    }
    H, N = cfg.n_heads, cfg.head_size
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer = {
            "attn_norm": get(p + "attn_norm.weight", flat=True),
            "attn_norm_b": get(p + "attn_norm.bias", flat=True),
            "attn_norm_2": get(p + "attn_norm_2.weight", flat=True),
            "attn_norm_2_b": get(p + "attn_norm_2.bias", flat=True),
            "w1": get(p + "time_mix_w1.weight"),  # (5*tmx, e)
            "w2": get(p + "time_mix_w2.weight"),  # (5, e, tmx)
            "first": get(p + "time_mix_first.weight").reshape(H, N),
            "decay": get(p + "time_mix_decay.weight", flat=True),
            "decay_w1": get(p + "time_mix_decay_w1.weight"),  # (tdx, e)
            "decay_w2": get(p + "time_mix_decay_w2.weight"),  # (e, tdx)
            "key": get(p + "time_mix_key.weight"),
            "value": get(p + "time_mix_value.weight"),
            "receptance": get(p + "time_mix_receptance.weight"),
            "gate": get(p + "time_mix_gate.weight"),
            "ln": get(p + "time_mix_ln.weight", flat=True),
            "ln_b": get(p + "time_mix_ln.bias", flat=True),
            "out": get(p + "time_mix_output.weight"),
            "cm_key": get(p + "channel_mix_key.weight"),
            "cm_value": get(p + "channel_mix_value.weight"),
            "cm_receptance": get(p + "channel_mix_receptance.weight"),
        }
        for nm, key in (("time_mix_lerp_x", "lerp_x"), ("time_mix_lerp_w", "lerp_w"),
                        ("time_mix_lerp_k", "lerp_k"), ("time_mix_lerp_v", "lerp_v"),
                        ("time_mix_lerp_r", "lerp_r"), ("time_mix_lerp_g", "lerp_g"),
                        ("channel_mix_lerp_k", "cm_lerp_k"),
                        ("channel_mix_lerp_r", "cm_lerp_r")):
            layer[key] = get(p + nm + ".weight", flat=True)
        params["layers"].append(layer)
    return params


def init_rwkv6_state(cfg: Rwkv6Config, batch: int, dtype=torch.float32, device=None) -> list:
    """Per-layer recurrent state (the architecture's 'KV cache'): the
    att / ffn token-shift vectors and the (H, N, N) WKV state, the analogue
    of the reference's kv_self k_l (token shift) / v_l (wkv) reuse
    (build_rwkv6 @16641-16647)."""
    H, N = cfg.n_heads, cfg.head_size
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return [{"att_shift": z(batch, cfg.n_embd), "ffn_shift": z(batch, cfg.n_embd),
             "wkv": z(batch, H, N, N)} for _ in range(cfg.n_layers)]


def _ln(x, w, b, eps):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def _wkv_scan(r, k, v, w, u, state):
    """The WKV recurrence (ggml_compute_forward_rwkv_wkv_f32 semantics).

    r/k/v/w: (b, T, H, N); u: (H, N); state: (b, H, N, N) indexed
    [h, i(k-dim), j(v-dim)]. Returns out (b, T, H, N) and the final state."""
    outs = []
    s = state
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # each (b, H, N)
        kv = k_t[..., :, None] * v_t[..., None, :]  # (b, H, N, N)
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, u[None, :, :, None] * kv + s))
        s = s * w_t[..., :, None] + kv
    return torch.stack(outs, dim=1), s


def _time_mix(layer, cfg: Rwkv6Config, x, x_prev, wkv_state):
    """llm_build_rwkv6_time_mix (src/llama.cpp:10371-10512)."""
    b, T, e = x.shape
    H, N = cfg.n_heads, cfg.head_size
    sx = x_prev - x
    xxx = x + sx * layer["lerp_x"]
    z = torch.tanh(mm_t(xxx, layer["w1"]))  # (b, T, 5*tmx)
    z = z.reshape(b, T, 5, -1)
    w2 = layer["w2"]
    dt = torch.promote_types(z.dtype, w2.dtype)
    mixes = torch.einsum("btgx,gex->btge", z.to(dt), w2.to(dt))  # (b, T, 5, e)
    mw, mk, mv, mr, mg = (mixes[:, :, i] for i in range(5))
    xw = x + sx * (mw + layer["lerp_w"])
    xk = x + sx * (mk + layer["lerp_k"])
    xv = x + sx * (mv + layer["lerp_v"])
    xr = x + sx * (mr + layer["lerp_r"])
    xg = x + sx * (mg + layer["lerp_g"])

    r = mm_t(xr, layer["receptance"]).reshape(b, T, H, N)
    k = mm_t(xk, layer["key"]).reshape(b, T, H, N)
    v = mm_t(xv, layer["value"]).reshape(b, T, H, N)
    g = F.silu(mm_t(xg, layer["gate"]))  # (b, T, e)

    wraw = mm_t(torch.tanh(mm_t(xw, layer["decay_w1"])), layer["decay_w2"])
    wraw = wraw + layer["decay"]
    w = torch.exp(-torch.exp(wraw)).reshape(b, T, H, N)

    out, wkv_state = _wkv_scan(r, k, v, w, layer["first"], wkv_state)
    # per-head group norm, eps 64e-5 (@10500-10506), then affine over e
    of = out.float()
    mu = torch.mean(of, dim=-1, keepdim=True)
    var = torch.mean(torch.square(of - mu), dim=-1, keepdim=True)
    out = ((of - mu) * torch.rsqrt(var + float(np.float32(64e-5)))).reshape(b, T, e)
    out = out * layer["ln"] + layer["ln_b"]
    out = out.to(x.dtype) * g
    return mm_t(out, layer["out"]), wkv_state


def _channel_mix(layer, x, x_prev):
    """llm_build_rwkv6_channel_mix (src/llama.cpp:10514-10534)."""
    sx = x_prev - x
    xk = x + sx * layer["cm_lerp_k"]
    xr = x + sx * layer["cm_lerp_r"]
    r = torch.sigmoid(mm_t(xr, layer["cm_receptance"]))
    k = torch.square(torch.relu(mm_t(xk, layer["cm_key"])))
    return r * mm_t(k, layer["cm_value"])


def rwkv6_forward(params: dict, cfg: Rwkv6Config, tokens, state: list | None = None):
    """tokens (b, s) -> (logits (b, s, vocab), new_state).

    The sequence runs at once except the WKV scan; the token shift x_prev is
    the one-step-delayed normed stream, seeded from the carried shift state
    (build_rwkv6 @16652-16661)."""
    dev = params["tok_embd"].device
    tokens = tokens_tensor(tokens, dev)
    b = tokens.shape[0]
    if state is None:
        state = init_rwkv6_state(cfg, b, device=dev)
    new_state = []
    x = params["tok_embd"][tokens]
    x = _ln(x, params["tok_norm"], params["tok_norm_b"], cfg.ln_eps)
    for i, layer in enumerate(params["layers"]):
        st = state[i]
        xa = _ln(x, layer["attn_norm"], layer["attn_norm_b"], cfg.ln_eps)
        x_prev = _shifted(st["att_shift"], xa)
        tm, wkv = _time_mix(layer, cfg, xa, x_prev, st["wkv"])
        x = x + tm
        xf = _ln(x, layer["attn_norm_2"], layer["attn_norm_2_b"], cfg.ln_eps)
        x_prev = _shifted(st["ffn_shift"], xf)
        x = x + _channel_mix(layer, xf, x_prev)
        new_state.append({"att_shift": xa[:, -1], "ffn_shift": xf[:, -1], "wkv": wkv})
        if cfg.rescale_every and (i + 1) % cfg.rescale_every == 0:
            x = x.float() * 0.5  # build_rwkv6 @16703-16705; f32 as in JAX
    x = _ln(x, params["output_norm"], params["output_norm_b"], cfg.ln_eps)
    return mm_t(x, params["output"]), new_state


def _shifted(shift: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """[shift, xs[:, :-1]] along the sequence, promoted as jnp.concatenate
    promotes."""
    dt = torch.promote_types(shift.dtype, xs.dtype)
    return torch.cat([shift[:, None].to(dt), xs[:, :-1].to(dt)], dim=1)


class Rwkv6Runtime:
    """Stateful greedy decode: the recurrent state is the context, one
    forward a generated token, no prefix recompute."""

    def __init__(self, cfg: Rwkv6Config, params: dict, tokenizer=None, eog_ids=None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.eog_ids = eog_ids or set()

    @classmethod
    def load(cls, path: str, dtype=torch.float32, device=None) -> "Rwkv6Runtime":
        _, cfg, params, tok, eog = open_runtime(path, Rwkv6Config, load_rwkv6_params,
                                                dtype, device)
        return cls(cfg, params, tok, eog)

    def generate(self, prompt_tokens: list[int], n_predict: int = 32) -> list[int]:
        dev = self.params["tok_embd"].device
        out: list[int] = []
        with torch.no_grad():
            state = init_rwkv6_state(self.cfg, 1, device=dev)
            logits, state = rwkv6_forward(self.params, self.cfg, [list(prompt_tokens)], state)
            tok = int(torch.argmax(logits[0, -1]))
            for _ in range(n_predict):
                out.append(tok)
                if tok in self.eog_ids:
                    break
                logits, state = rwkv6_forward(self.params, self.cfg, [[tok]], state)
                tok = int(torch.argmax(logits[0, -1]))
        return out
