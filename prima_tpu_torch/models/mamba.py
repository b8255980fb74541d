"""Mamba (selective state-space) models.

Counterpart of prima_tpu/models/mamba.py on one device (CUDA unless the
caller asks for the CPU). The LLM_ARCH_MAMBA analogue (reference
llm_build_mamba src/llama.cpp:10236, ggml_ssm_conv / ggml_ssm_scan
ggml.c:16236): token embedding -> [RMSNorm -> in_proj -> causal depthwise
conv1d -> SiLU -> x_proj -> (softplus dt, B, C) -> selective scan -> +D*x
-> *SiLU(z) -> out_proj] residual blocks -> RMSNorm -> lm_head.

GGUF schema: `mamba.ssm.{conv_kernel,inner_size,state_size,time_step_rank}`
KVs and blk.N.ssm_{in,conv1d,x,dt,a,d,out} tensors, with ssm_a storing
-exp(A_log). The recurrent state replaces the KV cache: per sequence a
(d_inner, d_conv-1) conv window and a (d_inner, d_state) ssm state.

As in the JAX package every weight is dequantized on the host and held
dense; the matmuls are `torch.matmul`. The causal conv is the reference's
sum of d_conv shifted products (no cuDNN convolution, which would take
TF32 on the card), and the scan is a loop over tokens.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFModel
from ..ops.layers import mm_t, rms_norm
from .family import dense_getter, open_runtime, tokens_tensor


@dataclass
class MambaConfig:
    arch: str
    n_layers: int
    n_embd: int
    d_inner: int
    d_conv: int
    d_state: int
    dt_rank: int
    n_vocab: int
    n_ctx_train: int
    rms_eps: float
    dt_b_c_rms: bool = False  # falcon-mamba: RMS-normalize dt/B/C

    @classmethod
    def from_gguf(cls, m: GGUFModel) -> "MambaConfig":
        g = m.arch_key
        tokens = m.get("tokenizer.ggml.tokens")
        return cls(
            arch=m.arch,
            n_layers=int(g("{arch}.block_count")),
            n_embd=int(g("{arch}.embedding_length")),
            d_inner=int(g("{arch}.ssm.inner_size")),
            d_conv=int(g("{arch}.ssm.conv_kernel")),
            d_state=int(g("{arch}.ssm.state_size")),
            dt_rank=int(g("{arch}.ssm.time_step_rank")),
            n_vocab=int(g("{arch}.vocab_size", len(tokens) if tokens is not None else 0)),
            n_ctx_train=int(g("{arch}.context_length", 4096)),
            rms_eps=float(g("{arch}.attention.layer_norm_rms_epsilon", 1e-5)),
            dt_b_c_rms=bool(g("{arch}.ssm.dt_b_c_rms", False)),
        )


def load_mamba_params(m: GGUFModel, cfg: MambaConfig, dtype=torch.float32,
                      device=None) -> dict:
    get = dense_getter(m, dtype, device)
    params: dict = {"tok_embd": get("token_embd.weight"), "layers": []}
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        params["layers"].append({
            "norm": get(p + "attn_norm.weight"),
            "ssm_in": get(p + "ssm_in.weight"),       # (2*d_inner, n_embd)
            "conv_w": get(p + "ssm_conv1d.weight"),   # (d_inner, d_conv)
            "conv_b": get(p + "ssm_conv1d.bias"),
            "ssm_x": get(p + "ssm_x.weight"),         # (dt_rank+2ds, d_inner)
            "dt_w": get(p + "ssm_dt.weight"),         # (d_inner, dt_rank)
            "dt_b": get(p + "ssm_dt.bias"),
            "A": get(p + "ssm_a"),                    # (d_inner, d_state) = -exp(A_log)
            "D": get(p + "ssm_d"),
            "out": get(p + "ssm_out.weight"),         # (n_embd, d_inner)
        })
    params["output_norm"] = get("output_norm.weight")
    params["output"] = get("output.weight", required=False)
    return params


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # the reference's guarded softplus (ggml.c:16236)
    return torch.where(x <= 20.0, torch.log1p(torch.exp(torch.clamp(x, max=20.0))), x)


def init_mamba_state(cfg: MambaConfig, batch: int, device=None) -> list:
    """Per-layer (conv_state (b, d_inner, d_conv-1), ssm_state
    (b, d_inner, d_state)) in f32: the recurrent analogue of the KV cache."""
    return [
        (torch.zeros((batch, cfg.d_inner, cfg.d_conv - 1), dtype=torch.float32, device=device),
         torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=torch.float32, device=device))
        for _ in range(cfg.n_layers)
    ]


def _mamba_block(layer: dict, cfg: MambaConfig, h: torch.Tensor, state):
    """One mamba mixer over a full (b, s, e) chunk, carrying state."""
    s = h.shape[1]
    conv_state, ssm_state = state
    din, ds, dtr = cfg.d_inner, cfg.d_state, cfg.dt_rank

    xz = mm_t(h, layer["ssm_in"])  # (b, s, 2*d_inner)
    x, z = xz[..., :din], xz[..., din:]

    # causal depthwise conv along s with carried left context: the
    # reference's sum of d_conv shifted products, in this order
    xt = x.transpose(1, 2)  # (b, d_inner, s)
    dt_full = torch.promote_types(conv_state.dtype, xt.dtype)
    full = torch.cat([conv_state.to(dt_full), xt.to(dt_full)], dim=-1)
    new_conv = full[..., full.shape[-1] - (cfg.d_conv - 1):]
    k = layer["conv_w"]  # (d_inner, d_conv)
    x = 0
    for i in range(cfg.d_conv):
        x = x + full[..., i:i + s] * k[:, i][None, :, None]
    x = x + layer["conv_b"][None, :, None]
    x = F.silu(x).transpose(1, 2)  # (b, s, d_inner)

    dbc = mm_t(x, layer["ssm_x"])  # (b, s, dt_rank + 2*d_state)
    dt, B, C = dbc[..., :dtr], dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:]
    if cfg.dt_b_c_rms:  # falcon-mamba
        def norm(v):
            return v * torch.rsqrt(torch.mean(v * v, dim=-1, keepdim=True) + cfg.rms_eps)
        dt, B, C = norm(dt), norm(B), norm(C)
    dt = _softplus(mm_t(dt, layer["dt_w"]) + layer["dt_b"])  # (b, s, d_inner)

    A = layer["A"]  # (d_inner, d_state), negative
    dA = torch.exp(dt[..., None] * A)  # (b, s, d_inner, d_state)
    dBx = dt[..., None] * B[:, :, None, :] * x[..., None]

    hs = ssm_state
    ys = []
    for t in range(s):  # the lax.scan, one token a step
        hs = hs * dA[:, t] + dBx[:, t]  # (b, d_inner, d_state)
        ys.append(torch.einsum("bds,bs->bd", hs, C[:, t]))
    y = torch.stack(ys, dim=1)  # (b, s, d_inner)
    y = y + x * layer["D"]
    y = y * F.silu(z)
    return mm_t(y, layer["out"]), (new_conv, hs)


def mamba_forward(params: dict, cfg: MambaConfig, tokens, states=None):
    """tokens (b, s) -> (logits (b, s, vocab), new per-layer states)."""
    dev = params["tok_embd"].device
    tokens = tokens_tensor(tokens, dev)
    if states is None:
        states = init_mamba_state(cfg, tokens.shape[0], dev)
    h = params["tok_embd"][tokens]
    new_states = []
    for layer, st in zip(params["layers"], states):
        hin = rms_norm(h, layer["norm"], cfg.rms_eps)
        out, st2 = _mamba_block(layer, cfg, hin, st)
        h = h + out
        new_states.append(st2)
    h = rms_norm(h, params["output_norm"], cfg.rms_eps)
    w_out = params["output"] if params["output"] is not None else params["tok_embd"]
    return mm_t(h, w_out), new_states


class MambaRuntime:
    """Load + generate for mamba GGUFs (stateful decode, no KV cache)."""

    def __init__(self, cfg: MambaConfig, params: dict, tokenizer=None, eog_ids=None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.eog_ids = eog_ids or set()

    @classmethod
    def load(cls, path: str, dtype=torch.float32, device=None) -> "MambaRuntime":
        _, cfg, params, tok, eog = open_runtime(path, MambaConfig, load_mamba_params,
                                                dtype, device)
        return cls(cfg, params, tok, eog)

    def generate(self, prompt_tokens: list[int], n_predict: int = 32,
                 sampler=None) -> list[int]:
        """Greedy, or through the host `sampler` (sampling.Sampler) when one
        is given."""
        dev = self.params["tok_embd"].device
        out: list[int] = []
        with torch.no_grad():
            logits, states = mamba_forward(self.params, self.cfg, [list(prompt_tokens)],
                                           init_mamba_state(self.cfg, 1, dev))
            cur = logits[0, -1]
            for _ in range(n_predict):
                if sampler is not None:
                    tok = sampler.sample_and_accept(cur.float().cpu().numpy())
                else:
                    tok = int(torch.argmax(cur))
                out.append(tok)
                if tok in self.eog_ids:
                    break
                logits, states = mamba_forward(self.params, self.cfg, [[tok]], states)
                cur = logits[0, -1]
        return out
