"""CLIP ViT vision encoder + LLaVA projector: the mmproj GGUF consumer.

Counterpart of prima_tpu/models/clip.py on one device (CUDA unless the
caller asks for the CPU). The analogue of the reference's
examples/llava/clip.cpp: loads a `mmproj-*.gguf` (KV namespace
`clip.vision.*`, tensors `v.*` / `mm.*`), encodes preprocessed images into
patch embeddings, and projects them into the language model's embedding
space. As in the JAX package every mmproj tensor is dequantized on the
host and held dense on the device, so the matmuls are `torch.matmul` in
f32 (TF32 stays off, PyTorch's default for matmuls); the patch embedding
is an unfold plus a matmul and the depthwise convolutions of the LDP
projectors are sums of shifted slices, so no cuDNN convolution (which
allows TF32 by default) runs on this path.

Behavioural details (clip.cpp build graph @582-815):
- patch conv2d (+ optional bias), class token at position 0, learned
  position embeddings, optional pre/post LayerNorm
- with a llava projector the transformer runs block_count - 1 layers
  (the penultimate "vision_feature_layer", @682); minicpmv runs all
- attention is bidirectional multi-head with q/k/v/out biases
- FFN activation: gelu when `clip.use_gelu` else quick-gelu (@747-751)
- the GGUF names are swapped against HF: `ffn_down` = HF mlp.fc1
  (hidden -> intermediate) and `ffn_up` = fc2; this module follows the
  GGUF convention
- projector `mlp`: mm.0 linear -> gelu -> mm.2 linear, class token
  dropped (@785-792); `mlp_norm`: mm.0 -> LN mm.1 -> gelu -> mm.3 ->
  LN mm.4 (@793-813); the MobileVLM `ldp` / `ldpv2` conv projectors
  (clip.cpp:1409-1480) and the minicpmv perceiver resampler (@734-783);
  other projector types are rejected at load.

The image preprocessing uses PIL, imported only inside the functions that
resize an image.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import resolve_device

# LLaVA's pad-to-square background colour (mean RGB * 255, clip.cpp:1998)
PAD_COLOR = (122, 116, 104)


@dataclass
class ClipVisionConfig:
    image_size: int
    patch_size: int
    n_embd: int
    n_ff: int
    n_layers: int
    n_heads: int
    eps: float
    proj_dim: int
    use_gelu: bool
    projector_type: str
    image_mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    image_std: tuple = (0.26862954, 0.26130258, 0.27577711)
    mm_patch_merge_type: str = "flat"
    grid_pinpoints: tuple = ()  # llava-1.6 anyres resolutions (w, h pairs)
    minicpmv_version: int = 0  # 0 = not minicpmv; 2 / 3 = resampler variants

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def from_gguf(cls, m) -> "ClipVisionConfig":
        if not m.get("clip.has_vision_encoder"):
            raise ValueError("mmproj GGUF has no vision encoder")
        proj = str(m.get("clip.projector_type") or "mlp")
        minicpmv = int(m.get("clip.minicpmv_version") or 0) \
            if m.get("clip.has_minicpmv_projector") else 0
        if minicpmv and proj == "mlp":  # minicpmv GGUFs may omit the key
            proj = "resampler"
        if proj not in ("mlp", "mlp_norm", "ldp", "ldpv2", "resampler"):
            raise NotImplementedError(
                f"clip projector type {proj!r} not supported "
                "(mlp/mlp_norm/ldp/ldpv2/resampler)")
        if proj == "resampler" and not minicpmv:
            minicpmv = 2

        def seq(key, default):
            v = m.get(key)
            return default if v is None else v

        return cls(
            image_size=int(m.get("clip.vision.image_size")),
            patch_size=int(m.get("clip.vision.patch_size")),
            n_embd=int(m.get("clip.vision.embedding_length")),
            n_ff=int(m.get("clip.vision.feed_forward_length")),
            n_layers=int(m.get("clip.vision.block_count")),
            n_heads=int(m.get("clip.vision.attention.head_count")),
            eps=float(m.get("clip.vision.attention.layer_norm_epsilon") or 1e-5),
            proj_dim=int(m.get("clip.vision.projection_dim") or 0),
            use_gelu=bool(m.get("clip.use_gelu")),
            projector_type=proj,
            image_mean=tuple(np.asarray(seq("clip.vision.image_mean",
                                            (0.48145466, 0.4578275, 0.40821073)),
                                        np.float64)),
            image_std=tuple(np.asarray(seq("clip.vision.image_std",
                                           (0.26862954, 0.26130258, 0.27577711)),
                                       np.float64)),
            mm_patch_merge_type=str(m.get("clip.vision.mm_patch_merge_type") or "flat"),
            grid_pinpoints=tuple(int(x) for x in np.ravel(np.asarray(
                seq("clip.vision.image_grid_pinpoints", []), np.int64))),
            minicpmv_version=minicpmv,
        )


def projector_keys(cfg: ClipVisionConfig) -> list[str]:
    """The projector's tensor names (clip.cpp:1409-1508)."""
    if cfg.projector_type == "mlp":
        return ["mm.0.weight", "mm.0.bias", "mm.2.weight", "mm.2.bias"]
    if cfg.projector_type == "mlp_norm":
        return ["mm.0.weight", "mm.0.bias", "mm.1.weight", "mm.1.bias",
                "mm.3.weight", "mm.3.bias", "mm.4.weight", "mm.4.bias"]
    if cfg.projector_type == "ldp":  # MobileVLM
        keys = ["mm.model.mlp.1.weight", "mm.model.mlp.1.bias",
                "mm.model.mlp.3.weight", "mm.model.mlp.3.bias"]
        for b in (1, 2):
            pre = f"mm.model.mb_block.{b}.block"
            keys += [f"{pre}.0.0.weight", f"{pre}.0.1.weight", f"{pre}.0.1.bias",
                     f"{pre}.1.fc1.weight", f"{pre}.1.fc1.bias", f"{pre}.1.fc2.weight",
                     f"{pre}.1.fc2.bias", f"{pre}.2.0.weight", f"{pre}.2.1.weight",
                     f"{pre}.2.1.bias"]
        return keys
    if cfg.projector_type == "ldpv2":  # MobileVLM v2
        return ["mm.model.mlp.0.weight", "mm.model.mlp.0.bias",
                "mm.model.mlp.2.weight", "mm.model.mlp.2.bias",
                "mm.model.peg.0.weight", "mm.model.peg.0.bias"]
    # minicpmv resampler
    keys = ["resampler.query", "resampler.proj.weight", "resampler.kv.weight"]
    keys += [f"resampler.attn.{n}.{s}" for n in ("q", "k", "v", "out")
             for s in ("weight", "bias")]
    keys += [f"resampler.ln_{n}.{s}" for n in ("q", "kv", "post") for s in ("weight", "bias")]
    return keys


_LAYER_KEYS = [("ln1_w", "ln1.weight"), ("ln1_b", "ln1.bias"),
               ("q_w", "attn_q.weight"), ("q_b", "attn_q.bias"),
               ("k_w", "attn_k.weight"), ("k_b", "attn_k.bias"),
               ("v_w", "attn_v.weight"), ("v_b", "attn_v.bias"),
               ("o_w", "attn_out.weight"), ("o_b", "attn_out.bias"),
               ("ln2_w", "ln2.weight"), ("ln2_b", "ln2.bias"),
               ("ffi_w", "ffn_down.weight"), ("ffi_b", "ffn_down.bias"),
               ("ffo_w", "ffn_up.weight"), ("ffo_b", "ffn_up.bias")]


def load_clip_params(m, cfg: ClipVisionConfig, dtype=torch.float32, device=None) -> dict:
    """The mmproj tensors, dequantized on the host, dense on `device`."""
    from ..quant.dequant_np import dequantize_tensor

    device = resolve_device(device)

    def t(name, required=True):
        ti = m.tensors.get(name)
        if ti is None:
            if required:
                raise KeyError(f"mmproj missing tensor {name}")
            return None
        return torch.from_numpy(dequantize_tensor(ti).astype(np.float32)).to(
            device=device, dtype=dtype)

    p: dict[str, Any] = {
        "patch_embd": t("v.patch_embd.weight"),  # (hid, 3, ps, ps)
        "patch_bias": t("v.patch_embd.bias", False),
        "class_embd": t("v.class_embd", False),
        "pos_embd": t("v.position_embd.weight"),
        "pre_ln_w": t("v.pre_ln.weight", False),
        "pre_ln_b": t("v.pre_ln.bias", False),
        "post_ln_w": t("v.post_ln.weight", False),
        "post_ln_b": t("v.post_ln.bias", False),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        pre = f"v.blk.{i}."
        p["layers"].append({k: t(pre + n) for k, n in _LAYER_KEYS})
    for k in projector_keys(cfg):
        p[k] = t(k)
    return p


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w^T in f32."""
    return torch.matmul(x, w.t())


def _hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _hardsigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _dw_conv3x3(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Depthwise 3x3 convolution, padding 1 (ggml_conv_depthwise_2d), as a
    sum of the nine shifted, strided slices.
    x (C, H, W), w (C, 1, 3, 3) -> (C, H / stride, W / stride)."""
    c, hh, ww = x.shape
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    ho, wo = (hh - 1) // stride + 1, (ww - 1) // stride + 1
    out = torch.zeros((c, ho, wo), dtype=x.dtype, device=x.device)
    for i in range(3):
        for j in range(3):
            tap = xp[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
            out = out + w[:, 0, i, j][:, None, None] * tap
    return out


def _ldp_block(x, p, prefix: str, eps: float, stride: int, residual: bool) -> torch.Tensor:
    """One MobileVLM LDP inverted-residual block (clip.cpp:815-923):
    depthwise conv -> channel LN -> hardswish -> squeeze-excite ->
    pointwise linear -> channel LN (-> + residual). x (C, H, W)."""
    h = _dw_conv3x3(x, p[f"{prefix}.0.0.weight"], stride)
    t = h.permute(1, 2, 0)  # (H, W, C): LN over channels
    t = _ln(t, p[f"{prefix}.0.1.weight"], p[f"{prefix}.0.1.bias"], eps)
    hw = _hardswish(t.permute(2, 0, 1))
    se = hw.mean(dim=(1, 2))  # global average pool (C,)
    se = torch.clamp_min(_mm(se, p[f"{prefix}.1.fc1.weight"]) + p[f"{prefix}.1.fc1.bias"], 0.0)
    se = _hardsigmoid(_mm(se, p[f"{prefix}.1.fc2.weight"]) + p[f"{prefix}.1.fc2.bias"])
    h = hw * se[:, None, None]
    c, hh, ww = h.shape
    t = h.permute(1, 2, 0).reshape(hh * ww, c)  # (HW, C)
    t = _mm(t, p[f"{prefix}.2.0.weight"])  # pointwise, no bias
    t = _ln(t, p[f"{prefix}.2.1.weight"], p[f"{prefix}.2.1.bias"], eps)
    out = t.reshape(hh, ww, c).permute(2, 0, 1)
    return out + x if residual else out


def apply_projector(params: dict, cfg: ClipVisionConfig, x: torch.Tensor) -> torch.Tensor:
    """Project ViT patch features (n_patches, vis_hidden) into the LM's
    embedding space. mlp / mlp_norm return n_patches rows; ldp / ldpv2
    downsample 2x2 (clip.cpp:770-955)."""
    if cfg.projector_type in ("mlp", "mlp_norm"):
        x = _mm(x, params["mm.0.weight"]) + params["mm.0.bias"]
        if cfg.projector_type == "mlp":
            x = _gelu(x, True)
            return _mm(x, params["mm.2.weight"]) + params["mm.2.bias"]
        x = _ln(x, params["mm.1.weight"], params["mm.1.bias"], cfg.eps)
        x = _gelu(x, True)
        x = _mm(x, params["mm.3.weight"]) + params["mm.3.bias"]
        return _ln(x, params["mm.4.weight"], params["mm.4.bias"], cfg.eps)

    n_side = cfg.image_size // cfg.patch_size
    if cfg.projector_type == "ldp":
        h = _mm(x, params["mm.model.mlp.1.weight"]) + params["mm.model.mlp.1.bias"]
        h = _gelu(h, True)
        h = _mm(h, params["mm.model.mlp.3.weight"]) + params["mm.model.mlp.3.bias"]
        c = h.shape[-1]
        grid = h.reshape(n_side, n_side, c).permute(2, 0, 1)  # (C, H, W)
        grid = _ldp_block(grid, params, "mm.model.mb_block.1.block", cfg.eps, stride=1,
                          residual=True)
        grid = _ldp_block(grid, params, "mm.model.mb_block.2.block", cfg.eps, stride=2,
                          residual=False)
        return grid.permute(1, 2, 0).reshape(-1, c)

    # ldpv2: mlp -> 2x2 average pool -> depthwise positional-encoding residual
    h = _mm(x, params["mm.model.mlp.0.weight"]) + params["mm.model.mlp.0.bias"]
    h = _gelu(h, True)
    h = _mm(h, params["mm.model.mlp.2.weight"]) + params["mm.model.mlp.2.bias"]
    c = h.shape[-1]
    grid = h.reshape(n_side, n_side, c).permute(2, 0, 1)
    grid = grid.reshape(c, n_side // 2, 2, n_side // 2, 2).mean(dim=(2, 4))
    peg = _dw_conv3x3(grid, params["mm.model.peg.0.weight"], 1)
    out = peg.permute(1, 2, 0) + params["mm.model.peg.0.bias"] + grid.permute(1, 2, 0)
    return out.reshape(-1, c)


def _ln(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def _gelu(x, use_gelu: bool):
    xf = x.float()
    if use_gelu:  # the tanh form, written out
        g = 0.5 * xf * (1.0 + torch.tanh(0.7978845608028654 * (xf + 0.044715 * xf ** 3)))
    else:  # quick gelu (ggml_gelu_quick): x * sigmoid(1.702 x)
        g = xf * torch.sigmoid(1.702 * xf)
    return g.to(x.dtype)


def bucket_position_ids(n_h: int, n_w: int) -> np.ndarray:
    """siglip-navit interpolation buckets for variable-size images
    (clip.cpp:2360-2380): patch (y, x) -> floor(70 y / n_h) * 70 +
    floor(70 x / n_w), row-major."""
    by = np.floor(70.0 * np.arange(n_h) / n_h).astype(np.int32)
    bx = np.floor(70.0 * np.arange(n_w) / n_w).astype(np.int32)
    return (by[:, None] * 70 + bx[None, :]).reshape(-1)


def get_2d_sincos_pos_embed(embed_dim: int, pos_w: int, pos_h: int) -> np.ndarray:
    """Qwen-VL-style 2D sincos table for the resampler's K
    (get_2d_sincos_pos_embed, clip.cpp:2198-2282): row[y * pos_w + x]
    carries [sin/cos(x · ω) | sin/cos(y · ω)]."""
    half = embed_dim // 2
    quarter = half // 2
    omega = 1.0 / 10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter)

    def emb_1d(pos):  # (...,) -> (..., half)
        out = pos[..., None] * omega
        return np.concatenate([np.sin(out), np.cos(out)], axis=-1)

    a = np.broadcast_to(np.arange(pos_w, dtype=np.float64)[:, None], (pos_w, pos_h))
    b = np.broadcast_to(np.arange(pos_h, dtype=np.float64)[None, :], (pos_w, pos_h))
    emb = np.concatenate([emb_1d(a), emb_1d(b)], axis=-1)  # (pos_w, pos_h, d)
    # pos_embed_2d[w * H + h] = emb[h][w]  (clip.cpp:2274-2278)
    return emb.transpose(1, 0, 2).reshape(pos_w * pos_h, embed_dim).astype(np.float32)


def _resampler(params: dict, cfg: ClipVisionConfig, x: torch.Tensor,
               n_w: int, n_h: int) -> torch.Tensor:
    """minicpmv perceiver resampler (clip.cpp:955-1016): learned queries
    cross-attend to kv-projected patch features with additive 2D sincos
    positions on K. x (n_pos, vis_hidden) -> (num_query, hidden)."""
    q = params["resampler.query"]  # (num_query, hidden)
    hidden = q.shape[-1]
    d_head = 128
    n_head = hidden // d_head
    q = _ln(q, params["resampler.ln_q.weight"], params["resampler.ln_q.bias"], cfg.eps)
    v = _mm(x, params["resampler.kv.weight"])  # no bias
    v = _ln(v, params["resampler.ln_kv.weight"], params["resampler.ln_kv.bias"], cfg.eps)
    k = v + torch.from_numpy(get_2d_sincos_pos_embed(hidden, n_w, n_h)).to(v.device)

    def heads(t):
        return t.reshape(t.shape[0], n_head, d_head).permute(1, 0, 2)

    scale = float(np.float32(np.sqrt(d_head)))
    Q = heads((_mm(q, params["resampler.attn.q.weight"])
               + params["resampler.attn.q.bias"]) / scale)
    K = heads(_mm(k, params["resampler.attn.k.weight"]) + params["resampler.attn.k.bias"])
    V = heads(_mm(v, params["resampler.attn.v.weight"]) + params["resampler.attn.v.bias"])
    att = torch.softmax(torch.einsum("hqd,hkd->hqk", Q.float(), K.float()), dim=-1)
    o = torch.einsum("hqk,hkd->hqd", att.to(V.dtype), V)
    o = o.permute(1, 0, 2).reshape(-1, hidden)
    o = _mm(o, params["resampler.attn.out.weight"]) + params["resampler.attn.out.bias"]
    o = _ln(o, params["resampler.ln_post.weight"], params["resampler.ln_post.bias"], cfg.eps)
    return _mm(o, params["resampler.proj.weight"])


def clip_encode_image(params: dict, cfg: ClipVisionConfig,
                      pixels: torch.Tensor) -> torch.Tensor:
    """pixels (3, H, W) f32 normalized -> projected patch embeddings
    (n_patches, llm_embd): the whole clip.cpp graph for one image.
    minicpmv accepts variable H / W (multiples of patch_size)."""
    ps, hid = cfg.patch_size, cfg.n_embd
    _, H, W = pixels.shape
    n_h, n_w = H // ps, W // ps
    # the patch conv2d as an unfold and one matmul
    patches = pixels.reshape(3, n_h, ps, n_w, ps)
    patches = patches.permute(1, 3, 0, 2, 4).reshape(n_h * n_w, 3 * ps * ps)
    kernel = params["patch_embd"].reshape(hid, 3 * ps * ps)
    x = _mm(patches, kernel)  # (n_patches, hid)
    if params.get("patch_bias") is not None:
        x = x + params["patch_bias"]
    if cfg.minicpmv_version:
        # siglip: no class token; interpolation-bucket position ids
        ids = torch.from_numpy(bucket_position_ids(n_h, n_w).astype(np.int64)).to(x.device)
        x = x + params["pos_embd"][ids]
    else:
        if params.get("class_embd") is not None:
            x = torch.cat([params["class_embd"][None], x], dim=0)
        x = x + params["pos_embd"][: x.shape[0]]
    if params.get("pre_ln_w") is not None:
        x = _ln(x, params["pre_ln_w"], params["pre_ln_b"], cfg.eps)

    n_heads = cfg.n_heads
    hd = hid // n_heads
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    # llava's feature layer is the penultimate (clip.cpp:682); minicpmv
    # runs every stored layer (@679)
    n_run = cfg.n_layers if cfg.minicpmv_version else cfg.n_layers - 1
    for layer in params["layers"][:n_run]:
        h = _ln(x, layer["ln1_w"], layer["ln1_b"], cfg.eps)
        q = (_mm(h, layer["q_w"]) + layer["q_b"]) * scale
        k = _mm(h, layer["k_w"]) + layer["k_b"]
        v = _mm(h, layer["v_w"]) + layer["v_b"]
        n = h.shape[0]
        q = q.reshape(n, n_heads, hd).permute(1, 0, 2)
        k = k.reshape(n, n_heads, hd).permute(1, 0, 2)
        v = v.reshape(n, n_heads, hd).permute(1, 0, 2)
        att = torch.softmax(torch.einsum("hqd,hkd->hqk", q.float(), k.float()), dim=-1)
        o = torch.einsum("hqk,hkd->hqd", att.to(v.dtype), v)
        o = o.permute(1, 0, 2).reshape(n, hid)
        x = x + (_mm(o, layer["o_w"]) + layer["o_b"])
        h = _ln(x, layer["ln2_w"], layer["ln2_b"], cfg.eps)
        h = _gelu(_mm(h, layer["ffi_w"]) + layer["ffi_b"], cfg.use_gelu)
        x = x + (_mm(h, layer["ffo_w"]) + layer["ffo_b"])

    if params.get("post_ln_w") is not None:
        x = _ln(x, params["post_ln_w"], params["post_ln_b"], cfg.eps)

    if cfg.minicpmv_version:
        return _resampler(params, cfg, x, n_w, n_h)

    # drop the class token (ggml_get_rows with patches = 1..n, @774-781)
    if params.get("class_embd") is not None:
        x = x[1:]

    return apply_projector(params, cfg, x)


def preprocess_image(img: np.ndarray, cfg: ClipVisionConfig) -> np.ndarray:
    """LLaVA-1.5 preprocessing (clip.cpp:1971-2010 + 2040-2075): pad the
    shorter side to square with the mean background colour, bicubic-resize
    to image_size, scale to [0, 1] and normalize with the CLIP mean / std.
    img: (H, W, 3) uint8 RGB. -> (3, S, S) float32."""
    from PIL import Image

    h, w = img.shape[:2]
    if h != w:
        side = max(h, w)
        canvas = np.empty((side, side, 3), np.uint8)
        canvas[:, :] = PAD_COLOR
        canvas[:h, :w] = img
        img = canvas
    pil = Image.fromarray(img).resize((cfg.image_size, cfg.image_size), Image.BICUBIC)
    x = np.asarray(pil, np.float32) / 255.0
    mean = np.asarray(cfg.image_mean, np.float32)
    std = np.asarray(cfg.image_std, np.float32)
    x = (x - mean) / std
    return x.transpose(2, 0, 1)  # (3, S, S)


def select_best_resolution(size: tuple[int, int], resolutions) -> tuple[int, int]:
    """(w, h) of the pinpoint that maximizes the effective resolution, then
    minimizes waste (clip.cpp:1746-1770)."""
    ow, oh = size
    best, best_eff, best_waste = None, 0, 1 << 62
    for rw, rh in resolutions:
        scale = min(rw / ow, rh / oh)
        eff = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = rw * rh - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (rw, rh), eff, waste
    return best


def resize_and_pad(img: np.ndarray, target: tuple[int, int]) -> np.ndarray:
    """Aspect-preserving bicubic resize centred on a black canvas
    (resize_and_pad_image, clip.cpp:1697-1737)."""
    from PIL import Image

    tw, th = target
    h, w = img.shape[:2]
    scale_w, scale_h = tw / w, th / h
    if scale_w < scale_h:
        nw, nh = tw, min(int(np.ceil(h * scale_w)), th)
    else:
        nh, nw = th, min(int(np.ceil(w * scale_h)), tw)
    resized = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BICUBIC))
    canvas = np.zeros((th, tw, 3), np.uint8)
    py, px = (th - nh) // 2, (tw - nw) // 2
    canvas[py:py + nh, px:px + nw] = resized
    return canvas


def anyres_tiles(img: np.ndarray, cfg: ClipVisionConfig
                 ) -> tuple[list[np.ndarray], tuple[int, int]]:
    """llava-1.6 anyres preprocessing (clip.cpp:2015-2040): [base square
    resize of the original] + image_size tiles of the best-fit padded
    image. Returns (uint8 tiles, (grid_w, grid_h))."""
    from PIL import Image

    pins = cfg.grid_pinpoints
    res = [(pins[i], pins[i + 1]) for i in range(0, len(pins) - 1, 2)]
    h, w = img.shape[:2]
    best = select_best_resolution((w, h), res)
    padded = resize_and_pad(img, best)
    s = cfg.image_size
    tiles = [np.asarray(Image.fromarray(img).resize((s, s), Image.BICUBIC))]
    for y in range(0, best[1], s):
        for x in range(0, best[0], s):
            tiles.append(padded[y:y + s, x:x + s])
    return tiles, (best[0] // s, best[1] // s)


def _ensure_divide(length: int, patch_size: int) -> int:
    # C++ std::round (half away from zero), not Python's banker's rounding
    return max(int(np.floor(length / patch_size + 0.5)) * patch_size, patch_size)


def _uhd_find_best_resize(size, scale_resolution: int, patch_size: int,
                          allow_upscale: bool = False) -> tuple[int, int]:
    w, h = size
    if w * h > scale_resolution * scale_resolution or allow_upscale:
        r = w / h
        h = int(scale_resolution / np.sqrt(r))
        w = int(h * r)
    return _ensure_divide(w, patch_size), _ensure_divide(h, patch_size)


def uhd_best_grid(max_slice_nums: int, multiple: int, log_ratio: float) -> tuple[int, int]:
    candidates = []
    for i in (multiple - 1, multiple, multiple + 1):
        if i == 1 or i > max_slice_nums:
            continue
        for m in range(1, i + 1):
            if i % m == 0:
                candidates.append((m, i // m))
    best, err = (1, 1), float("inf")
    for gx, gy in candidates:
        e = abs(log_ratio - np.log(gx / gy))
        if e < err:
            best, err = (gx, gy), e
    return best


def uhd_slice_image(img: np.ndarray, patch_size: int = 14, scale_resolution: int = 448,
                    max_slice_nums: int = 9) -> tuple[list[np.ndarray], tuple[int, int]]:
    """LLaVA-UHD slicing for minicpmv (uhd_slice_image, clip.cpp:1866-1932):
    -> ([source image] + row-major grid slices as uint8 arrays,
        (grid_cols, grid_rows)); the grid is (1, 1) with no slices when the
    image is small enough."""
    from PIL import Image

    h, w = img.shape[:2]
    log_ratio = float(np.log(w / h))
    ratio = w * h / (scale_resolution * scale_resolution)
    multiple = int(min(np.ceil(ratio), max_slice_nums))

    def resize(im, size):
        return np.asarray(Image.fromarray(im).resize(size, Image.BICUBIC))

    if multiple <= 1:
        best = _uhd_find_best_resize((w, h), scale_resolution, patch_size, allow_upscale=True)
        return [resize(img, best)], (1, 1)

    best = _uhd_find_best_resize((w, h), scale_resolution, patch_size)
    tiles = [resize(img, best)]
    grid = uhd_best_grid(max_slice_nums, multiple, log_ratio)
    # refine size: each grid cell resized to its own best fit
    gw, gh = grid
    rw, rh = _ensure_divide(w, gw), _ensure_divide(h, gh)
    bw, bh = _uhd_find_best_resize((rw // gw, rh // gh), scale_resolution, patch_size,
                                   allow_upscale=True)
    refine = resize(img, (bw * gw, bh * gh))
    for gy in range(gh):
        for gx in range(gw):
            tiles.append(refine[gy * bh:(gy + 1) * bh, gx * bw:(gx + 1) * bw])
    return tiles, grid


def merge_anyres_embeds(tile_embeds: list[np.ndarray], grid: tuple[int, int],
                        n_side: int) -> np.ndarray:
    """Assemble [base | spatially-merged grid] as clip_llava_handle_patches
    does (llava.cpp:99-224, the no-unpad / no-newline variant): grid tiles
    (gh, gw, s, s, D) -> permute (gh, s, gw, s, D) -> flatten."""
    gw, gh = grid
    base, rest = tile_embeds[0], np.stack(tile_embeds[1:])
    d = base.shape[-1]
    merged = rest.reshape(gh, gw, n_side, n_side, d).transpose(0, 2, 1, 3, 4).reshape(-1, d)
    return np.concatenate([base, merged], axis=0)


@dataclass
class ClipModel:
    cfg: ClipVisionConfig
    params: dict = field(repr=False)
    device: torch.device

    @classmethod
    def load(cls, path: str, dtype=torch.float32, device=None) -> "ClipModel":
        from ..gguf.reader import GGUFModel

        device = resolve_device(device)
        m = GGUFModel.open(path)
        cfg = ClipVisionConfig.from_gguf(m)
        params = load_clip_params(m, cfg, dtype, device)
        m.close()
        return cls(cfg, params, device)

    def _normalize(self, tile: np.ndarray) -> np.ndarray:
        x = tile.astype(np.float32) / 255.0
        mean = np.asarray(self.cfg.image_mean, np.float32)
        std = np.asarray(self.cfg.image_std, np.float32)
        return ((x - mean) / std).transpose(2, 0, 1)

    def _encode_pixels(self, px: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(px, np.float32)).to(self.device)
        with torch.no_grad():
            return clip_encode_image(self.params, self.cfg, x).float().cpu().numpy()

    def encode(self, img: np.ndarray) -> np.ndarray:
        """uint8 (H, W, 3) image -> (n_img_pos, llm_embd) f32.

        llava-1.5: one pad-to-square tile (n_patches rows). llava-1.6
        (spatial_unpad + grid pinpoints): the base tile and the spatially
        merged grid tiles (llava.cpp clip_llava_handle_patches)."""
        cfg = self.cfg
        if cfg.mm_patch_merge_type == "spatial_unpad" and cfg.grid_pinpoints:
            tiles, grid = anyres_tiles(img, cfg)
            embeds = [self._encode_pixels(self._normalize(t)) for t in tiles]
            return merge_anyres_embeds(embeds, grid, cfg.image_size // cfg.patch_size)
        if cfg.minicpmv_version:
            tiles, _grid = self.encode_minicpmv(img)
            return np.concatenate(tiles, axis=0)
        return self._encode_pixels(preprocess_image(img, cfg))

    def encode_minicpmv(self, img: np.ndarray) -> tuple[list[np.ndarray], tuple[int, int]]:
        """minicpmv: uhd-slice the image, resample each tile to num_query
        rows -> (per-tile embeddings [source, slices...], (cols, rows)) for
        the <image> / <slice> prompt assembly (minicpmv-cli.cpp
        process_image)."""
        tiles, grid = uhd_slice_image(img, self.cfg.patch_size)
        return [self._encode_pixels(self._normalize(t)) for t in tiles], grid

