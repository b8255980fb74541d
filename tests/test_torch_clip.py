"""The port's CLIP encoder and projectors (models/clip.py) against the JAX
package's on the CPU: tiny mmproj GGUFs written with the JAX package's
GGUFWriter for every projector type (mlp, mlp_norm, ldp, ldpv2, the
minicpmv resampler at versions 2 and 3; f32, and Q8_0 / F16 tensors
dequantized on the host), clip_encode_image and ClipModel.encode (the
llava-1.5 pad, llava-1.6 anyres, minicpmv slices) within 1e-5 of max |out|;
the preprocessing (pad + resize, best resolution, anyres tiles and merge,
uhd slices, the position tables) bit for bit; the config and its
rejections; the JAX params carried across by params_from_numpy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from prima_tpu.gguf.constants import GGMLType
from prima_tpu.gguf.reader import GGUFModel as JGGUFModel
from prima_tpu.gguf.writer import GGUFWriter
from prima_tpu.models import clip as jclip
from prima_tpu.quant.quantize_np import quantize
from prima_tpu_torch.gguf.reader import GGUFModel
from prima_tpu_torch.models import clip
from prima_tpu_torch.models.llama import params_from_numpy
from test_torch_model import _flatten_jax

TOL = 1e-5
VIS, FF, HEADS, LAYERS = 32, 48, 4, 3


def _resampler_params(r, hidden, out, num_query):
    p = {"resampler.query": r(num_query, hidden), "resampler.kv.weight": r(hidden, VIS),
         "resampler.proj.weight": r(out, hidden)}
    for n in ("q", "k", "v", "out"):
        p[f"resampler.attn.{n}.weight"] = r(hidden, hidden)
        p[f"resampler.attn.{n}.bias"] = r(hidden)
    for n in ("q", "kv", "post"):
        p[f"resampler.ln_{n}.weight"] = 1 + r(hidden, scale=0.05)
        p[f"resampler.ln_{n}.bias"] = r(hidden, scale=0.05)
    return p


def _ldp_params(r, c):
    p = {"mm.model.mlp.1.weight": r(c, VIS), "mm.model.mlp.1.bias": r(c),
         "mm.model.mlp.3.weight": r(c, c), "mm.model.mlp.3.bias": r(c)}
    for b in (1, 2):
        pre = f"mm.model.mb_block.{b}.block"
        p.update({f"{pre}.0.0.weight": r(c, 1, 3, 3, scale=0.2),
                  f"{pre}.0.1.weight": 1 + r(c, scale=0.05), f"{pre}.0.1.bias": r(c),
                  f"{pre}.1.fc1.weight": r(c // 4, c), f"{pre}.1.fc1.bias": r(c // 4),
                  f"{pre}.1.fc2.weight": r(c, c // 4), f"{pre}.1.fc2.bias": r(c),
                  f"{pre}.2.0.weight": r(c, c), f"{pre}.2.1.weight": 1 + r(c, scale=0.05),
                  f"{pre}.2.1.bias": r(c)})
    return p


def write_mmproj(path, projector: str = "mlp", out: int = 24, minicpmv: int = 0,
                 ftype=GGMLType.F32, use_gelu: bool = False, pinpoints=None,
                 image_size: int = 32, patch: int = 8, seed: int = 0) -> str:
    """Write a tiny mmproj GGUF: a ViT of LAYERS blocks, VIS wide, and the
    `projector` (minicpmv > 0 writes the resampler) into `out` dims.
    Weight matrices whose rows are whole Q8_0 blocks take `ftype`."""
    rng = np.random.default_rng(seed)

    def r(*s, scale=0.1):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    w = GGUFWriter(str(path), arch="clip")
    w.add_kv("clip.has_vision_encoder", True)
    w.add_kv("clip.projector_type", "resampler" if minicpmv else projector)
    if minicpmv:
        w.add_kv("clip.has_minicpmv_projector", True)
        w.add_kv("clip.minicpmv_version", minicpmv)
    w.add_kv("clip.use_gelu", use_gelu)
    for key, val in {"image_size": image_size, "patch_size": patch, "embedding_length": VIS,
                     "feed_forward_length": FF, "block_count": LAYERS,
                     "attention.head_count": HEADS, "attention.layer_norm_epsilon": 1e-5,
                     "projection_dim": out}.items():
        w.add_kv(f"clip.vision.{key}", val)
    w.add_kv("clip.vision.image_mean", np.asarray([0.5, 0.45, 0.4], np.float32))
    w.add_kv("clip.vision.image_std", np.asarray([0.25, 0.26, 0.27], np.float32))
    if pinpoints:
        w.add_kv("clip.vision.mm_patch_merge_type", "spatial_unpad")
        w.add_kv("clip.vision.image_grid_pinpoints",
                 np.asarray([v for p in pinpoints for v in p], np.int32))

    def mat(name, x):
        if ftype == GGMLType.F16:
            w.add_tensor(name, x.astype(np.float16))
        elif ftype != GGMLType.F32 and x.ndim == 2 and x.shape[1] % 32 == 0:
            w.add_tensor(name, quantize(x, ftype), ne=(x.shape[1], x.shape[0]),
                         ggml_type=ftype)
        else:
            w.add_tensor(name, x)

    n_pos = 70 * 70 if minicpmv else (image_size // patch) ** 2 + 1
    mat("v.patch_embd.weight", r(VIS, 3, patch, patch))
    w.add_tensor("v.patch_embd.bias", r(VIS))
    w.add_tensor("v.position_embd.weight", r(n_pos, VIS))
    if minicpmv:
        w.add_tensor("v.post_ln.weight", 1 + r(VIS, scale=0.05))
        w.add_tensor("v.post_ln.bias", r(VIS, scale=0.05))
    else:
        w.add_tensor("v.class_embd", r(VIS))
        w.add_tensor("v.pre_ln.weight", 1 + r(VIS, scale=0.05))
        w.add_tensor("v.pre_ln.bias", r(VIS, scale=0.05))
    for i in range(LAYERS):
        pre = f"v.blk.{i}."
        for n in ("ln1", "ln2"):
            w.add_tensor(pre + n + ".weight", 1 + r(VIS, scale=0.05))
            w.add_tensor(pre + n + ".bias", r(VIS, scale=0.05))
        for n in ("attn_q", "attn_k", "attn_v", "attn_out"):
            mat(pre + n + ".weight", r(VIS, VIS))
            w.add_tensor(pre + n + ".bias", r(VIS))
        mat(pre + "ffn_down.weight", r(FF, VIS))  # HF fc1: hidden -> intermediate
        w.add_tensor(pre + "ffn_down.bias", r(FF))
        mat(pre + "ffn_up.weight", r(VIS, FF))
        w.add_tensor(pre + "ffn_up.bias", r(VIS))
    if minicpmv:
        proj = _resampler_params(r, 256, out, 8)
    elif projector == "mlp":
        proj = {"mm.0.weight": r(64, VIS), "mm.0.bias": r(64), "mm.2.weight": r(out, 64),
                "mm.2.bias": r(out)}
    elif projector == "mlp_norm":
        proj = {"mm.0.weight": r(64, VIS), "mm.0.bias": r(64),
                "mm.1.weight": 1 + r(64, scale=0.05), "mm.1.bias": r(64),
                "mm.3.weight": r(out, 64), "mm.3.bias": r(out),
                "mm.4.weight": 1 + r(out, scale=0.05), "mm.4.bias": r(out)}
    elif projector == "ldp":
        proj = _ldp_params(r, out)
    else:  # ldpv2
        proj = {"mm.model.mlp.0.weight": r(out, VIS), "mm.model.mlp.0.bias": r(out),
                "mm.model.mlp.2.weight": r(out, out), "mm.model.mlp.2.bias": r(out),
                "mm.model.peg.0.weight": r(out, 1, 3, 3, scale=0.2),
                "mm.model.peg.0.bias": r(out)}
    for k, v in proj.items():
        mat(k, v)
    w.write()
    return str(path)


def load_both(path):
    return jclip.ClipModel.load(path), clip.ClipModel.load(path, device="cpu")


def close(got, want, tol=TOL) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


ENCODERS = [("mlp", 0, GGMLType.F32, False), ("mlp", 0, GGMLType.Q8_0, True),
            ("mlp_norm", 0, GGMLType.F16, False), ("ldp", 0, GGMLType.F32, False),
            ("ldpv2", 0, GGMLType.F32, True), ("resampler", 2, GGMLType.F32, True),
            ("resampler", 3, GGMLType.Q8_0, True)]


@pytest.mark.parametrize("projector,minicpmv,ftype,gelu", ENCODERS,
                         ids=[f"{p}{m or ''}-{f.name}" for p, m, f, _ in ENCODERS])
def test_clip_encode_image_matches_jax(tmp_path, projector, minicpmv, ftype, gelu):
    jm, m = load_both(write_mmproj(tmp_path / "mm.gguf", projector, minicpmv=minicpmv,
                                   ftype=ftype, use_gelu=gelu))
    assert vars(m.cfg) == vars(jm.cfg)
    # minicpmv takes variable sizes: 3 x 5 patches
    shape = (3, 24, 40) if minicpmv else (3, 32, 32)
    px = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jclip.clip_encode_image(jm.params, jm.cfg, jnp.asarray(px)))
    with torch.no_grad():
        got = clip.clip_encode_image(m.params, m.cfg, torch.from_numpy(px)).numpy()
    close(got, want)
    rows = {"ldp": 4, "ldpv2": 4, "resampler": 8}.get(projector, 16)
    assert got.shape == (rows, 24)


@pytest.mark.parametrize("kind", ["flat-wide", "flat-tall", "anyres", "minicpmv"])
def test_clip_model_encode_matches_jax(tmp_path, kind):
    if kind == "anyres":
        path = write_mmproj(tmp_path / "a.gguf", pinpoints=[(32, 32), (64, 32), (32, 64)])
        img_shape = (40, 90, 3)
    elif kind == "minicpmv":
        path = write_mmproj(tmp_path / "c.gguf", minicpmv=2, image_size=448, patch=14)
        img_shape = (500, 1000, 3)
    else:
        path = write_mmproj(tmp_path / "f.gguf")
        img_shape = (20, 32, 3) if kind == "flat-wide" else (40, 24, 3)
    jm, m = load_both(path)
    img = np.random.default_rng(2).integers(0, 255, img_shape, dtype=np.uint8)
    want, got = jm.encode(img), m.encode(img)
    assert got.dtype == np.float32
    close(got, want)
    if kind == "anyres":
        assert got.shape == (16 + 32, 24)
    if kind == "minicpmv":
        (jt, jg), (t, g) = jm.encode_minicpmv(img), m.encode_minicpmv(img)
        assert g == jg and len(t) == len(jt) == 1 + g[0] * g[1] > 2
        for a, b in zip(t, jt):
            close(a, b)


def test_preprocessing_matches_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    cfg = clip.ClipVisionConfig(image_size=32, patch_size=8, n_embd=32, n_ff=48, n_layers=3,
                                n_heads=4, eps=1e-5, proj_dim=16, use_gelu=False,
                                projector_type="mlp", mm_patch_merge_type="spatial_unpad",
                                grid_pinpoints=(32, 32, 64, 32, 32, 64, 64, 64))
    jcfg = jclip.ClipVisionConfig(**vars(cfg))
    for shape in ((16, 32, 3), (40, 24, 3), (32, 32, 3), (50, 100, 3)):
        img = rng.integers(0, 255, shape, dtype=np.uint8)
        assert np.array_equal(clip.preprocess_image(img, cfg), jclip.preprocess_image(img, jcfg))
        assert np.array_equal(clip.resize_and_pad(img, (64, 32)),
                              jclip.resize_and_pad(img, (64, 32)))
        (tiles, grid), (jtiles, jgrid) = clip.anyres_tiles(img, cfg), jclip.anyres_tiles(img, jcfg)
        assert grid == jgrid and len(tiles) == len(jtiles)
        assert all(np.array_equal(a, b) for a, b in zip(tiles, jtiles))
    pins = [(32, 32), (64, 32), (32, 64), (96, 48)]
    for size in ((100, 50), (50, 100), (33, 33), (200, 90)):
        assert clip.select_best_resolution(size, pins) == jclip.select_best_resolution(size, pins)
    embeds = [rng.standard_normal((16, 3)).astype(np.float32) for _ in range(5)]
    for grid in ((2, 2), (4, 1), (1, 4)):
        assert np.array_equal(clip.merge_anyres_embeds(embeds, grid, 4),
                              jclip.merge_anyres_embeds(embeds, grid, 4))


def test_uhd_and_position_tables_match_jax_bit_for_bit():
    rng = np.random.default_rng(6)
    for shape in ((300, 500, 3), (700, 1400, 3), (1400, 500, 3), (900, 900, 3)):
        img = rng.integers(0, 255, shape, dtype=np.uint8)
        (tiles, grid), (jtiles, jgrid) = clip.uhd_slice_image(img), jclip.uhd_slice_image(img)
        assert grid == jgrid and len(tiles) == len(jtiles)
        assert all(np.array_equal(a, b) for a, b in zip(tiles, jtiles))
    for args in ((9, 5, np.log(2.0)), (9, 2, 0.1), (4, 4, -1.0), (9, 9, 0.7)):
        assert clip.uhd_best_grid(*args) == jclip.uhd_best_grid(*args)
    for n in (3, 14, 27, 28, 41, 448):
        assert clip._ensure_divide(n, 14) == jclip._ensure_divide(n, 14)
    for nh, nw in ((3, 5), (32, 32), (17, 40)):
        assert np.array_equal(clip.bucket_position_ids(nh, nw), jclip.bucket_position_ids(nh, nw))
        assert np.array_equal(clip.get_2d_sincos_pos_embed(256, nw, nh),
                              jclip.get_2d_sincos_pos_embed(256, nw, nh))


def test_config_rejections_match_jax(tmp_path):
    for kv, err in (({"clip.projector_type": "adapter_xyz"}, NotImplementedError),
                    ({"clip.has_vision_encoder": False}, ValueError)):
        path = str(tmp_path / "bad.gguf")
        w = GGUFWriter(path, arch="clip")
        w.add_kv("clip.has_vision_encoder", True)
        for k, v in kv.items():
            w.add_kv(k, v)
        w.add_tensor("dummy", np.zeros(4, np.float32))
        w.write()
        with pytest.raises(err) as jexc:
            jclip.ClipVisionConfig.from_gguf(JGGUFModel.open(path))
        with pytest.raises(err) as exc:
            clip.ClipVisionConfig.from_gguf(GGUFModel.open(path))
        assert str(exc.value) == str(jexc.value)


def test_params_from_numpy_carries_clip(tmp_path):
    jm, m = load_both(write_mmproj(tmp_path / "mm.gguf", "ldp"))
    params = params_from_numpy(_flatten_jax(jm.params), "cpu")
    px = np.random.default_rng(3).standard_normal((3, 32, 32)).astype(np.float32)
    want = np.asarray(jclip.clip_encode_image(jm.params, jm.cfg, jnp.asarray(px)))
    with torch.no_grad():
        got = clip.clip_encode_image(params, m.cfg, torch.from_numpy(px)).numpy()
    close(got, want)


def test_load_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clip.ClipModel.load(write_mmproj(tmp_path / "mm.gguf"))
