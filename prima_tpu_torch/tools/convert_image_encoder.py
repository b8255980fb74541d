"""prima-convert-image-encoder — HF CLIP vision tower -> mmproj GGUF.

The analogue of examples/llava/convert_image_encoder_to_gguf.py: converts
a transformers CLIPVisionModel (plus a LLaVA multi-modal projector state
dict) into the `mmproj-*.gguf` format clip.cpp consumes (KV namespace
`clip.vision.*`, tensor names per the reference's name map
convert_image_encoder_to_gguf.py:48).

Usage: python -m prima_tpu_torch.tools.convert_image_encoder -m <hf_dir> \\
          [--projector proj.safetensors/.bin] -o mmproj.gguf [--use-gelu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# HF CLIPVisionModel state-dict key -> mmproj tensor name
_NAME_MAP = [
    ("vision_model.", "v."),
    ("encoder.layers.", "blk."),
    ("embeddings.", ""),
    ("self_attn.", "attn_"),
    ("layer_norm1", "ln1"), ("layer_norm2", "ln2"),
    ("pre_layrnorm", "pre_ln"),       # HF's actual (typo'd) name
    ("pre_layernorm", "pre_ln"),
    ("post_layernorm", "post_ln"),
    ("mlp.fc1", "ffn_down"),          # swapped on the wire, clip.cpp:1482
    ("mlp.fc2", "ffn_up"),
    ("out_proj", "out"),
    ("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
    ("patch_embedding", "patch_embd"),
    ("position_embedding", "position_embd"),
    ("class_embedding", "class_embd"),
]


def map_name(name: str) -> str:
    for a, b in _NAME_MAP:
        name = name.replace(a, b)
    return name


def convert(vision_model, output: str, projector: dict | None = None,
            use_gelu: bool = False, projector_type: str = "mlp",
            image_mean=None, image_std=None,
            image_grid_pinpoints=None,
            mm_patch_merge_type: str | None = None) -> None:
    """vision_model: transformers CLIPVisionModel (or compatible with
    .config and .state_dict()). projector: {"mm.0.weight": array, ...}
    already in wire names."""
    from ..gguf.writer import GGUFWriter

    cfg = vision_model.config
    w = GGUFWriter(output, arch="clip")
    w.add_kv("clip.has_text_encoder", False)
    w.add_kv("clip.has_vision_encoder", True)
    w.add_kv("clip.has_llava_projector", True)
    w.add_kv("clip.use_gelu", use_gelu)
    w.add_kv("clip.projector_type", projector_type)
    w.add_kv("clip.vision.image_size", int(cfg.image_size))
    w.add_kv("clip.vision.patch_size", int(cfg.patch_size))
    w.add_kv("clip.vision.embedding_length", int(cfg.hidden_size))
    w.add_kv("clip.vision.feed_forward_length", int(cfg.intermediate_size))
    # llava: block_count = n-1 and the graph runs block_count-1 layers —
    # the reference composition (convert_image_encoder_to_gguf.py:209 +
    # clip.cpp:682); kept bit-identical so real mmproj files behave the same
    w.add_kv("clip.vision.block_count", int(cfg.num_hidden_layers) - 1)
    w.add_kv("clip.vision.attention.head_count", int(cfg.num_attention_heads))
    w.add_kv("clip.vision.attention.layer_norm_epsilon",
             float(cfg.layer_norm_eps))
    w.add_kv("clip.vision.projection_dim",
             int(getattr(cfg, "projection_dim", 0) or 0))
    w.add_kv("clip.vision.image_mean", np.asarray(
        image_mean or (0.48145466, 0.4578275, 0.40821073), np.float32))
    w.add_kv("clip.vision.image_std", np.asarray(
        image_std or (0.26862954, 0.26130258, 0.27577711), np.float32))
    if image_grid_pinpoints:  # llava-1.6 anyres
        flat = np.asarray(image_grid_pinpoints, np.int32).reshape(-1)
        w.add_kv("clip.vision.image_grid_pinpoints", flat)
    if mm_patch_merge_type:
        w.add_kv("clip.vision.mm_patch_merge_type", mm_patch_merge_type)

    skip = {"vision_model.embeddings.position_ids",
            # llava uses the penultimate features; post_ln never runs
            # (should_skip_tensor, convert_image_encoder_to_gguf.py:27)
            "vision_model.post_layernorm.weight",
            "vision_model.post_layernorm.bias"}
    # the final encoder layer is beyond block_count and never loaded —
    # don't ship its dead weight
    last = f"vision_model.encoder.layers.{int(cfg.num_hidden_layers) - 1}."
    for name, tensor in vision_model.state_dict().items():
        if name in skip or name.startswith(last):
            continue
        data = np.asarray(tensor.detach().cpu().numpy(), np.float32)
        w.add_tensor(map_name(name), np.ascontiguousarray(data))
    for name, data in (projector or {}).items():
        w.add_tensor(name, np.ascontiguousarray(
            np.asarray(data, np.float32)))
    w.write()
    print(f"wrote {output}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-convert-image-encoder",
                                 description=__doc__)
    ap.add_argument("-m", "--model", required=True,
                    help="HF CLIP model directory or hub id")
    ap.add_argument("--projector",
                    help="llava projector state dict (.bin/.safetensors; "
                         "keys multi_modal_projector.linear_{1,2}.*)")
    ap.add_argument("-o", "--output", default="mmproj.gguf")
    ap.add_argument("--use-gelu", action="store_true",
                    help="plain GELU instead of CLIP's quick-gelu")
    ap.add_argument("--projector-type", default="mlp",
                    choices=["mlp", "mlp_norm"])
    ap.add_argument("--image-grid-pinpoints", default=None,
                    help="llava-1.6 anyres resolutions as JSON, e.g. "
                         '"[[336,672],[672,336]]"')
    ap.add_argument("--mm-patch-merge-type", default=None,
                    choices=[None, "flat", "spatial_unpad"])
    args = ap.parse_args(argv)

    from transformers import CLIPVisionModel

    vm = CLIPVisionModel.from_pretrained(args.model)
    proj = None
    if args.projector:
        if args.projector.endswith(".safetensors"):
            from safetensors.numpy import load_file

            sd = load_file(args.projector)
        else:
            import torch

            sd = {k: v.numpy() for k, v in
                  torch.load(args.projector, map_location="cpu").items()}
        # llava HF naming -> mm.N wire naming
        ren = {"multi_modal_projector.linear_1": "mm.0",
               "multi_modal_projector.linear_2": "mm.2",
               "model.mm_projector.0": "mm.0", "model.mm_projector.2": "mm.2"}
        proj = {}
        for k, v in sd.items():
            base, leaf = k.rsplit(".", 1)
            proj[ren.get(base, base) + "." + leaf] = v
    pinpoints = None
    if args.image_grid_pinpoints:
        import json

        pinpoints = json.loads(args.image_grid_pinpoints)
    convert(vm, args.output, projector=proj, use_gelu=args.use_gelu,
            projector_type=args.projector_type,
            image_grid_pinpoints=pinpoints,
            mm_patch_merge_type=args.mm_patch_merge_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
