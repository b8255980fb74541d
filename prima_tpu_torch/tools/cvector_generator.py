"""prima-cvector-generator — build a control-vector GGUF from prompt pairs.

Counterpart of prima_tpu/tools/cvector_generator.py on one device (CUDA
unless --device cpu; --matmul kernel|plain stands in for pallas|xla).
The llama-cvector-generator analogue (reference examples/cvector-generator):
run matched positive/negative prompts through the model, capture the hidden
state after every layer at the final token, and take the principal component
(PCA via SVD) of the positive-negative differences as that layer's control
direction. Output: a GGUF with `direction.<layer>` tensors (1-indexed, the
llama_control_vector_apply convention) consumable by --control-vector.

Usage: python -m prima_tpu_torch.tools.cvector_generator -m model.gguf \
          [--positive-file pos.txt] [--negative-file neg.txt] [-o out.gguf]

The prompt files hold one prompt per line and must have equal line counts.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

DEFAULT_POSITIVE = ["Act as if you're extremely happy.",
                    "You feel wonderful and full of joy."]
DEFAULT_NEGATIVE = ["Act as if you're extremely sad.",
                    "You feel terrible and full of sorrow."]


def hidden_per_layer(model, prompt: str, matmul: str = "kernel",
                     device="cuda") -> np.ndarray:
    """(n_layers, n_embd): hidden state after each layer at the last token,
    the layers walked one layer_range at a time over an f32 cache with the
    default (bf16) activations, as the JAX tool does; one copy to the host."""
    import torch

    from .. import resolve_device
    from ..models.llama import ForwardOptions, forward, init_kv_caches
    from ..runtime.generate import to_device

    dev = resolve_device(device)
    cfg = model.cfg
    opts = ForwardOptions(matmul_impl=matmul)
    toks = model.tokenizer.encode(prompt, add_special=True, parse_special=True)
    s = len(toks)
    tokens = to_device(np.asarray(toks, np.int64)[None], dev)
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
    kv = init_kv_caches(cfg, 1, s, torch.float32, dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)

    rows, hidden = [], None
    with torch.no_grad():
        for li in range(cfg.n_layers):
            hidden, kv = forward(model.params, cfg, tokens, positions, kv, zero, opts,
                                 layer_range=(li, li + 1), hidden_in=hidden,
                                 return_hidden=True)
            rows.append(hidden[0, -1].float())
    return torch.stack(rows).cpu().numpy()


def pca_directions(diffs: np.ndarray) -> np.ndarray:
    """diffs (n_layers, n_pairs, n_embd) -> (n_layers, n_embd) principal
    directions, sign-aligned with the mean difference."""
    n_layers = diffs.shape[0]
    out = np.empty((n_layers, diffs.shape[2]), np.float32)
    for li in range(n_layers):
        d = diffs[li] - diffs[li].mean(axis=0, keepdims=True) \
            if diffs.shape[1] > 1 else diffs[li]
        _, _, vt = np.linalg.svd(d, full_matrices=False)
        v = vt[0]
        if float(diffs[li].mean(axis=0) @ v) < 0:
            v = -v
        out[li] = v.astype(np.float32)
    return out


def cvector_directions(model, positive: list[str], negative: list[str],
                       matmul: str = "kernel", device="cuda") -> np.ndarray:
    """(n_layers, n_embd) control directions of a loaded model from matched
    prompt pairs."""
    if len(positive) != len(negative):
        raise ValueError("positive/negative prompt counts differ")
    diffs = []
    for pos, neg in zip(positive, negative):
        hp = hidden_per_layer(model, pos, matmul, device)
        hn = hidden_per_layer(model, neg, matmul, device)
        diffs.append(hp - hn)
    return pca_directions(np.stack(diffs, axis=1))


def write_cvector(output: str, directions: np.ndarray, arch: str) -> None:
    from ..gguf.writer import GGUFWriter

    n_layers = directions.shape[0]
    w = GGUFWriter(output, arch="controlvector")
    w.add_kv("general.type", "controlvector")
    w.add_kv("controlvector.model_hint", arch)
    w.add_kv("controlvector.layer_count", n_layers)
    for li in range(n_layers):
        # 1-indexed: direction.i steers the OUTPUT of layer i-1
        w.add_tensor(f"direction.{li + 1}", directions[li])
    w.write()


def generate_cvector(model_path: str, positive: list[str], negative: list[str],
                     output: str, matmul: str = "kernel", device="cuda") -> int:
    from ..models.loader import load_model

    model = load_model(model_path, device=device)
    write_cvector(output, cvector_directions(model, positive, negative, matmul, device),
                  model.cfg.arch)
    return model.cfg.n_layers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-cvector-generator",
                                 description=__doc__)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--positive-file")
    ap.add_argument("--negative-file")
    ap.add_argument("-o", "--output", default="control_vector.gguf")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    pos = (open(args.positive_file).read().splitlines()
           if args.positive_file else DEFAULT_POSITIVE)
    neg = (open(args.negative_file).read().splitlines()
           if args.negative_file else DEFAULT_NEGATIVE)
    pos = [p for p in pos if p.strip()]
    neg = [n for n in neg if n.strip()]
    n = generate_cvector(args.model, pos, neg, args.output, args.matmul, args.device)
    print(f"wrote {n} directions -> {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
