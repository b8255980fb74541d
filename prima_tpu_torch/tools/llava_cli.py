"""prima-llava — multimodal (image + text) chat CLI.

Counterpart of prima_tpu/tools/llava_cli.py on one device (CUDA unless
--device cpu; --matmul kernel|plain stands in for pallas|xla).

The llama-llava-cli analogue (reference examples/llava/llava-cli.cpp):
loads a language GGUF plus an mmproj GGUF (CLIP vision encoder + llava
projector), encodes the image into patch embeddings, splices them into
the prompt at the `<image>` marker through forward(inputs_embeds=), and
generates. On the card a decode step streams the quantized weights
through the GEMV kernel and writes the cache through the KV store kernel;
an image splice (hundreds of rows) takes the dense weight path.

LLaVA-1.5 prompt convention (llava-cli.cpp:150-170): when the prompt has
no <image> marker it is wrapped as

  "USER: <image>\\n{prompt} ASSISTANT:"

Usage: python -m prima_tpu_torch.tools.llava_cli -m model.gguf \\
          --mmproj mmproj.gguf --image photo.jpg -p "describe the image"
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def load_image(path: str) -> np.ndarray:
    """-> (H, W, 3) uint8 RGB. PIL for real formats; .npy passthrough."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        return img
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


class LlavaRuntime:
    """Embedding-splicing decode loop over the bare forward(): prompt
    chunks may be tokens or image patch embeddings (the role of
    llava_eval_image_embed + eval_tokens in llava-cli.cpp:20-64). The KV
    cache is bf16 and every chunk is one forward call, as in the JAX
    runtime; `opts` and `kv` are attributes a caller may replace (f32 for
    token identity against another run)."""

    def __init__(self, model, max_seq: int = 2048, matmul_impl: str = "kernel",
                 device=None):
        import torch

        from .. import resolve_device
        from ..models.llama import ForwardOptions, init_kv_caches

        self.model = model
        self.cfg = model.cfg
        self.device = resolve_device(device)
        self.opts = ForwardOptions(matmul_impl=matmul_impl)
        self.kv = init_kv_caches(self.cfg, 1, max_seq, torch.bfloat16, self.device)
        self.max_seq = max_seq
        self.pos = 0

    def _embed_tokens(self, ids: list[int]):
        """(n, e) f32 token embeddings, on the device."""
        import torch

        from ..models.llama import embed

        toks = torch.as_tensor([ids], dtype=torch.int64, device=self.device)
        return embed(self.model.params["tok_embd"], toks, torch.float32)[0]

    def eval_embeds(self, embeds) -> np.ndarray:
        """Ingest (n, e) embeddings (numpy or a tensor); returns the logits at
        the last position."""
        import torch

        from ..models.llama import forward

        n = embeds.shape[0]
        if self.pos + n > self.max_seq:
            raise ValueError("context overflow")
        dev = self.device
        x = torch.as_tensor(embeds, dtype=torch.float32, device=dev)[None]
        positions = (self.pos + torch.arange(n, dtype=torch.int32, device=dev))[None]
        with torch.no_grad():
            logits, self.kv = forward(
                self.model.params, self.cfg, torch.zeros((1, n), dtype=torch.int64, device=dev),
                positions, self.kv, torch.tensor([self.pos], dtype=torch.int32, device=dev),
                self.opts, inputs_embeds=x)
        self.pos += n
        return logits[0, -1].float().cpu().numpy()

    def eval_tokens(self, ids: list[int]) -> np.ndarray:
        return self.eval_embeds(self._embed_tokens(ids))

    def generate(self, sampler, n_predict: int, logits: np.ndarray,
                 eog_ids: set) -> list[int]:
        out = []
        for _ in range(n_predict):
            tok = sampler.sample_and_accept(logits)
            if tok in eog_ids:
                break  # never emit the EOG token itself
            out.append(tok)
            if self.pos + 1 > self.max_seq:
                break
            logits = self.eval_tokens([tok])
        return out


def main(argv=None) -> int:
    def env(name, default=None):
        return os.environ.get(f"LLAMA_ARG_{name}", default)

    ap = argparse.ArgumentParser(prog="prima-llava", description=__doc__)
    ap.add_argument("-m", "--model", default=env("MODEL"),
                    required=env("MODEL") is None)
    ap.add_argument("--mmproj", required=True)
    ap.add_argument("--image", required=True, action="append",
                    help="image file (repeatable; each fills one <image>)")
    ap.add_argument("-p", "--prompt", default="describe the image in detail")
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("-s", "--seed", type=int, default=-1)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..models.clip import ClipModel
    from ..models.loader import load_model
    from ..sampling import Sampler, SamplerParams

    dev = resolve_device(args.device)
    print(f"loading {args.model} ...", file=sys.stderr)
    model = load_model(args.model, device=dev)
    print(f"loading mmproj {args.mmproj} ...", file=sys.stderr)
    clip = ClipModel.load(args.mmproj, device=dev)

    prompt = args.prompt
    if "<image>" not in prompt:
        prompt = f"USER: <image>\n{prompt} ASSISTANT:"
    parts = prompt.split("<image>")
    if len(parts) - 1 != len(args.image):
        print(f"error: prompt has {len(parts) - 1} <image> markers but "
              f"{len(args.image)} --image args", file=sys.stderr)
        return 1

    rt = LlavaRuntime(model, max_seq=args.ctx_size, matmul_impl=args.matmul, device=dev)
    sampler = Sampler(SamplerParams(
        temp=args.temp, seed=args.seed if args.seed >= 0 else 0xFFFFFFFF,
    ), n_vocab=model.cfg.n_vocab)

    def eval_image(path: str):
        if not clip.cfg.minicpmv_version:
            emb = clip.encode(load_image(path))
            print(f"image: {emb.shape[0]} patch embeddings", file=sys.stderr)
            return rt.eval_embeds(emb)
        # minicpmv: <image>source</image> + <slice> rows of
        # <image>tile</image> with row newlines (minicpmv-cli.cpp:132-162)
        tiles, (gw, gh) = clip.encode_minicpmv(load_image(path))
        print(f"image: {len(tiles)} tiles x {tiles[0].shape[0]} queries "
              f"(grid {gw}x{gh})", file=sys.stderr)

        def toks(s):
            return model.tokenizer.encode(s, add_special=False, parse_special=True)

        logits = rt.eval_tokens(toks("<image>"))
        logits = rt.eval_embeds(tiles[0])
        logits = rt.eval_tokens(toks("</image>"))
        if len(tiles) > 1:
            rt.eval_tokens(toks("<slice>"))
            idx = 1
            for _row in range(gh):
                for col in range(gw):
                    rt.eval_tokens(toks("<image>"))
                    rt.eval_embeds(tiles[idx])
                    idx += 1
                    logits = rt.eval_tokens(toks("</image>" + ("\n" if col == gw - 1 else "")))
            logits = rt.eval_tokens(toks("</slice>"))
        return logits

    logits = None
    for i, text in enumerate(parts):
        if i > 0:  # an image sits between parts[i-1] and parts[i]
            logits = eval_image(args.image[i - 1])
        ids = model.tokenizer.encode(text, add_special=(i == 0))
        if ids:
            logits = rt.eval_tokens(ids)

    out = rt.generate(sampler, args.n_predict, logits, model.eog_ids)
    print(model.tokenizer.decode(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
