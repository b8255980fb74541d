"""prima-gen-docs — generate CLI documentation from the tools themselves.

The examples/gen-docs analogue: walks every runnable tool module, captures
its --help output, and writes one markdown file per tool plus an index.

Usage: python -m prima_tpu_torch.tools.gen_docs [-o docs/cli_torch]
"""

from __future__ import annotations

import argparse
import importlib
import io
import os
import sys
from contextlib import redirect_stderr, redirect_stdout

TOOLS = [
    "cli", "cli_distributed", "batched", "batched_bench", "bench_tool",
    "convert_hf", "convert_image_encoder", "convert_llama2c",
    "cvector_generator", "embedding", "eval_callback", "export_lora",
    "gbnf_validator", "gguf_hash", "gguf_split", "gritlm", "imatrix",
    "infill", "llava_cli", "lookahead", "lookup", "parallel", "passkey",
    "perplexity", "profile_tool", "quantize", "quantize_stats",
    "retrieval", "ring_serve", "simple", "speculative", "tokenize",
]
SERVER = "prima_tpu_torch.server"


def capture_help(module: str, prog: str):
    """-> (module object | None, help text | None): import the module and
    capture argparse --help (SystemExit 0)."""
    old_argv = sys.argv
    sys.argv = [prog, "--help"]
    out = io.StringIO()
    try:
        with redirect_stdout(out), redirect_stderr(out):
            mod = importlib.import_module(module)
            main = getattr(mod, "main", None)
            if main is None:
                return mod, None
            try:
                main(["--help"])
            except SystemExit:
                pass
    except Exception as e:  # noqa: BLE001 — skip tools with import issues
        return None, f"(help unavailable: {e})"
    finally:
        sys.argv = old_argv
    return mod, out.getvalue()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-gen-docs", description=__doc__)
    ap.add_argument("-o", "--output-dir", default="docs/cli_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    index = ["# prima-tpu command-line tools (prima_tpu_torch)", "",
             "Generated by `python -m prima_tpu_torch.tools.gen_docs`.", ""]
    entries = [(f"prima_tpu_torch.tools.{t}", t) for t in TOOLS]
    entries.append((SERVER + ".__main__", "server"))
    for module, name in entries:
        shown = module.removesuffix(".__main__")
        mod, text = capture_help(module, f"python -m {shown}")
        if not text:
            continue
        doc = (mod.__doc__ or "").strip() if mod is not None else ""
        path = os.path.join(args.output_dir, f"{name}.md")
        with open(path, "w") as f:
            f.write(f"# `python -m {shown}`\n\n")
            if doc:
                f.write(doc + "\n\n")
            f.write("```\n" + text.rstrip() + "\n```\n")
        first = doc.splitlines()[0] if doc else ""
        index.append(f"- [{name}]({name}.md) — {first}")
    with open(os.path.join(args.output_dir, "README.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print(f"wrote {len(entries)} tool docs to {args.output_dir}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
