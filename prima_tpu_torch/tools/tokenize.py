"""prima-tokenize — print the tokenization of a prompt.

Counterpart of prima_tpu/tools/tokenize.py: a host tool (the GGUF's
vocabulary only, no device), the same output from the same inputs.

The llama-tokenize analogue (reference examples/tokenize): loads only the
vocabulary from a GGUF and prints one `id -> 'piece'` row per token.

Usage: python -m prima_tpu_torch.tools.tokenize -m model.gguf -p "text"
           [--ids] [--no-bos] [--show-count] [--stdin] [-f FILE]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-tokenize", description=__doc__)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default=None)
    ap.add_argument("-f", "--file")
    ap.add_argument("--stdin", action="store_true")
    ap.add_argument("--ids", action="store_true",
                    help="print a bare CSV of token ids")
    ap.add_argument("--no-bos", action="store_true")
    ap.add_argument("--no-parse-special", action="store_true")
    ap.add_argument("--show-count", action="store_true")
    args = ap.parse_args(argv)

    if args.stdin:
        text = sys.stdin.read()
    elif args.file:
        text = open(args.file).read()
    elif args.prompt is not None:
        text = args.prompt
    else:
        ap.error("one of -p / -f / --stdin required")

    from ..gguf.reader import GGUFModel
    from ..tokenizer import Tokenizer

    m = GGUFModel.open(args.model)
    tok = Tokenizer.from_gguf(m)
    m.close()
    ids = tok.encode(text, add_special=not args.no_bos,
                     parse_special=not args.no_parse_special)
    if args.ids:
        print("[" + ", ".join(str(i) for i in ids) + "]")
    else:
        for i in ids:
            piece = tok.decode_token_bytes(i).decode("utf-8", errors="replace")
            print(f"{i:>7} -> '{piece}'")
    if args.show_count:
        print(f"Total number of tokens: {len(ids)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
