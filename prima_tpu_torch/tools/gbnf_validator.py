"""prima-gbnf-validator — check an input string against a GBNF grammar.

Counterpart of prima_tpu/tools/gbnf_validator.py over the port's grammar/:
a host tool (no model, no device), the same output from the same inputs.

The llama-gbnf-validator analogue (reference examples/gbnf-validator): parse
the grammar, feed the input bytes through the matcher, and report either
acceptance or the furthest byte offset reached before failure.

Usage: python -m prima_tpu_torch.tools.gbnf_validator grammar.gbnf input.txt
"""

from __future__ import annotations

import argparse
import sys


def validate(grammar_text: str, data: bytes) -> tuple[bool, int]:
    """Returns (valid, furthest_accepted_offset)."""
    from ..grammar.engine import GrammarMatcher
    from ..grammar.gbnf import parse_gbnf

    g = parse_gbnf(grammar_text)
    m = GrammarMatcher(g)
    for i in range(len(data)):
        if not m.advance_text(data[i : i + 1]):
            return False, i
    return m.is_complete(), len(data)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-gbnf-validator", description=__doc__)
    ap.add_argument("grammar", help="GBNF grammar file")
    ap.add_argument("input", help="input text file to validate")
    args = ap.parse_args(argv)

    grammar_text = open(args.grammar).read()
    data = open(args.input, "rb").read()
    ok, pos = validate(grammar_text, data)
    if ok:
        print("Input string is valid according to the grammar.")
        return 0
    text = data.decode("utf-8", errors="replace")
    print("Input string is invalid according to the grammar.")
    print(f"Parse failed at byte offset {pos}:")
    lo, hi = max(0, pos - 40), min(len(text), pos + 10)
    print(f"  ...{text[lo:pos]}<<<HERE>>>{text[pos:hi]}...")
    return 1


if __name__ == "__main__":
    sys.exit(main())
