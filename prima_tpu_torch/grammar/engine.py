"""Grammar-constrained decoding engine.

Pushdown matching over nondeterministic stacks, the same model as the
reference's llama_grammar (src/llama-grammar.cpp): a set of stacks, each a
sequence of pending grammar positions; a codepoint advances every stack
whose top matches; a token is admissible iff at least one stack survives all
its codepoints. Token pieces may end mid-UTF-8-sequence, so a byte carry is
kept per hypothetical advance (llama_grammar's partial-utf8 handling).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .gbnf import Grammar, parse_gbnf

# a "position" is (rule_id, alt_idx, sym_idx); a stack is a tuple of positions
# with the TOP at the end. Matching consumes the top's symbol.


def _partial_cp_range(partial: bytes) -> tuple[int, int]:
    """Codepoint range a pending partial UTF-8 sequence could complete to.
    Returns an empty range (1, 0) for prefixes no VALID UTF-8 sequence can
    extend (bad continuation bytes, guaranteed-overlong encodings)."""
    b0 = partial[0]
    if b0 >= 0xF5 or b0 < 0xC2:  # invalid lead (incl. overlong C0/C1)
        return 1, 0
    if b0 >= 0xF0:
        total, val, cp_min = 4, b0 & 0x07, 0x10000
    elif b0 >= 0xE0:
        total, val, cp_min = 3, b0 & 0x0F, 0x800
    else:
        total, val, cp_min = 2, b0 & 0x1F, 0x80
    for b in partial[1:]:
        if not (0x80 <= b <= 0xBF):
            return 1, 0
        val = (val << 6) | (b & 0x3F)
    rem = total - len(partial)
    lo = val << (6 * rem)
    hi = lo | ((1 << (6 * rem)) - 1)
    lo = max(lo, cp_min)  # overlong encodings are invalid
    if hi > 0x10FFFF:
        hi = 0x10FFFF
    return lo, hi


class GrammarMatcher:
    def __init__(self, g: Grammar, root: str | int | None = None):
        self.g = g
        self.root = g.names[root] if isinstance(root, str) else (root if root is not None else g.root)
        self.reset()

    # -- stack mechanics ------------------------------------------------------

    def _expand(self, stack: tuple, _depth: int = 0) -> list[tuple]:
        """Expand until the top symbol is a char class (or the stack is empty,
        meaning the grammar accepts the end of input)."""
        if _depth > 512:
            # left-recursive or pathologically nested grammar: fail with a
            # catchable error like the reference's left-recursion detection
            from .gbnf import GBNFError

            raise GBNFError("grammar expansion too deep (left recursion?)")
        if not stack:
            return [stack]
        rid, alt, idx = stack[-1]
        seq = self.g.rules[rid][alt]
        if idx >= len(seq):  # this frame exhausted: pop and continue parent
            return self._expand(stack[:-1], _depth + 1)
        sym = seq[idx]
        if sym[0] == "char":
            return [stack]
        # rule ref: advance this frame past the ref, push each alternate
        out = []
        base = stack[:-1] + ((rid, alt, idx + 1),)
        target = sym[1]
        for a in range(len(self.g.rules[target])):
            out.extend(self._expand(base + ((target, a, 0),), _depth + 1))
        return out

    def _advance_char(self, stacks: frozenset, cp: int) -> frozenset:
        nxt = set()
        for stack in stacks:
            if not stack:
                continue  # already complete; cannot consume more
            rid, alt, idx = stack[-1]
            sym = self.g.rules[rid][alt][idx]
            _, ranges, neg = sym
            hit = any(lo <= cp <= hi for lo, hi in ranges)
            if hit != neg:
                for s in self._expand(stack[:-1] + ((rid, alt, idx + 1),)):
                    nxt.add(s)
        return frozenset(nxt)

    # -- public API -----------------------------------------------------------

    def reset(self) -> None:
        init = set()
        for a in range(len(self.g.rules[self.root])):
            init.update(self._expand(((self.root, a, 0),)))
        self.stacks: frozenset = frozenset(init)
        self.partial = b""  # carry for split UTF-8 sequences
        self._admissible_cache: dict = {}

    def advance_text(self, data: bytes) -> bool:
        """Consume bytes; returns False if the text is rejected."""
        stacks, partial = self._try_advance(self.stacks, self.partial, data)
        if stacks is None:
            return False
        self.stacks, self.partial = stacks, partial
        self._admissible_cache = {}
        return True

    def _try_advance(self, stacks: frozenset, partial: bytes, data: bytes):
        buf = partial + data
        # decode complete codepoints, keep trailing partial sequence: scan
        # BACKWARD for the last lead byte — only ITS sequence can be cut off
        end = len(buf)
        cut = end
        for i in range(end - 1, max(-1, end - 5), -1):
            b = buf[i]
            if b < 0x80:
                break  # ASCII: everything before is complete
            if b >= 0xC0:  # lead byte of the trailing sequence
                need = 2 if b < 0xE0 else 3 if b < 0xF0 else 4
                if i + need > end:
                    cut = i
                break
        try:
            text = buf[:cut].decode("utf-8")
        except UnicodeDecodeError:
            return None, b""
        for ch in text:
            stacks = self._advance_char(stacks, ord(ch))
            if not stacks:
                return None, b""
        rest = buf[cut:]
        if rest:
            # partial-char feasibility (llama_grammar_match_partial_char):
            # some completion of the pending bytes must satisfy at least one
            # stack's next char class, else the text is already dead
            lo, hi = _partial_cp_range(rest)
            live = frozenset(
                s for s in stacks
                if s and self._class_intersects(s, lo, hi)
            )
            if not live:
                return None, b""
            stacks = live
        return stacks, rest

    def _class_intersects(self, stack: tuple, lo: int, hi: int) -> bool:
        if lo > hi:  # dead UTF-8 partial (e.g. overlong prefix): no feasible
            return False  # completion exists
        rid, alt, idx = stack[-1]
        _, ranges, neg = self.g.rules[rid][alt][idx]
        if not neg:
            return any(a <= hi and b >= lo for a, b in ranges)
        # negated: is any cp in [lo, hi] outside the union of ranges?
        covered = 0
        pos = lo
        for a, b in sorted(r for r in ranges if r[0] <= hi and r[1] >= lo):
            a, b = max(a, pos), min(b, hi)
            if b >= a:
                covered += b - a + 1
                pos = b + 1
        return covered < hi - lo + 1

    def is_complete(self) -> bool:
        return any(len(s) == 0 for s in self.stacks) and not self.partial

    def accepts_bytes(self, data: bytes) -> bool:
        stacks, _ = self._try_advance(self.stacks, self.partial, data)
        return stacks is not None and len(stacks) > 0


class GrammarSampler:
    """Vocab-aware wrapper used by the sampler chain (the reference's
    llama_sampler_grammar + gpt_sampler grammar fast path)."""

    def __init__(self, grammar_text: str, token_bytes: list[bytes],
                 eog_ids: set[int] | None = None, root: str = "root"):
        self.matcher = GrammarMatcher(parse_gbnf(grammar_text), root)
        self.token_bytes = token_bytes
        self.eog_ids = eog_ids or set()
        self._mask_cache: dict = {}

    def reset(self) -> None:
        self.matcher.reset()
        self._mask_cache.clear()

    def accept(self, token: int) -> None:
        if token in self.eog_ids:
            return
        ok = self.matcher.advance_text(self.token_bytes[token])
        if not ok:
            raise ValueError(f"token {token} rejected by grammar")

    def accepts(self, token: int) -> bool:
        if token in self.eog_ids:
            return self.matcher.is_complete()
        data = self.token_bytes[token]
        if not data:
            return False
        return self.matcher.accepts_bytes(data)

    def _admissible(self, t: int, complete: bool) -> bool:
        if t in self.eog_ids:
            return complete
        data = self.token_bytes[t]
        if not data:
            return False
        st, _ = self.matcher._try_advance(self.matcher.stacks, self.matcher.partial, data)
        return st is not None and len(st) > 0

    def apply(self, logits: np.ndarray, limit: int = 2048) -> None:
        """Mask inadmissible tokens to -inf (in place).

        Cost control (the reference samples first and only constrains on
        rejection, common/sampling.cpp): by default only the top-`limit`
        logits are tested; if none of them is admissible, fall back to a
        full-vocab scan so a valid token always survives."""
        key = (self.matcher.stacks, self.matcher.partial)
        mask = self._mask_cache.get(key)
        n = len(self.token_bytes)
        if mask is None:
            complete = self.matcher.is_complete()
            mask = np.zeros(n, dtype=bool)
            if limit and limit < n:
                cand = np.argpartition(-logits, limit)[:limit]
            else:
                cand = range(n)
            any_ok = False
            for t in cand:
                if self._admissible(int(t), complete):
                    mask[t] = True
                    any_ok = True
            if not any_ok:  # full scan fallback
                for t in range(n):
                    mask[t] = self._admissible(t, complete)
                self._mask_cache[key] = mask  # full masks are state-exact
        logits[~mask] = -np.inf
