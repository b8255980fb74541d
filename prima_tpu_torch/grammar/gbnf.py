"""GBNF grammar parser.

Parses the reference's GBNF dialect (src/llama-grammar.cpp, grammars/*.gbnf):
rules `name ::= alternates`, literals with escapes, char classes with ranges
and negation, rule references, grouping, postfix * + ?, alternation, and
# comments. Compiles to flat rules: each rule is a list of alternates; each
alternate a tuple of symbols:

    ("char", ((lo, hi), ...), negated)   — codepoint class
    ("ref", rule_id)                     — rule reference

Postfix operators expand to synthetic rules (S* -> R ::= S R | ε etc.), the
same desugaring the reference performs at parse time.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Grammar:
    rules: list[list[tuple]]  # rules[rule_id] = [alternate, ...]
    names: dict[str, int]
    root: int

    def rule_name(self, rid: int) -> str:
        for n, i in self.names.items():
            if i == rid:
                return n
        return f"<{rid}>"


class GBNFError(ValueError):
    pass


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0
        self.rules: list[list[tuple]] = []
        self.names: dict[str, int] = {}

    # -- low-level ----------------------------------------------------------

    def _ws(self, newlines: bool = True):
        while self.pos < len(self.src):
            c = self.src[self.pos]
            if c == "#":  # comment to end of line
                while self.pos < len(self.src) and self.src[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            else:
                break

    def _peek(self) -> str:
        return self.src[self.pos] if self.pos < len(self.src) else ""

    def _expect(self, s: str):
        if not self.src.startswith(s, self.pos):
            raise GBNFError(f"expected {s!r} at {self.pos}: ...{self.src[self.pos:self.pos+20]!r}")
        self.pos += len(s)

    def _name(self) -> str:
        start = self.pos
        while (c := self._peek()) and (c.isalnum() or c in "-_"):
            self.pos += 1
        if start == self.pos:
            raise GBNFError(f"expected rule name at {self.pos}")
        return self.src[start : self.pos]

    def _rule_id(self, name: str) -> int:
        if name not in self.names:
            self.names[name] = len(self.rules)
            self.rules.append([])
        return self.names[name]

    def _new_rule(self, alternates: list[tuple]) -> int:
        rid = len(self.rules)
        self.rules.append(alternates)
        return rid

    def _escape(self) -> int:
        c = self._peek()
        self.pos += 1
        if c == "x":
            h = self.src[self.pos : self.pos + 2]
            self.pos += 2
            return int(h, 16)
        if c == "u":
            h = self.src[self.pos : self.pos + 4]
            self.pos += 4
            return int(h, 16)
        if c == "U":
            h = self.src[self.pos : self.pos + 8]
            self.pos += 8
            return int(h, 16)
        return {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91, "]": 93}.get(c, ord(c))

    def _char(self) -> int:
        c = self._peek()
        if c == "\\":
            self.pos += 1
            return self._escape()
        self.pos += 1
        return ord(c)

    # -- grammar constructs ---------------------------------------------------

    def _literal(self) -> list[tuple]:
        self._expect('"')
        out = []
        while self._peek() != '"':
            if not self._peek():
                raise GBNFError("unterminated string literal")
            cp = self._char()
            out.append(("char", ((cp, cp),), False))
        self.pos += 1
        return out

    def _char_class(self) -> tuple:
        self._expect("[")
        neg = False
        if self._peek() == "^":
            neg = True
            self.pos += 1
        ranges = []
        while self._peek() != "]":
            if not self._peek():
                raise GBNFError("unterminated char class")
            lo = self._char()
            hi = lo
            if self._peek() == "-" and self.src[self.pos + 1 : self.pos + 2] != "]":
                self.pos += 1
                hi = self._char()
            ranges.append((lo, hi))
        self.pos += 1
        return ("char", tuple(ranges), neg)

    def _sequence(self, nested: bool = False) -> list[tuple]:
        seq: list[tuple] = []
        while True:
            # a newline ends a top-level rule body but is plain whitespace
            # inside a parenthesized group (parse_space's is_nested flag)
            self._ws(newlines=nested)
            c = self._peek()
            if c == '"':
                syms = self._literal()
            elif c == "[":
                syms = [self._char_class()]
            elif c == "(":
                self.pos += 1
                alts = self._alternates(nested=True)
                self._expect(")")
                syms = [("ref", self._new_rule(alts))]
            elif c and (c.isalnum() or c in "-_"):
                save = self.pos
                name = self._name()
                self._ws(newlines=False)
                if self.src.startswith("::=", self.pos):
                    self.pos = save  # next rule definition, not a reference
                    break
                syms = [("ref", self._rule_id(name))]
            else:
                break
            # postfix operator applies to the whole preceding symbol — for a
            # string literal that is the ENTIRE literal, as in the reference
            # (llama-grammar.cpp parse_sequence: last_sym_start marks the
            # start of the full literal before handle_repetitions)
            self._ws(newlines=False)
            op = self._peek()
            if op and op in "*+?{":
                body = tuple(syms)
                if op == "{":
                    m, n = self._braces()
                else:
                    self.pos += 1
                    m, n = {"*": (0, None), "+": (1, None), "?": (0, 1)}[op]
                syms = self._repeat(body, m, n)
            seq.extend(syms)
        return seq

    def _braces(self) -> tuple[int, int | None]:
        """{n} exact, {m,} at least, {m,n} range (llama-grammar.cpp:444-480)."""
        self._expect("{")
        self._ws(newlines=False)
        start = self.pos
        while self._peek().isdigit():
            self.pos += 1
        first = self.src[start : self.pos]
        self._ws(newlines=False)
        if self._peek() == "}":
            self.pos += 1
            if not first:
                raise GBNFError(f"empty {{}} repetition at {start}")
            return int(first), int(first)
        self._expect(",")
        self._ws(newlines=False)
        start = self.pos
        while self._peek().isdigit():
            self.pos += 1
        second = self.src[start : self.pos]
        self._ws(newlines=False)
        self._expect("}")
        m = int(first) if first else 0
        n = int(second) if second else None
        if n is not None and n < m:
            raise GBNFError(f"invalid repetition range {{{m},{n}}}")
        return m, n

    def _repeat(self, body: tuple, m: int, n: int | None) -> list[tuple]:
        """body{m,n} -> m copies + (n-m) nested optionals (or a star rule
        when unbounded), the reference's handle_repetitions desugaring."""
        syms: list[tuple] = list(body) * m
        if n is None:
            rid = self._new_rule([])
            self.rules[rid] = [body + (("ref", rid),), ()]
            syms.append(("ref", rid))
        else:
            rid = None
            for _ in range(n - m):
                tail = (("ref", rid),) if rid is not None else ()
                rid = self._new_rule([body + tail, ()])
            if rid is not None:
                syms.append(("ref", rid))
        return syms

    def _alternates(self, nested: bool = False) -> list[tuple]:
        alts = [tuple(self._sequence(nested))]
        self._ws(newlines=nested)
        while self._peek() == "|":
            self.pos += 1
            self._ws()  # newline allowed after '|' (parse_space(.., true))
            alts.append(tuple(self._sequence(nested)))
            self._ws(newlines=nested)
        return alts

    def parse(self) -> Grammar:
        self._ws()
        while self.pos < len(self.src):
            name = self._name()
            self._ws(newlines=False)
            self._expect("::=")
            self._ws()  # newline allowed right after '::=' (parse_rule)
            rid = self._rule_id(name)
            self.rules[rid] = self._alternates()
            self._ws()
        if "root" not in self.names:
            raise GBNFError("grammar has no 'root' rule")
        for name, rid in self.names.items():
            if not self.rules[rid]:
                raise GBNFError(f"rule {name!r} referenced but never defined")
        return Grammar(self.rules, self.names, self.names["root"])


def parse_gbnf(src: str) -> Grammar:
    return _Parser(src).parse()
