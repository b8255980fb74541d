"""JSON-schema -> GBNF grammar converter.

The analogue of the reference's common/json-schema-to-grammar.cpp (used by
the server's response_format/json_schema support and the CLI --json-schema
flag). Supports: type (object/array/string/number/integer/boolean/null),
properties + required + additionalProperties, items (single schema),
enum / const, oneOf / anyOf, $ref to #/definitions and #/$defs, and
minItems/maxItems (small bounds, expanded structurally).
"""

from __future__ import annotations

import json
from typing import Any

SPACE_RULE = '" "?'

_PRIMITIVES: dict[str, str] = {
    "boolean": '("true" | "false") space',
    "number": '("-"? ([0-9] | [1-9] [0-9]*)) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? space',
    "integer": '("-"? ([0-9] | [1-9] [0-9]*)) space',
    "string": '"\\"" char* "\\"" space',
    "null": '"null" space',
    "char": '[^"\\\\\\x7F\\x00-\\x1F] | "\\\\" (["\\\\bfnrt] | "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F])',
    "value": "object | array | string | number | boolean | null",
    "object": '"{" space ( string ":" space value ("," space string ":" space value)* )? "}" space',
    "array": '"[" space ( value ("," space value)* )? "]" space',
}


def _format_literal(value: Any) -> str:
    """A JSON value as a GBNF string literal."""
    s = json.dumps(value)
    out = []
    for ch in s:
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif ch == "\n":
            out.append("\\n")
        else:
            out.append(ch)
    return '"' + "".join(out) + '"'


class SchemaConverter:
    def __init__(self, schema: dict):
        self.schema = schema
        self.rules: dict[str, str] = {"space": SPACE_RULE}
        self._names: set[str] = {"space"}

    def _add_rule(self, name: str, body: str) -> str:
        name = "".join(c if c.isalnum() or c == "-" else "-" for c in name) or "rule"
        base, i = name, 0
        while name in self._names and self.rules.get(name) != body:
            i += 1
            name = f"{base}{i}"
        self._names.add(name)
        self.rules[name] = body
        return name

    _PRIM_DEPS = {
        "string": ("char",),
        "value": ("object", "array", "string", "number", "boolean", "null"),
        "object": ("string", "value"),
        "array": ("value",),
    }

    def _primitive(self, name: str) -> str:
        if name not in self.rules:
            self.rules[name] = _PRIMITIVES[name]
            self._names.add(name)
            for dep in self._PRIM_DEPS.get(name, ()):
                self._primitive(dep)
        return name

    def _resolve_ref(self, ref: str) -> dict:
        if not ref.startswith("#/"):
            raise ValueError(f"only local $refs supported: {ref}")
        node: Any = self.schema
        for part in ref[2:].split("/"):
            node = node[part]
        return node

    def visit(self, schema: dict | bool, name: str) -> str:
        if schema is True or schema == {}:
            return self._primitive("value")
        if schema is False:
            return self._add_rule(name, '"\\"__never__\\""')

        if "$ref" in schema:
            # prefix keeps user definition names out of the primitive-rule
            # namespace (a $defs entry named "string" must not hijack it)
            target = "def-" + schema["$ref"].rsplit("/", 1)[-1]
            if target in self._names:
                return target
            self._names.add(target)  # reserve to break recursion
            resolved = self._resolve_ref(schema["$ref"])
            body_name = self.visit(resolved, target + "-body")
            self.rules[target] = body_name
            return target

        if "const" in schema:
            return self._add_rule(name, _format_literal(schema["const"]) + " space")
        if "enum" in schema:
            body = " | ".join(_format_literal(v) for v in schema["enum"])
            return self._add_rule(name, f"({body}) space")
        if "oneOf" in schema or "anyOf" in schema:
            alts = schema.get("oneOf") or schema.get("anyOf")
            parts = [self.visit(a, f"{name}-{i}") for i, a in enumerate(alts)]
            return self._add_rule(name, " | ".join(parts))

        t = schema.get("type")
        if isinstance(t, list):
            parts = [self.visit({**schema, "type": ti}, f"{name}-{ti}") for ti in t]
            return self._add_rule(name, " | ".join(parts))

        if t == "object" and "properties" in schema:
            required = set(schema.get("required", []))
            props = list(schema["properties"].items())
            return self._add_rule(name, _object_body(props, required, self))

        if t == "array":
            items = schema.get("items", True)
            item_rule = self.visit(items, f"{name}-item")
            min_items = int(schema.get("minItems", 0))
            max_items = schema.get("maxItems")
            if min_items == 0 and max_items is None:
                body = f'"[" space ({item_rule} ("," space {item_rule})*)? "]" space'
            elif min_items >= 1:
                head = ' "," space '.join([item_rule] * min_items)
                if max_items is None:
                    tail = f'("," space {item_rule})*'
                else:
                    tail = " ".join([f'("," space {item_rule})?'] * (int(max_items) - min_items))
                body = f'"[" space {head} {tail} "]" space'
            elif int(max_items) == 0:  # only the empty array is valid
                body = '"[" space "]" space'
            else:  # minItems 0, bounded maxItems
                n_opt = max(int(max_items) - 1, 0)
                tail = " ".join([f'("," space {item_rule})?'] * n_opt)
                body = f'"[" space ({item_rule} {tail})? "]" space'
            return self._add_rule(name, body)

        if t in ("string",):
            if "pattern" in schema:
                content = _regex_to_gbnf(schema["pattern"], self)
                return self._add_rule(name, f'"\\"" {content} "\\"" space')
            min_len = int(schema.get("minLength", 0))
            max_len = schema.get("maxLength")
            if min_len or max_len is not None:
                self._primitive("char")
                if max_len is not None:
                    rep = f"char{{{min_len},{int(max_len)}}}"
                elif min_len:
                    rep = f"char{{{min_len},}}"
                return self._add_rule(name, f'"\\"" {rep} "\\"" space')
            return self._primitive("string")
        if t in ("number", "integer", "boolean", "null"):
            return self._primitive(t)
        if t == "object" or t is None:
            return self._primitive("value" if t is None else "object")
        raise ValueError(f"unsupported schema: {schema!r}")

    def to_gbnf(self) -> str:
        root = self.visit(self.schema, "root")
        if root != "root":
            self.rules["root"] = root
        lines = [f"{n} ::= {b}" for n, b in self.rules.items()]
        return "\n".join(lines) + "\n"


def _object_body(props, required, conv: "SchemaConverter") -> str:
    kvs = []
    for key, sub in props:
        rule = conv.visit(sub, f"prop-{key}")
        kvs.append((key, f'{_format_literal(key)} space ":" space {rule}', key in required))

    req = [kv for kv in kvs if kv[2]]
    opt = [kv for kv in kvs if not kv[2]]
    parts = []
    if req:
        parts.append(req[0][1])
        for _, kv, _r in req[1:]:
            parts.append(f'"," space {kv}')
        for _, kv, _r in opt:
            parts.append(f'("," space {kv})?')
        inner = " ".join(parts)
        return f'"{{" space {inner} "}}" space'
    if opt:
        # all optional: ANY non-empty subset in declaration order —
        # U_i ::= kv_i ("," space (U_{i+1} | ... | U_n))?  (the reference
        # converter's optional-subset alternation)
        u_names: list[str] = [""] * len(opt)
        for i in range(len(opt) - 1, -1, -1):
            key, kv, _r = opt[i]
            tail = ""
            if i + 1 < len(opt):
                alts = " | ".join(u_names[i + 1:])
                tail = f' ("," space ({alts}))?'
            u_names[i] = conv._add_rule(f"opt-{key}", kv + tail)
        inner = " | ".join(u_names)
        return f'"{{" space ({inner})? "}}" space'
    return '"{" space "}" space'


def _regex_to_gbnf(pattern: str, conv: "SchemaConverter") -> str:
    """Translate a JSON-schema regex `pattern` into a GBNF fragment for the
    string *content* (the reference's _visit_pattern, common/
    json-schema-to-grammar.cpp:424). Supported subset: literals, '.', char
    classes, groups, alternation, and the * + ? {m,n} quantifiers — these
    map 1:1 onto GBNF. Anchors ^...$ make the match exact; without them the
    pattern may appear anywhere in the string (JSON-schema semantics)."""
    anchored = pattern.startswith("^") and pattern.endswith("$")
    body = pattern[1:-1] if anchored else pattern

    _ESCAPES = {
        "d": "[0-9]", "D": '[^0-9]',
        "w": "[0-9a-zA-Z_]", "W": "[^0-9a-zA-Z_]",
        "s": "[ \\t\\n\\r]", "S": "[^ \\t\\n\\r]",
    }
    pos = 0

    def lit(ch: str) -> str:
        return '"' + ch.replace("\\", "\\\\").replace('"', '\\"') + '"'

    def parse_alt() -> str:
        parts = [parse_seq()]
        nonlocal pos
        while pos < len(body) and body[pos] == "|":
            pos += 1
            parts.append(parse_seq())
        return " | ".join(p or '""' for p in parts)

    def parse_seq() -> str:
        nonlocal pos
        out = []
        while pos < len(body) and body[pos] not in "|)":
            atom = parse_atom()
            if pos < len(body) and body[pos] in "*+?":
                atom = f"{atom}{body[pos]}"
                pos += 1
            elif pos < len(body) and body[pos] == "{":
                end = body.index("}", pos)
                atom = f"{atom}{body[pos:end + 1]}"
                pos = end + 1
            out.append(atom)
        return " ".join(out)

    def parse_atom() -> str:
        nonlocal pos
        c = body[pos]
        if c == "(":
            pos += 1
            inner = parse_alt()
            if pos >= len(body) or body[pos] != ")":
                raise ValueError(f"unbalanced group in pattern {pattern!r}")
            pos += 1
            return f"({inner})"
        if c == "[":
            end = pos
            while True:
                end = body.index("]", end + 1)
                if body[end - 1] != "\\":
                    break
            cls = body[pos : end + 1]
            pos = end + 1
            # regex shorthand escapes are NOT GBNF class syntax — expand
            # \d/\w/\s to their ranges (negated forms are inexpressible as
            # positive ranges inside a class)
            for esc in ("\\D", "\\W", "\\S"):
                if esc in cls:
                    raise ValueError(
                        f"unsupported {esc} inside class in pattern {pattern!r}")
            cls = (cls.replace("\\d", "0-9")
                      .replace("\\w", "0-9a-zA-Z_")
                      .replace("\\s", " \\t\\n\\r"))
            return cls
        if c == ".":
            pos += 1
            return conv._primitive("char")
        if c == "\\":
            esc = body[pos + 1]
            pos += 2
            if esc in _ESCAPES:
                return _ESCAPES[esc]
            return lit(esc)
        pos += 1
        return lit(c)

    frag = parse_alt()
    if pos != len(body):
        raise ValueError(f"trailing regex syntax in pattern {pattern!r}")
    if not anchored:
        any_ = conv._primitive("char")
        frag = f"{any_}* ({frag}) {any_}*"
    return f"({frag})"


def json_schema_to_gbnf(schema: dict | str) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    return SchemaConverter(schema).to_gbnf()
