"""prima-pydantic-to-grammar — pydantic models -> GBNF grammar.

The analogue of the reference's examples/pydantic_models_to_grammar.py
(+ json_schema_pydantic_example.py): turn one or more pydantic model
classes into a GBNF grammar that constrains generation to JSON matching
the model, plus a prompt-ready documentation block describing the fields.

Library use:

    from prima_tpu_torch.tools.pydantic_to_grammar import gbnf_for_models
    grammar, docs = gbnf_for_models([MyModel, OtherModel])

CLI use (imports the named classes from a module file):

    python -m prima_tpu_torch.tools.pydantic_to_grammar models.py MyModel Other
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys


def _field_docs(model) -> str:
    """One prompt-ready documentation block per model (the analogue of
    generate_markdown_documentation in the reference example)."""
    schema = model.model_json_schema()
    lines = [f"Model: {model.__name__}"]
    if schema.get("description"):
        lines.append(f"  {schema['description']}")
    required = set(schema.get("required", []))
    for name, prop in schema.get("properties", {}).items():
        typ = prop.get("type") or (
            "enum" if "enum" in prop else prop.get("$ref", "object").rsplit("/", 1)[-1]
        )
        req = "required" if name in required else "optional"
        desc = f" — {prop['description']}" if prop.get("description") else ""
        lines.append(f"  {name} ({typ}, {req}){desc}")
    return "\n".join(lines)


def gbnf_for_models(models) -> tuple[str, str]:
    """(grammar, documentation) for a list of pydantic model classes.

    With one model the grammar matches that model's JSON. With several,
    the root is an alternation — the generator may emit any one of them
    (the reference example's multi-model mode)."""
    from ..grammar.json_schema import json_schema_to_gbnf

    models = list(models)
    if not models:
        raise ValueError("no models given")
    if len(models) == 1:
        schema = models[0].model_json_schema()
    else:
        schema = {"oneOf": [m.model_json_schema() for m in models]}
    docs = "\n\n".join(_field_docs(m) for m in models)
    return json_schema_to_gbnf(schema), docs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-pydantic-to-grammar",
                                 description=__doc__)
    ap.add_argument("module", help="python file defining the pydantic models")
    ap.add_argument("names", nargs="+", help="model class names to include")
    ap.add_argument("--docs", action="store_true",
                    help="also print the field documentation block")
    ap.add_argument("--schema", action="store_true",
                    help="print the JSON schema instead of the grammar")
    args = ap.parse_args(argv)

    spec = importlib.util.spec_from_file_location("user_models", args.module)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    models = [getattr(mod, n) for n in args.names]

    if args.schema:
        schemas = [m.model_json_schema() for m in models]
        print(json.dumps(schemas[0] if len(schemas) == 1 else
                         {"oneOf": schemas}, indent=2))
        return 0
    grammar, docs = gbnf_for_models(models)
    print(grammar)
    if args.docs:
        print("\n" + docs, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
