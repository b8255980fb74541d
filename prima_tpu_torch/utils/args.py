"""Environment-variable fallbacks for CLI flags.

The reference's declarative arg registry gives every flag an env-var
fallback (`LLAMA_ARG_*`, common/arg.cpp: the env value applies when the
flag is absent on the command line; an explicit flag always wins). This
helper retrofits the same contract onto any argparse parser:

  --ctx-size   <-  PRIMA_ARG_CTX_SIZE   (or LLAMA_ARG_CTX_SIZE)
  --n-predict  <-  PRIMA_ARG_N_PREDICT  (or LLAMA_ARG_N_PREDICT)
  -t/--threads <-  PRIMA_ARG_THREADS

Precedence: CLI flag > PRIMA_ARG_* > LLAMA_ARG_* > coded default — the
reference's exact ordering with a vendor-specific prefix taking priority.
Booleans accept 1/true/yes/on (case-insensitive).
"""

from __future__ import annotations

import argparse
import os

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off"}


def _env_name(action: argparse.Action) -> str | None:
    longs = [s for s in action.option_strings if s.startswith("--")]
    if not longs:
        return None
    return longs[-1].lstrip("-").replace("-", "_").upper()


def apply_env_defaults(parser: argparse.ArgumentParser,
                       prefixes: tuple[str, ...] = ("PRIMA_ARG_",
                                                    "LLAMA_ARG_")) -> None:
    """Install env-var values as parser DEFAULTS (so explicit CLI flags
    still override). Call once after declaring all arguments."""
    for action in parser._actions:  # noqa: SLF001 — argparse has no API
        name = _env_name(action)
        if name is None or action.dest == "help":
            continue
        raw = None
        for prefix in prefixes:
            raw = os.environ.get(prefix + name)
            if raw is not None:
                break
        if raw is None:
            continue
        if isinstance(action, (argparse._StoreTrueAction,
                               argparse._StoreFalseAction)):
            v = raw.strip().lower()
            if v in _TRUTHY:
                action.default = isinstance(action,
                                            argparse._StoreTrueAction)
            elif v in _FALSY:
                action.default = not isinstance(action,
                                                argparse._StoreTrueAction)
            continue
        if action.type is not None:
            try:
                action.default = action.type(raw)
            except (TypeError, ValueError):
                raise SystemExit(
                    f"invalid value {raw!r} in env for --"
                    f"{name.lower().replace('_', '-')}")
        else:
            action.default = raw
        action.required = False  # env satisfies a required flag
