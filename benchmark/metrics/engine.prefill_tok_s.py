"""runtime/engine.py: prompt tokens over synced prompt seconds, from
Engine.perf's counters at the window's start and end."""

from benchmark import measure


def read(run):
    return measure.prefill_tok_s(run)
