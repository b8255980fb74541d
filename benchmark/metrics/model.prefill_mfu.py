"""models/llama.py forward: the least time of the window's prefill chunks at
the chip's peaks (their FLOPs against their weight and cache bytes) over
the prompt seconds of Engine.perf, in percent."""

from benchmark import measure


def read(run):
    return None if run.rec is None else measure.prefill_mfu(run)
