"""models/llama.py forward: the least time of the window's decode steps at
the chip's peaks (weights once a step and each row's visible cache,
against their FLOPs) over the decode calls' wall time, in percent."""

from benchmark import measure


def read(run):
    return None if run.rec is None else measure.decode_mfu(run)
