"""runtime/engine.py: the worker's step_fused / step calls that decoded in
the window, less the prompt time they hold, over the decode steps they ran
(the most tokens one slot got from a call)."""

from benchmark import measure


def read(run):
    return None if run.rec is None else measure.decode_step_ms(run)
