"""runtime/generate.py: the CUDA API calls (cuda* and cu*) that put work on
the device (kernel launches, copies, sets) inside the profiled
sub-window's decode.issue spans, per decode step."""

from benchmark import program_trace


def read(run):
    return program_trace.launches_per_step(run)
