"""The device: the device time of the work whose CUDA runtime call (matched
by correlation id) lies inside a decode.issue span of the profiled
sub-window, over the decode steps there: a step's floor if the host kept
up."""

from benchmark import program_trace


def read(run):
    return program_trace.step_busy_ms(run)
