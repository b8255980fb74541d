"""runtime/generate.py: the mean duration of the window's decode.issue
spans, the program's own (FusedGenerator.generate and Engine.step): the
host's time to enqueue one decode step, forward and sampling."""

from benchmark import program_trace


def read(run):
    return program_trace.issue_ms(run)
