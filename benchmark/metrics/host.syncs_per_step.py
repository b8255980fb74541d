"""runtime/engine.py: the calls that hold the host until the device catches
up (stream, device and event synchronizes, copies into pageable host
memory) inside the profiled sub-window's engine.decode spans, per decode
step: the read-back and every hidden sync."""

from benchmark import program_trace


def read(run):
    return program_trace.syncs_per_step(run)
