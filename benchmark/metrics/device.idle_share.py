"""The device: 1 - the union of its operations' intervals over the profiled
sub-window's wall time, in percent."""

from benchmark import measure


def read(run):
    return None if run.rec is None else measure.idle_share(run)
