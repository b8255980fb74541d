"""Inter-token latency, the mean over every gap between two token events of
the requests due in the window (a request that did not finish adds the gap
from its last event to the run's end): the pace of output a user sees,
prefill stalls and decode chunks together."""

from benchmark import measure


def read(run):
    return measure.itl_mean_ms(run)
