"""Time per output token after the first, 90th percentile over the requests
due in the window: (last token's event - first's) / (tokens - 1)."""

from benchmark import measure


def read(run):
    return measure.window_p90_ms(run, measure.tpot_s)
