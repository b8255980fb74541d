"""Set-up: process start to the first request's due time (imports, weights
made and converted, warm-up)."""


def read(run):
    return run.setup_s
