"""Output tokens whose events fell inside the window, of every request,
over the window's seconds."""

from benchmark import measure


def read(run):
    return measure.output_tok_s(run)
