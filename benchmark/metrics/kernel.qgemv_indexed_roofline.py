"""quant/cuda/qmatmul.cu qgemv_indexed: as kernel.qgemv_roofline, with
only the distinct experts a launch's ids chose counted."""

from benchmark import measure


def read(run):
    return None if run.rec is None else measure.kernel_roofline(run, "qgemv_indexed")
