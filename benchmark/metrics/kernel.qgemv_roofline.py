"""quant/cuda/qmatmul.cu qgemv: the profiled launches' least time from
their GGUF bytes over the profiled qgemv_mma / qgemv_fma time, in percent."""

from benchmark import measure


def read(run):
    return None if run.rec is None else measure.kernel_roofline(run, "qgemv")
