"""CUDA kernels launched a preview pass."""
from benchmark.tracing import per_unit


def read(trace):
    return per_unit(trace, "preview", lambda: len(trace.kernels))
