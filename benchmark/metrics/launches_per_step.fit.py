"""CUDA kernels launched a train step of the fit."""
from benchmark.tracing import per_unit


def read(trace):
    return per_unit(trace, "fit", lambda: len(trace.kernels))
