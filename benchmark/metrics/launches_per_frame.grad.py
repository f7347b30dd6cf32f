"""CUDA kernels launched a gradient frame (the profiler's kernel events over the frames)."""
from benchmark.tracing import per_unit


def read(trace):
    return per_unit(trace, "grad", lambda: len(trace.kernels))
