"""Device ms a gradient frame of the search kernels (A, B, D-I, K by CUDA function name)."""
from benchmark.tracing import SEARCH_KERNELS, device_ms, per_unit


def read(trace):
    return per_unit(trace, "grad", lambda: device_ms(trace, SEARCH_KERNELS))
