"""Device ms a preview pass of the search kernels (A, B, D-I, K)."""
from benchmark.tracing import SEARCH_KERNELS, device_ms, per_unit


def read(trace):
    return per_unit(trace, "preview", lambda: device_ms(trace, SEARCH_KERNELS))
