"""Device ms a train step of kernel J's two passes (the deterministic scatter-add of every colliding gather's backward)."""
from benchmark.tracing import SCATTER_KERNELS, device_ms, per_unit


def read(trace):
    return per_unit(trace, "fit", lambda: device_ms(trace, SCATTER_KERNELS))
