"""Device ms a gradient frame of every kernel that is not one of the port's hand-written ones: the RNG, shading, the bounce loop, autograd's elementwise work."""
from benchmark.tracing import PORT_KERNELS, device_ms, per_unit


def read(trace):
    return per_unit(trace, "grad", lambda: device_ms(trace, exclude=PORT_KERNELS))
