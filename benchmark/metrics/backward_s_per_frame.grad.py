"""Seconds of a gradient frame's .backward(), the benchmark's span, synchronised at both ends."""
from benchmark.tracing import span_mean


def read(trace):
    return span_mean(trace, "grad", "backward")
