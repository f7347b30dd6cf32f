"""Milliseconds a preview pass spends in the film: add_frame, to_bytes and the copy to the host (the benchmark's span, synchronised)."""
from benchmark.tracing import span_mean


def read(trace):
    return span_mean(trace, "preview", "film", 1e3)
