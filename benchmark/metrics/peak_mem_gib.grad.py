"""Peak device memory of a gradient frame, GiB: max_memory_allocated over
the frame, its peak statistics reset at the frame's start."""


def read(trace):
    peak = trace.counters.get("peak_frame_bytes") if trace.kind == "grad" else None
    return peak / 2**30 if peak else None
