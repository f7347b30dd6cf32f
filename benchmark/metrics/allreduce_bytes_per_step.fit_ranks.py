"""Bytes a train step that rank 0 hands to the all-reduce (the program's counter `allreduce_bytes`, counted from the tensors' shapes in RayMesh.sum_start). None where the program has no such counter."""
from benchmark.tracing import per_unit


def read(trace):
    return per_unit(trace, "fit_ranks", lambda: trace.counters.get("mfx.allreduce_bytes"))
