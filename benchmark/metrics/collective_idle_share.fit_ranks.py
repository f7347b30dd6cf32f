"""Rank 0's device idle share put down to the program's `collective` span (parallel/mesh.py) by benchmark/layers.py's rule: the gaps that a launch from inside the span ends. None where the program has no such span."""
from benchmark.layers import layer_idle_share


def read(trace):
    by_layer = getattr(trace, "layers", None)
    if trace.kind != "fit_ranks" or not by_layer or "collective" not in by_layer:
        return None
    return layer_idle_share(trace, by_layer, "collective")
