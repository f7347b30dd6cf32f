"""Device idle share of rank 0's train steps in the data-parallel fit: 1 - the traced units' busy seconds over the seconds of as many unprofiled units."""
from benchmark.tracing import idle_share


def read(trace):
    return idle_share(trace, "fit_ranks")
