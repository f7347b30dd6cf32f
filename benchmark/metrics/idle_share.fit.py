"""Device idle share of the fit's train steps: 1 - the traced units' busy seconds over the seconds of as many unprofiled units."""
from benchmark.tracing import idle_share


def read(trace):
    return idle_share(trace, "fit")
