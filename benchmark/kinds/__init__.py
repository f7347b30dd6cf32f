"""One module a kind of traffic, named by the traffic file's `kind`; each
exports its run's class as `RUN` (see `benchmark/loops.py`)."""
