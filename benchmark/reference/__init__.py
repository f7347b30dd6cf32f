"""The benchmark's plain reference: a path tracer in plain PyTorch and NumPy.

It follows the measured program's estimator and random streams (threefry2x32
keys folded with pixel, sample and bounce counters) so that the two trace
the same paths, but it shares no code with the program: it imports nothing
of it, compiles its scenes itself from the benchmark's own inputs, searches
every triangle that its own cluster boxes admit, and differentiates with
plain autograd. Every float tensor it makes has the dtype of its scene, so
the same code computed in bfloat16 is the control that the comparison has to
reject (`compare.py`).
"""
