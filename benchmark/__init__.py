"""The benchmark of `mafrixraytracing_torch` on one CUDA card: cells of a
scene configuration under a traffic mix, driven by `BENCHMARK.json` at the
repository's root (see README.md)."""
