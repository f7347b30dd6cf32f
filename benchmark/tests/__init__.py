"""The benchmark's own tests (run: python -m pytest benchmark/tests)."""
