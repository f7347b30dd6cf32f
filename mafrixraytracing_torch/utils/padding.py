"""Static-shape padding helpers.

A copy of `mafrixraytracing_tpu/utils/padding.py`: importing any module of
that package imports JAX, and the port runs where JAX is absent. Scenes pad
their primitive arrays to the same coarse buckets as the JAX package, so
both packages compile a scene to arrays of identical shapes (and the
triangle count stays a multiple of the 128-triangle cluster).
"""
from __future__ import annotations

import numpy as np


def round_up(n: int, multiple: int) -> int:
    return ((max(n, 1) + multiple - 1) // multiple) * multiple


def bucket_size(n: int, multiple: int = 128) -> int:
    """Round up to `multiple`, then to the next power-of-two count of
    multiples — coarse buckets mean few distinct compiled shapes."""
    base = round_up(n, multiple)
    units = base // multiple
    po2 = 1 << (units - 1).bit_length()
    return po2 * multiple


def pad_to(arr: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    """Pad axis 0 of `arr` to length `n` with `fill`."""
    if arr.shape[0] == n:
        return arr
    assert arr.shape[0] <= n, (arr.shape, n)
    pad_width = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill)
