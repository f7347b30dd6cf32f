"""Counter-based RNG, bit-exact with `jax.random` (threefry2x32).

Port of `mafrixraytracing_tpu/core/rng.py`. Every random draw derives from a
root key folded with structural counters (pixel, sample, bounce), so a render
is reproducible and independent of ray order. The port reproduces JAX's
threefry2x32 `fold_in` and `uniform` (with `jax_threefry_partitionable`, the
JAX default) bit for bit, so both packages trace the same paths from the
same seed.

A key is an integer tensor of shape (..., 2) holding two uint32 words. The
arithmetic runs in int64 with `& 0xFFFFFFFF` after each add, because torch
has no full uint32 arithmetic.
"""
from __future__ import annotations

import torch

from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.utils.trace import spanned

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """The threefry2x32 block cipher (20 rounds), as in JAX's
    `_threefry2x32_lowering`. All arguments are int64 tensors (or ints)
    holding uint32 values; they broadcast. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def root_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.key(seed)` as a (2,) int64 tensor: [seed >> 32, seed & mask],
    on `device` (None: the CUDA card)."""
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64,
                        device=resolve(device))


@spanned("rng")
def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in` for keys of shape (..., 2); `data` (int or int
    tensor, broadcasting against the key's batch shape) is taken as uint32."""
    return _fold_in(key, data)


def _fold_in(key: torch.Tensor, data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _MASK
    else:
        data = int(data) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


@spanned("rng")
def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` of one (2,) key -> (num, 2). Under the partitionable
    threefry (the JAX default) child i hashes the counter (hi, lo) = (0, i)
    and keeps both output words, which is `fold_in(key, i)`."""
    return _fold_in(key, torch.arange(num, dtype=torch.int64, device=key.device))


@spanned("rng")
def pixel_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """One key per element of a flat batch: fold_in of the batch index."""
    return _fold_in(key, torch.arange(n, dtype=torch.int64, device=key.device))


@spanned("rng")
def sample_key(key: torch.Tensor, sample_idx) -> torch.Tensor:
    return _fold_in(key, sample_idx)


@spanned("rng")
def bounce_key(key: torch.Tensor, bounce_idx) -> torch.Tensor:
    return _fold_in(key, bounce_idx)


@spanned("rng")
def split_dim(key: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-dimension key under one logical draw site."""
    return _fold_in(key, dim)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """JAX's uniform float construction: 23 random mantissa bits under the
    exponent of 1.0, bit-cast, minus 1 -> [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


@spanned("rng")
def uniforms(key: torch.Tensor, dim: int, shape=()) -> torch.Tensor:
    """Per-key uniform draws at draw site `dim`: keys (B, 2) -> (B, *shape)
    floats in [0, 1), equal to `jax.random.uniform(fold_in(k, dim), shape)`
    for every key (partitionable threefry: element j hashes counter
    (hi, lo) = (0, j) and xors the two output words)."""
    k = _fold_in(key, dim)
    n = 1
    for s in shape:
        n *= s
    cnt = torch.arange(n, dtype=torch.int64, device=key.device)
    k1 = k[..., 0].unsqueeze(-1)
    k2 = k[..., 1].unsqueeze(-1)
    b0, b1 = threefry2x32(k1, k2, 0, cnt)
    out = _bits_to_unit_float(b0 ^ b1)
    return out.reshape(key.shape[:-1] + tuple(shape))
