"""Counter-based random streams: threefry2x32 as `jax.random` defines it
(partitionable mode), in int64 arithmetic with a 32-bit mask after each add.

A key is an int64 tensor (..., 2) of two uint32 words. Draws depend only on
the key and the draw site, never on the order of the rays.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """20 rounds of threefry2x32 on broadcasting int64 operands."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def root_key(seed: int, device) -> torch.Tensor:
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    return fold_in(key, torch.arange(num, dtype=torch.int64, device=key.device))


def uniforms(key: torch.Tensor, site: int, shape=(), dtype=torch.float32):
    """Uniform [0, 1) draws at `site` for every key: (B, 2) -> (B, *shape);
    23 random mantissa bits under the exponent of 1.0, minus 1, made in
    float32 and then cast to `dtype`."""
    k = fold_in(key, site)
    n = 1
    for s in shape:
        n *= s
    cnt = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(k[..., 0].unsqueeze(-1), k[..., 1].unsqueeze(-1), 0, cnt)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    out = bits.to(torch.int32).view(torch.float32) - 1.0
    return out.reshape(key.shape[:-1] + tuple(shape)).to(dtype)
