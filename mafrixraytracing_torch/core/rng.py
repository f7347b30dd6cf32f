"""Counter-based RNG, bit-exact with `jax.random` (threefry2x32).

Port of `mafrixraytracing_tpu/core/rng.py`. Every random draw derives from a
root key folded with structural counters (pixel, sample, bounce), so a render
is reproducible and independent of ray order. The port reproduces JAX's
threefry2x32 `fold_in` and `uniform` (with `jax_threefry_partitionable`, the
JAX default) bit for bit, so both packages trace the same paths from the
same seed.

A key is an integer tensor of shape (..., 2) holding two uint32 words.

Each public draw routes on the key's device alone. A CUDA key takes one
launch of a hand-written kernel (`csrc/rng.cu`: `fold_kernel` launches
`threefry_fold_kernel`, `uniform_kernel` `threefry_uniform_kernel`), which
does the whole cipher in registers. A CPU key takes the plain version here
(`threefry2x32`, `_fold_in`, `_uniforms`): int64 tensor arithmetic with
`& 0xFFFFFFFF` after each add, because torch has no full uint32 arithmetic,
some 170 launches a hash on a card. The kernels equal the plain version bit
for bit. Every draw adds one to the counter `rng_calls` (`utils/trace.py`);
the kernels' launches are counted in `ops.cuda.LAUNCHES` (`rng_fold`,
`rng_uniform`), so their sum over `rng_calls` is the kernels' share of the
draws.
"""
from __future__ import annotations

import math

import torch

from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.ops import cuda
from mafrixraytracing_torch.utils import trace
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


def _fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Plain version of `fold_in`; `data` may also be a `range` (step 1)."""
    if isinstance(data, range):
        data = torch.arange(data.start, data.stop, dtype=torch.int64, device=key.device)
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _MASK
    else:
        data = int(data) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """JAX's uniform float construction: 23 random mantissa bits under the
    exponent of 1.0, bit-cast, minus 1 -> [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _uniforms(key: torch.Tensor, dim: int, shape=()) -> torch.Tensor:
    """Plain version of `uniforms`."""
    k = _fold_in(key, dim)
    cnt = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    k1 = k[..., 0].unsqueeze(-1)
    k2 = k[..., 1].unsqueeze(-1)
    b0, b1 = threefry2x32(k1, k2, 0, cnt)
    out = _bits_to_unit_float(b0 ^ b1)
    return out.reshape(key.shape[:-1] + tuple(shape))


def _grid(kshape, dshape):
    """Lay the broadcast of keys of batch shape `kshape` against data of
    shape `dshape` out as the fold kernel's (K, D) grid: output k * D + d
    folds key k * key_step with datum k * data_k + d * data_d. Returns the
    output's batch shape and (K, D, key_step, data_k, data_d), or None for
    the grid where no such layout exists."""
    # by hand: torch.broadcast_shapes imports sympy on its first call (seconds)
    n = max(len(kshape), len(dshape))
    kp = (1,) * (n - len(kshape)) + tuple(kshape)
    dp = (1,) * (n - len(dshape)) + tuple(dshape)
    if any(a != b and 1 not in (a, b) for a, b in zip(kp, dp)):
        raise RuntimeError(f"keys of batch shape {tuple(kshape)} do not broadcast "
                           f"against data of shape {tuple(dshape)}")
    shape = tuple(b if a == 1 else a for a, b in zip(kp, dp))
    if kp == dp == shape:                       # key k with datum k
        return shape, (math.prod(shape), 1, 1, 1, 0)
    one_key, one_datum = math.prod(kp) == 1, math.prod(dp) == 1
    for p in range(n + 1):                      # keys over shape[:p], data over shape[p:]
        if (all(s == 1 for s in kp[p:]) and all(s == 1 for s in dp[:p])
                and (one_key or kp[:p] == shape[:p])
                and (one_datum or dp[p:] == shape[p:])):
            return shape, (math.prod(shape[:p]), math.prod(shape[p:]),
                           int(not one_key), 0, int(not one_datum))
    return shape, None


def _rows(key: torch.Tensor) -> torch.Tensor:
    """The keys as (K, 2) int64 rows 16 bytes apart on a 16-byte boundary,
    as the kernels read them: a view of `key` where its layout is that, else
    a copy."""
    rows = key.reshape(-1, 2)
    if (rows.dtype != torch.int64 or rows.stride(1) != 1 or rows.data_ptr() % 16
            or (rows.shape[0] > 1 and rows.stride(0) != 2)):
        rows = rows.to(torch.int64, memory_format=torch.contiguous_format, copy=True)
    return rows


def fold_kernel(key: torch.Tensor, data) -> torch.Tensor:
    """`_fold_in(key, data)` in one launch of `threefry_fold_kernel`, for a
    CUDA key. `data`: an int, an int tensor on the key's device, or a
    `range` (step 1) the kernel counts itself. Every broadcast the port's
    callers use reaches the kernel as views; any other lays both out in
    full first."""
    if isinstance(data, torch.Tensor):
        dshape, start = tuple(data.shape), 0
    elif isinstance(data, range):
        dshape, start = (len(data),), data.start
    else:
        dshape, start = (), int(data) & _MASK
    shape, grid = _grid(tuple(key.shape[:-1]), dshape)
    if grid is None:
        if isinstance(data, range):
            data = torch.arange(data.start, data.stop, dtype=torch.int64, device=key.device)
        key, data = key.expand(shape + (2,)), data.expand(shape)
        grid = (math.prod(shape), 1, 1, 1, 0)
    K, D, key_step, data_k, data_d = grid
    vals = None
    if isinstance(data, torch.Tensor):
        vals = data.reshape(-1).to(torch.int64).contiguous()
    out = torch.empty(shape + (2,), dtype=torch.int64, device=key.device)
    cuda.launch("rng_fold", _rows(key), key_step, vals, data_k, data_d, start, K, D, out)
    return out


def uniform_kernel(key: torch.Tensor, dim: int, shape=()) -> torch.Tensor:
    """`_uniforms(key, dim, shape)` in one launch of
    `threefry_uniform_kernel`, for a CUDA key."""
    rows = _rows(key)
    out = torch.empty(tuple(key.shape[:-1]) + tuple(shape), dtype=torch.float32,
                      device=key.device)
    cuda.launch("rng_uniform", rows, int(dim) & _MASK, math.prod(shape), rows.shape[0], out)
    return out


def _on_card(key: torch.Tensor) -> bool:
    """Count a public draw; whether it takes the kernels (a CUDA key)."""
    trace.count("rng_calls", 1)
    return key.is_cuda


def _fold(key: torch.Tensor, data) -> torch.Tensor:
    return fold_kernel(key, data) if _on_card(key) else _fold_in(key, data)


@spanned("rng")
def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in` for keys of shape (..., 2); `data` (int or int
    tensor, broadcasting against the key's batch shape) is taken as uint32."""
    return _fold(key, data)


@spanned("rng")
def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` of one (2,) key -> (num, 2). Under the partitionable
    threefry (the JAX default) child i hashes the counter (hi, lo) = (0, i)
    and keeps both output words, which is `fold_in(key, i)`."""
    return _fold(key, range(num))


@spanned("rng")
def pixel_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """One key per element of a flat batch: fold_in of the batch index."""
    return _fold(key, range(n))


@spanned("rng")
def sample_key(key: torch.Tensor, sample_idx) -> torch.Tensor:
    return _fold(key, sample_idx)


@spanned("rng")
def bounce_key(key: torch.Tensor, bounce_idx) -> torch.Tensor:
    return _fold(key, bounce_idx)


@spanned("rng")
def split_dim(key: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-dimension key under one logical draw site."""
    return _fold(key, dim)


@spanned("rng")
def uniforms(key: torch.Tensor, dim: int, shape=()) -> torch.Tensor:
    """Per-key uniform draws at draw site `dim`: keys (B, 2) -> (B, *shape)
    floats in [0, 1), equal to `jax.random.uniform(fold_in(k, dim), shape)`
    for every key (partitionable threefry: element j hashes counter
    (hi, lo) = (0, j) and xors the two output words)."""
    if _on_card(key):
        return uniform_kernel(key, dim, shape)
    return _uniforms(key, dim, shape)
