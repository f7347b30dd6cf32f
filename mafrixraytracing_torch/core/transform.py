"""4x4 homogeneous transforms.

Port of `mafrixraytracing_tpu/core/transform.py` (the reference's `Matrix4x4`
factories and point/vector transforms, `EngineCore/Core/Transformation.fs:8-132`):
row-major 4x4, displacement / rotation about X/Y/Z in degrees / scale, with
inverses, and transform of points (with w-divide) vs. vectors (no
translation). The factories build on `device` (`core.device.resolve`: the
current card unless the caller names one); the functions on matrices run on
their operands' device. Everything is differentiable: the matrices are
stacked from their entries, so a gradient reaches the angle, offset or
factors a matrix was made from, and instancing transforms can be optimized.
"""
from __future__ import annotations

import functools
import math

import torch

from mafrixraytracing_torch.core.device import resolve


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _rows(rows, device) -> torch.Tensor:
    """A matrix from rows of entries, each a 0-d tensor or a number, stacked
    so that the graph of every tensor entry is kept."""
    return torch.stack([torch.stack([_scalar(x, device) for x in row])
                        for row in rows])


def identity(device=None) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=resolve(device))


def translation(offset, device=None) -> torch.Tensor:
    """Displacement matrix (reference `Transformation.fs` MakeDisplacementMatrix)."""
    device = resolve(device)
    o = _scalar(offset, device)
    last = torch.cat([o, o.new_ones(1)])[:, None]
    return torch.cat([torch.eye(4, 3, dtype=torch.float32, device=device), last], dim=1)


def scale(factors, device=None) -> torch.Tensor:
    """Scale by one factor or by three (x, y, z)."""
    f = _scalar(factors, resolve(device)).broadcast_to((3,))
    return torch.diag(torch.cat([f, f.new_ones(1)]))


def _cos_sin(deg, device):
    a = _scalar(deg, device) * (math.pi / 180.0)
    return torch.cos(a), torch.sin(a)


def rotation_x(deg, device=None) -> torch.Tensor:
    device = resolve(device)
    c, s = _cos_sin(deg, device)
    return _rows([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], device)


def rotation_y(deg, device=None) -> torch.Tensor:
    device = resolve(device)
    c, s = _cos_sin(deg, device)
    return _rows([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], device)


def rotation_z(deg, device=None) -> torch.Tensor:
    device = resolve(device)
    c, s = _cos_sin(deg, device)
    return _rows([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], device)


def compose(*mats: torch.Tensor) -> torch.Tensor:
    """Left-to-right application order: compose(A, B) applies A first.
    Takes at least one matrix."""
    return functools.reduce(lambda out, m: m @ out, mats)


def inverse(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(m)


def apply_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points (..., 3) with w-divide
    (reference `Transformation.fs:48-57`)."""
    ph = torch.cat([p, p.new_ones(p.shape[:-1] + (1,))], dim=-1)
    out = torch.einsum("ij,...j->...i", m, ph)
    w = out[..., 3:4]
    return out[..., :3] / torch.where(w.abs() > 1e-12, w, 1.0)


def apply_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Transform directions (..., 3); translation ignored
    (reference `Transformation.fs:59-63`)."""
    return torch.einsum("ij,...j->...i", m[:3, :3], v)


def apply_normal(m: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Transform normals by the inverse-transpose so they stay perpendicular
    under non-uniform scale."""
    return torch.einsum("ij,...j->...i", torch.linalg.inv(m[:3, :3]).T, n)
