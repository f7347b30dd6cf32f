"""Sampling warps on SoA columns.

Port of the SoA warps in `mafrixraytracing_tpu/core/sampling.py`
(`:112-149`) plus the disk and triangle warps the camera and the area-light
sampler use: branch-free analytic maps of uniform [0, 1) samples
(reference hemisphere helpers `Core/Materials/Brdfs/Lambertian.fs:10-53`,
triangle warp `Core/Shape/Trangle.fs:157-169`).
"""
from __future__ import annotations

import math

import torch

from mafrixraytracing_torch.core.v3 import V3

TWO_PI = 2.0 * math.pi


def onb(n: V3):
    """Branch-free orthonormal basis (t, b) around unit normal n
    (Frisvad/Duff; replaces reference `Core/Materials/ONB.fs:6-26`)."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bt = V3(b, sign + n.y * n.y * a, -n.y)
    return t, bt


def local_to_world(lx, ly, lz, n: V3) -> V3:
    t, b = onb(n)
    return t * lx + b * ly + n * lz


def cosine_hemisphere(u: torch.Tensor, n: V3):
    """Cosine-weighted hemisphere sample around n -> (dir, pdf = cos/pi)."""
    r = torch.sqrt(torch.clamp(u[..., 0], 0.0, 1.0))
    phi = TWO_PI * u[..., 1]
    z = torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))
    pdf = torch.clamp(z, min=1e-8) / math.pi
    return local_to_world(r * torch.cos(phi), r * torch.sin(phi), z, n), pdf


def fuzz_sphere(u: torch.Tensor) -> V3:
    """Uniform point inside the unit ball (the metal fuzz perturbation,
    reference `Core/Materials/Material.fs:60-64`); u: (..., 3)."""
    z = 1.0 - 2.0 * u[..., 0]
    rr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u[..., 1]
    r = torch.pow(torch.clamp(u[..., 2], 1e-12, 1.0), 1.0 / 3.0)
    return V3(r * rr * torch.cos(phi), r * rr * torch.sin(phi), r * z)


def uniform_disk(u: torch.Tensor):
    """Polar warp to the unit disk -> (x, y); u: (..., 2)."""
    r = torch.sqrt(torch.clamp(u[..., 0], 0.0, 1.0))
    phi = TWO_PI * u[..., 1]
    return r * torch.cos(phi), r * torch.sin(phi)


def uniform_triangle(u: torch.Tensor):
    """sqrt-warp uniform barycentrics -> (b1, b2), b0 = 1 - b1 - b2."""
    su = torch.sqrt(torch.clamp(u[..., 0], 0.0, 1.0))
    return 1.0 - su, u[..., 1] * su
