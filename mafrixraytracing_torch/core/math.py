"""Scalar-column math with finite gradients.

Port of the parts of `mafrixraytracing_tpu/core/math.py` that the SoA hot
path and the rasterizer use. Every function works on tensors of any shape,
elementwise (`normalize` over the last axis).
"""
from __future__ import annotations

import torch

EPS = 1e-8


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) with a finite gradient at and below zero: the sqrt
    runs on a guarded operand, so a masked-out lane never produces an
    `inf * 0 = NaN` cotangent."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Zero-safe normalize over the last axis: a vector of length ~0 comes
    back unchanged (reference `Core/Point.fs:52-56`). `1 / sqrt`, not
    `rsqrt`, so that it rounds as the JAX package's does."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    scale = torch.where(n2 > EPS * EPS,
                        1.0 / torch.sqrt(torch.clamp(n2, min=EPS * EPS)), 1.0)
    return v * scale


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Exact unpolarized dielectric Fresnel reflectance; total internal
    reflection -> 1 (reference `Core/Materials/Material.fs:74-96`)."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin_t = (eta_i / eta_t) * safe_sqrt(1.0 - cos_i**2)
    tir = sin_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin_t**2)
    r_par = (eta_t * cos_i - eta_i * cos_t) / torch.clamp(
        eta_t * cos_i + eta_i * cos_t, min=EPS)
    r_perp = (eta_i * cos_i - eta_t * cos_t) / torch.clamp(
        eta_i * cos_i + eta_t * cos_t, min=EPS)
    fr = 0.5 * (r_par**2 + r_perp**2)
    return torch.where(tir, 1.0, fr)
