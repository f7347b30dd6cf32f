"""Structure-of-arrays 3-vectors: the port's one vector layout.

Port of `mafrixraytracing_tpu/core/v3.py`. The hot path carries every vector
as a `V3` of flat (B,) component tensors; (B, 3) tensors appear only at API
boundaries (scene tables, images, tests). The JAX package kept SoA and AoS
twins of many functions for the TPU's layout; the port keeps SoA only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def of(a: torch.Tensor) -> "V3":
        """(..., 3) tensor -> V3 of (...,) components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def arr(self) -> torch.Tensor:
        """V3 -> (..., 3) tensor (boundary use only)."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def map(self, fn) -> "V3":
        return V3(fn(self.x), fn(self.y), fn(self.z))

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def max_component(self) -> torch.Tensor:
        return torch.maximum(self.x, torch.maximum(self.y, self.z))


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def normalize(v: V3, eps: float = 1e-12) -> V3:
    """Zero-safe normalize (reference `Core/Point.fs:52-56` returns the input
    unchanged at ~0 length)."""
    n2 = dot(v, v)
    scale = torch.where(n2 > eps, torch.rsqrt(torch.clamp(n2, min=eps)), 1.0)
    return v * scale


def where(mask: torch.Tensor, a: V3, b: V3) -> V3:
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def reflect(d: V3, n: V3) -> V3:
    """Mirror reflection of propagation direction `d` about normal `n`
    (reference `Material.fs:16-17`)."""
    return d - n * (2.0 * dot(d, n))


def refract(d: V3, n: V3, eta: torch.Tensor):
    """Snell refraction; d points into the surface, n against it. Returns
    (ok, refracted), ok False on total internal reflection (reference
    `Material.fs:19-24`). cos_t uses the guarded sqrt so the gradient stays
    finite at the TIR boundary."""
    cos_i = torch.clamp(-dot(d, n), -1.0, 1.0)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    ok = sin2_t < 1.0
    x = 1.0 - sin2_t
    pos = x > 0.0
    cos_t = torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)
    out = d * eta + n * (eta * cos_i - cos_t)
    return ok, out
