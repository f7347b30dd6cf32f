"""Cameras: pinhole and thin lens.

Port of `mafrixraytracing_tpu/camera/camera.py`:
- `Camera.pinhole` (reference `PinholeCamera`, `Core/Camera.fs:113-142`):
  the "mafrix" convention puts the view plane 0.5 ahead with half-extent
  tan(0.5 * fov * pi / 360); "standard" takes `fov` as the true horizontal
  field of view with the plane at 1.
- `Camera.thin_lens` (reference `RayTraceCamera`,
  `RenderTest/Sample/RayTracing.fs:335-364`): aperture disk + focus distance.

The camera's vectors are float32 tensors on the camera's device (the CUDA
card unless the caller names another), built with the same float32
operations as the JAX camera.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from mafrixraytracing_torch.core import v3
from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.core.sampling import uniform_disk
from mafrixraytracing_torch.core.v3 import V3


def _normalize(v: V3) -> V3:
    """The JAX camera's normalize: 1/sqrt above eps^2 = 1e-16, else as is.
    Written as `rsqrt`: that is what XLA makes of the JAX camera's
    `1 / sqrt`, and on the CPU it gives the same bits where the cameras'
    own vectors are equal (the float32 `tan` of the two libraries can differ
    by an ulp, and then directions differ by up to 2 ulp)."""
    n2 = v3.dot(v, v)
    eps2 = 1e-8 * 1e-8
    scale = torch.where(n2 > eps2, torch.rsqrt(torch.clamp(n2, min=eps2)), 1.0)
    return v * scale


def _normalize3(a: torch.Tensor) -> torch.Tensor:
    return _normalize(V3.of(a)).arr()


@dataclasses.dataclass
class Camera:
    position: torch.Tensor     # (3,)
    topleft: torch.Tensor      # (3,) top-left corner of the view plane
    right_vec: torch.Tensor    # (3,) full-width vector along +u
    down_vec: torch.Tensor     # (3,) full-height vector along +v
    lens_right: torch.Tensor   # (3,) unit right for lens offsets
    lens_up: torch.Tensor      # (3,) unit up for lens offsets
    lens_radius: torch.Tensor  # () 0 -> pure pinhole
    focus_scale: torch.Tensor  # () focus_dist / plane_dist

    @classmethod
    def pinhole(cls, position, direction, fov: float, aspect: float,
                up=(0.0, 1.0, 0.0), fov_convention: str = "mafrix",
                device=None) -> "Camera":
        f32 = dict(dtype=torch.float32, device=resolve(device))
        pos = torch.as_tensor(position, **f32)
        fwd = _normalize3(torch.as_tensor(direction, **f32))
        upv = _normalize3(torch.as_tensor(up, **f32))
        right = _normalize3(torch.linalg.cross(fwd, upv))
        true_up = torch.linalg.cross(right, fwd)
        fov_t = torch.tensor(fov, **f32)
        if fov_convention == "mafrix":
            plane_dist = 0.5
            hori = torch.tan(0.5 * fov_t * math.pi / 360.0)
        elif fov_convention == "standard":
            plane_dist = 1.0
            hori = 2.0 * torch.tan(0.5 * fov_t * math.pi / 180.0)
        else:
            raise ValueError(f"unknown fov_convention {fov_convention!r}")
        vert = hori / torch.tensor(aspect, **f32)
        right_vec = right * hori
        up_vec = true_up * vert
        topleft = pos + plane_dist * fwd - 0.5 * right_vec + 0.5 * up_vec
        return cls(position=pos, topleft=topleft, right_vec=right_vec,
                   down_vec=-up_vec, lens_right=right, lens_up=true_up,
                   lens_radius=torch.tensor(0.0, **f32),
                   focus_scale=torch.tensor(1.0, **f32))

    @classmethod
    def thin_lens(cls, position, look_at, fov: float, aspect: float,
                  aperture: float, focus_dist: float | None = None,
                  up=(0.0, 1.0, 0.0), device=None) -> "Camera":
        device = resolve(device)
        f32 = dict(dtype=torch.float32, device=device)
        pos = torch.as_tensor(position, **f32)
        d = torch.as_tensor(look_at, **f32) - pos
        dist = torch.sqrt(torch.sum(d * d))
        cam = cls.pinhole(pos, d, fov, aspect, up=up,
                          fov_convention="standard", device=device)
        focus = (torch.tensor(focus_dist, **f32) if focus_dist is not None
                 else dist)
        return dataclasses.replace(
            cam, lens_radius=torch.tensor(aperture, **f32) / 2.0,
            focus_scale=focus)

    def get_rays(self, u: torch.Tensor, v: torch.Tensor, lens_uv=None):
        """Film coordinates u, v in [0, 1] (v = 0 is the top row) -> world
        rays (origin V3, unit direction V3). `lens_uv` ((..., 2) uniforms)
        samples the lens; with it the target is rescaled to the focal plane,
        exactly as the JAX camera does even for a pinhole."""
        tl, rv, dv = V3.of(self.topleft), V3.of(self.right_vec), V3.of(self.down_vec)
        target = tl + rv * u + dv * v
        pos = V3.of(self.position)
        origin = V3(*(c.expand_as(u) for c in pos))
        if lens_uv is not None:
            dx, dy = uniform_disk(lens_uv)
            dx, dy = dx * self.lens_radius, dy * self.lens_radius
            lr, lu = V3.of(self.lens_right), V3.of(self.lens_up)
            offset = lr * dx + lu * dy
            target = pos + (target - pos) * self.focus_scale
            origin = origin + offset
        return origin, _normalize(target - origin)
