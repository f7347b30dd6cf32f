"""Batched hit and shading records (SoA).

Port of `HitS` and `ShadingS` in `mafrixraytracing_tpu/core/types.py`: every
vector is a `V3` of flat (B,) columns, every scalar a (B,) column.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mafrixraytracing_torch.core.v3 import V3


class HitS(NamedTuple):
    """Closest-hit record (reference `Core/Interfaces/HitRecord.fs:5-15`).
    `prim_idx` encodes triangles as [0, T) and spheres as T + s, -1 on a
    miss; `material` indexes the material table."""

    valid: torch.Tensor
    t: torch.Tensor
    point: V3
    normal: V3          # shading normal, oriented against the incident ray
    front_face: torch.Tensor
    material: torch.Tensor
    prim_idx: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


class ShadingS(NamedTuple):
    """Per-hit material attributes, joined per primitive by the packed row
    fetch. `light_pdf_sa` is the solid-angle pdf with which the sphere-light
    NEE cone sampler would have produced the ray that made this hit (0 for
    triangles and for origins inside the sphere); the integrator's MIS weight
    for BSDF-sampled emissive-sphere hits uses it."""

    albedo: V3
    emission: V3
    fuzz: torch.Tensor
    ior: torch.Tensor
    mtype: torch.Tensor
    two_sided: torch.Tensor
    light_pdf_sa: torch.Tensor
