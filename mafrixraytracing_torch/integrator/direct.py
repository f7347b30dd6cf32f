"""Direct-lighting-only integrator.

Port of `mafrixraytracing_tpu/integrator/direct.py` (`direct_config` `:25`,
`trace_direct` `:32`), the reference's direct-integrator family
(`Core/Integrator/Integrators.fs:20-78`): one bounce of the path tracer with
next-event estimation against the whole light table, which is also what the
reference's first-hit `RayCast` tracer shades.
"""
from __future__ import annotations

import torch

from mafrixraytracing_torch.core.v3 import V3
from mafrixraytracing_torch.integrator.path import PathTracerConfig, trace_radiance


def direct_config(**overrides) -> PathTracerConfig:
    """One bounce, NEE only: camera ray -> hit -> light sampling."""
    base = dict(max_depth=1, nee=True, mis=True, rr_enable=False)
    base.update(overrides)
    return PathTracerConfig(**base)


def trace_direct(scene, o: V3, d: V3, keys: torch.Tensor, **overrides) -> torch.Tensor:
    """Direct lighting for a ray batch (o, d as V3 of (B,) columns, keys
    (B, 2)) -> (B, 3)."""
    return trace_radiance(scene, o, d, keys, direct_config(**overrides))
