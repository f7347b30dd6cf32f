"""Intersection entry points of the integrator.

Port of `mafrixraytracing_tpu/ops/dispatch.py` (`intersect_shade_soa` `:81`,
`occluded_soa` `:102`). There is no backend switch: the tensors' device
decides. On a CUDA device the searches run the hand-written kernels, on the
CPU their plain versions (see `ops.intersect` and `ops.unpack`). Inside a
checkpointed step the searches' results are kept (`ops.remat.keep`, the
JAX package's `isect_t`, `isect_idx` and `occluded`), so the backward's
recompute runs no walk and no cull.
"""
from __future__ import annotations

from mafrixraytracing_torch.geometry import intersect as isect
from mafrixraytracing_torch.ops import intersect as ops_isect
from mafrixraytracing_torch.ops import remat


def intersect_shade_soa(scene, o, d, t_min: float, t_max, packed=None,
                        times=None):
    """Closest-hit query -> (HitS, ShadingS): detached search, then the
    differentiable attribute recompute from the packed table. `times` (B,)
    enables sphere motion blur in both."""
    if times is not None:
        times = times.detach()
    t, idx = remat.keep("closest", lambda: ops_isect.find_closest_soa(
        scene, o, d, t_min, t_max, times=times))
    return isect.hit_attributes_soa(scene, o, d, idx, t, packed=packed,
                                    times=times)


def occluded_soa(scene, o, d, t_min: float, t_max, times=None):
    """Any-hit (shadow) query; visibility is not differentiated."""
    if times is not None:
        times = times.detach()
    return remat.keep("anyhit", lambda: ops_isect.occluded_soa(
        scene, o, d, t_min, t_max, times=times))
