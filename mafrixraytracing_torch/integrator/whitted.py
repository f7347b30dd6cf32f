"""Whitted-style deterministic ray tracer.

Port of `mafrixraytracing_tpu/integrator/whitted.py` (`sky_gradient` `:53`,
`WhittedConfig` `:62`, `_direct_deterministic` `:71`, `trace_whitted` `:108`,
`render_whitted` `:194`) on SoA columns. Parity target: the reference's
commented-out Whitted tracer (`Core/Tracer/Whitted.fs`): depth-limited
recursion, local shading at the first diffuse hit, and the sky-gradient miss
shader its tracers share (`Core/Tracer/PathTracer.fs:48-67`).

A deterministic wavefront loop over depth, no Monte Carlo anywhere:

- miss        -> throughput * sky gradient, retire.
- emissive    -> throughput * Le, retire.
- lambert     -> local illumination: one shadow ray to every area-light row's
                 centroid (radiance by the reference's `NewAreaLight.L` fold
                 I * |cos_l| * Area / d^2, `Core/Lights/Light.fs:48-59`) plus
                 every point light (`Light.fs:9-29`); retire. Glossy shades
                 like lambert: Whitted has no distributed reflection.
- metal       -> perfect-mirror continuation (fuzz ignored), throughput *=
                 albedo.
- dielectric  -> the refracted branch weighted (1 - Fresnel), or the mirror
                 branch on total internal reflection (a wavefront cannot fork
                 into the reflect + refract ray tree).

No RNG key is consumed: two renders of the same scene are bit-equal. The
searches are those of the path integrator (`ops.dispatch`), so with
`ops.intersect.FUSED_CULL` the shadow rays go through the fused any-hit
kernels. There is no `backend` or `chunk`: the tensors' device decides.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from mafrixraytracing_torch.core import v3
from mafrixraytracing_torch.core.math import fresnel_dielectric
from mafrixraytracing_torch.core.v3 import V3
from mafrixraytracing_torch.geometry.intersect import packed_attr_table
from mafrixraytracing_torch.integrator.path import RAY_EPS, make_pixel_uv
from mafrixraytracing_torch.lights import lights as L
from mafrixraytracing_torch.materials.bsdf import (
    DIELECTRIC,
    EMISSIVE,
    GLOSSY,
    LAMBERT,
    METAL,
)
from mafrixraytracing_torch.ops import dispatch

INV_PI = 1.0 / math.pi


def sky_gradient(d: V3) -> V3:
    """The vertical white-to-blue lerp of the reference's miss shaders
    (`RenderTest/Sample/RayTracing.fs:376-381`)."""
    t = 0.5 * (d.y + 1.0)
    return V3((1.0 - t) + t * 0.5, (1.0 - t) + t * 0.7, (1.0 - t) + t)


@dataclass(frozen=True)
class WhittedConfig:
    max_depth: int = 5          # delta-recursion depth
    t_min: float = RAY_EPS
    sky: bool = True            # sky-gradient miss shader (else scene.background)


def _direct_deterministic(scene, hit, occluded_fn, wanted) -> V3:
    """Local illumination at a diffuse hit: one deterministic shadow ray to
    each area-light row's centroid, all rows in one occlusion query. Lanes
    outside `wanted` (not a live diffuse hit) cast a dead ray; the caller
    masks their result."""
    rows = scene.light_v0.shape[0]
    zero = torch.zeros_like(hit.t)
    total = V3(zero, zero, zero)
    if rows == 0:
        return total
    B = hit.t.shape[0]
    # visibility is measured from the offset origin (see lights.nee_area_soa)
    so = hit.point + hit.normal * L.SHADOW_EPS
    geoms = []
    for i in range(rows):
        centroid = V3.of(scene.light_v0[i]
                         + (scene.light_e1[i] + scene.light_e2[i]) / 3.0)
        to_l = centroid - hit.point
        d2 = torch.clamp(v3.dot(to_l, to_l), min=1e-12)
        dist = torch.sqrt(d2)
        wl = to_l.map(lambda c: c / dist)
        cos_s = v3.dot(hit.normal, wl)
        cos_l = -v3.dot(V3.of(scene.light_normal[i]), wl)
        facing = torch.where(scene.light_two_sided[i], cos_l.abs(), cos_l)
        to_o = centroid - so
        disto = torch.sqrt(torch.clamp(v3.dot(to_o, to_o), min=1e-12))
        ok = scene.light_mask[i] & (cos_s > 0.0) & (facing > 0.0)
        geoms.append((to_o.map(lambda c: c / disto), disto, d2, cos_s, facing, ok))
    sd = V3(*(torch.cat([g[0][k] for g in geoms]) for k in range(3)))
    t_far = torch.cat([torch.where(g[5] & wanted, g[1] - L.SHADOW_EPS, 0.0)
                       for g in geoms])
    blocked = occluded_fn(so.map(lambda c: c.repeat(rows)), sd, L.SHADOW_EPS,
                          t_far).reshape(rows, B)
    for i, (_, _, d2, cos_s, facing, ok) in enumerate(geoms):
        # reference `NewAreaLight.L` fold: I * |cos_l| * Area / d^2
        s = torch.where(ok & ~blocked[i],
                        facing * scene.light_area[i] / d2 * cos_s, 0.0)
        rad = scene.light_radiance[i]
        total = total + V3(rad[0] * s, rad[1] * s, rad[2] * s)
    return total


def trace_whitted(scene, o: V3, d: V3, keys=None,
                  config: WhittedConfig = WhittedConfig()) -> torch.Tensor:
    """Deterministic radiance for a ray batch (o, d as V3 of (B,) columns)
    -> (B, 3). `keys` is accepted and ignored, for signature parity with
    `trace_radiance`."""
    B = o.x.shape[0]
    dev = o.x.device
    packed = packed_attr_table(scene)

    def occluded_fn(so, sd, t_min, t_max):
        return dispatch.occluded_soa(scene, so, sd, t_min, t_max)

    one = torch.ones((B,), dtype=torch.float32, device=dev)
    zero_c = torch.zeros_like(one)
    zero = V3(zero_c, zero_c, zero_c)
    thr, rad = V3(one, one, one), zero
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    for _ in range(config.max_depth):
        t_max = torch.where(alive, 1e8, 0.0)
        hit, sh = dispatch.intersect_shade_soa(scene, o, d, config.t_min, t_max,
                                               packed=packed)
        miss = alive & ~hit.valid
        bg = sky_gradient(d) if config.sky else V3.of(scene.background)
        rad = rad + v3.where(miss, thr * bg, zero)

        live = alive & hit.valid
        # emissive: add and retire
        rad = rad + v3.where(live & (sh.mtype == EMISSIVE), thr * sh.emission, zero)

        # lambert (and glossy): local illumination, retire. The area-light
        # irradiance is weighted by the lambert BRDF here; nee_point_soa
        # folds the BRDF itself.
        is_lam = live & ((sh.mtype == LAMBERT) | (sh.mtype == GLOSSY))
        direct = _direct_deterministic(scene, hit, occluded_fn, is_lam)
        point_part = L.nee_point_soa(scene, hit, occluded_fn, sh, wo=-d)
        rad = rad + v3.where(
            is_lam, thr * (sh.albedo * INV_PI * direct + point_part), zero)

        # metal: perfect mirror; dielectric: the transmission branch, or the
        # mirror branch on total internal reflection
        n = hit.normal
        wi_mirror = v3.reflect(d, n)
        cos_i = torch.clamp(-v3.dot(d, n), 0.0, 1.0)
        eta_i = torch.where(hit.front_face, 1.0, sh.ior)
        eta_t = torch.where(hit.front_face, sh.ior, 1.0)
        fr = fresnel_dielectric(cos_i, eta_i, eta_t)
        ref_ok, refr = v3.refract(d, n, eta_i / eta_t)
        wi_die = v3.where(ref_ok, v3.normalize(refr), wi_mirror)
        w_die = torch.where(ref_ok, 1.0 - fr, 1.0)

        is_met = live & (sh.mtype == METAL)
        is_die = live & (sh.mtype == DIELECTRIC)
        wi = v3.where(is_die, wi_die, wi_mirror)
        weight = v3.where(is_met, sh.albedo,
                          V3(*(torch.where(is_die, w_die, 0.0),) * 3))
        alive = is_met | is_die
        thr = v3.where(alive, thr * weight, thr)
        flip = torch.where(v3.dot(n, wi) >= 0.0, RAY_EPS, -RAY_EPS)
        o = hit.point + n * flip
        d = wi
    return rad.arr()


def render_whitted(scene, camera, width: int, height: int,
                   config: WhittedConfig = WhittedConfig()) -> torch.Tensor:
    """Full-frame deterministic Whitted render -> (height, width, 3): pixel
    centres, one ray a pixel, no jitter (nothing here is stochastic)."""
    px, py = make_pixel_uv(width, height, scene.tri_v0.device)
    o, d = camera.get_rays((px + 0.5) / width, (py + 0.5) / height)
    return trace_whitted(scene, o, d, config=config).reshape(height, width, 3)
