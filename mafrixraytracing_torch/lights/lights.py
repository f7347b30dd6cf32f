"""Light sampling and next-event estimation on SoA columns.

Port of the SoA functions of `mafrixraytracing_tpu/lights/lights.py`
(`light_pdf_area` `:68`, `packed_light_table` `:183`, `nee_area_soa` `:201`,
`nee_point_soa` `:273`, `nee_sphere_soa` `:313`), which replace the
reference's `NewAreaLight` / `NewPointLight` (`Core/Lights/Light.fs:9-64`)
and `SingleDirectLightIntegrator` (`Core/Integrator/Integrators.fs:20-54`):

- area lights are triangle sets; a point is drawn by area-weighted CDF
  inversion over the table, then sqrt-warp barycentrics;
- shadow rays are detached any-hit queries from the offset origin, with
  the reference's epsilon protocol.
"""
from __future__ import annotations

import math

import torch

from mafrixraytracing_torch.core import rng, v3
from mafrixraytracing_torch.core.sampling import local_to_world, uniform_triangle
from mafrixraytracing_torch.core.v3 import V3
from mafrixraytracing_torch.materials.bsdf import eval_bsdf_soa
from mafrixraytracing_torch.ops.unpack import gather_rows

SHADOW_EPS = 1e-3


def light_pdf_area(scene) -> torch.Tensor:
    """Area pdf of the CDF sampler: uniform over the total emitter area, the
    same scalar for every emitter."""
    a = scene.light_total_area
    return torch.where(a > 0.0, 1.0 / torch.clamp(a, min=1e-12), 0.0)


def packed_light_table(scene) -> torch.Tensor:
    """(L, 16) joined light rows: 0:3 v0 | 3:6 e1 | 6:9 e2 | 9:12 normal |
    12:15 radiance | 15 flags (1 = two-sided, 2 = live)."""
    flags = (scene.light_two_sided.to(torch.float32)
             + 2.0 * scene.light_mask.to(torch.float32))
    return torch.cat([scene.light_v0, scene.light_e1, scene.light_e2,
                      scene.light_normal, scene.light_radiance, flags[:, None]],
                     dim=1)


def sample_area_lights_soa(scene, key):
    """Draw one point on the scene's area lights per ray (JAX
    `sample_area_lights`, `lights.py:43`) -> (point, normal, radiance as V3;
    two_sided, valid as (B,) bools)."""
    u_pick = rng.uniforms(key, 10)
    u_bary = rng.uniforms(key, 11, (2,))
    L = scene.light_v0.shape[0]
    li = torch.searchsorted(scene.light_cdf, u_pick, right=True).clamp(0, L - 1)
    # gather_rows, not table[li]: B rays gather L << B rows, and its backward
    # is the deterministic scatter-add kernel (advanced indexing's backward
    # took 75% of an H100 fwd+bwd here, and index_add_ sums with atomics in
    # an order that changes from run to run; the JAX package uses a one-hot
    # product for the TPU)
    row = gather_rows(packed_light_table(scene), li)  # (B, 16)
    vec = lambda k: V3(row[:, k], row[:, k + 1], row[:, k + 2])  # noqa: E731
    b1, b2 = uniform_triangle(u_bary)
    p = vec(0) + vec(3) * b1 + vec(6) * b2
    two_sided = torch.remainder(row[:, 15], 2.0) > 0.5
    valid = scene.light_mask.any() & (row[:, 15] >= 2.0)
    return p, vec(9), vec(12), two_sided, valid


def nee_area_soa(scene, hit, key, occluded_fn, mis: bool, sh, wo=None) -> V3:
    """Direct light from area lights: f * cos_s * Le * cos_l / (d^2 pdf_A),
    power-2 MIS against the BSDF pdf when `mis`."""
    p, ln, radiance, two_sided, ls_valid = sample_area_lights_soa(scene, key)
    pdf_area = light_pdf_area(scene)

    to_l = p - hit.point
    d2 = torch.clamp(v3.dot(to_l, to_l), min=1e-12)
    inv_d = torch.rsqrt(d2)
    wl = to_l * inv_d
    cos_s = v3.dot(hit.normal, wl)
    cos_l = -v3.dot(ln, wl)
    facing = torch.where(two_sided, cos_l != 0.0, cos_l > 0.0)
    cos_l_eff = cos_l.abs()

    f, pdf_b = eval_bsdf_soa(sh, hit, wl, wo=wo)
    candidate = (ls_valid & hit.valid & (cos_s > 0.0) & facing & (pdf_area > 0.0)
                 & ((f.x > 0.0) | (f.y > 0.0) | (f.z > 0.0)))
    # visibility is measured from the offset origin: measuring from the hit
    # point self-occludes against the target light at oblique angles
    origin = hit.point + hit.normal * SHADOW_EPS
    to_p = p - origin
    d2o = torch.clamp(v3.dot(to_p, to_p), min=1e-12)
    inv_do = torch.rsqrt(d2o)
    blocked = occluded_fn(origin, to_p * inv_do, SHADOW_EPS,
                          torch.where(candidate, d2o * inv_do - SHADOW_EPS, 0.0))
    vis = candidate & ~blocked
    scale = cos_s * (cos_l_eff / d2) / torch.clamp(pdf_area, min=1e-12)
    if mis:
        pdf_l_sa = pdf_area * d2 / torch.clamp(cos_l_eff, min=1e-8)
        scale = scale * pdf_l_sa**2 / torch.clamp(pdf_l_sa**2 + pdf_b**2, min=1e-20)
    scale = torch.where(vis, scale, 0.0)
    return f * radiance * scale


def nee_point_soa(scene, hit, occluded_fn, sh, wo=None) -> V3:
    """Direct light from point lights (intensity / d^2; delta lights take no
    MIS), one batched occlusion query for the whole (small) table."""
    P = scene.plight_pos.shape[0]
    zero = torch.zeros_like(hit.t)
    total = V3(zero, zero, zero)
    if P == 0:
        return total
    B = hit.t.shape[0]
    origin = hit.point + hit.normal * SHADOW_EPS
    geoms = []
    for i in range(P):
        lp = V3.of(scene.plight_pos[i])
        to_l = lp - hit.point
        d2 = torch.clamp(v3.dot(to_l, to_l), min=1e-12)
        inv_d = torch.rsqrt(d2)
        wl = to_l * inv_d
        cos_s = v3.dot(hit.normal, wl)
        f, _ = eval_bsdf_soa(sh, hit, wl, wo=wo)
        candidate = (scene.plight_mask[i] & hit.valid & (cos_s > 0.0)
                     & ((f.x > 0.0) | (f.y > 0.0) | (f.z > 0.0)))
        geoms.append((wl, d2 * inv_d, d2, cos_s, f, candidate))
    so = origin.map(lambda c: c.repeat(P))
    sd = V3(*(torch.cat([g[0][k] for g in geoms]) for k in range(3)))
    t_far = torch.cat([torch.where(g[5], g[1] - SHADOW_EPS, 0.0) for g in geoms])
    blocked = occluded_fn(so, sd, SHADOW_EPS, t_far).reshape(P, B)
    for i, (wl, dist, d2, cos_s, f, candidate) in enumerate(geoms):
        s = torch.where(candidate & ~blocked[i], cos_s / d2, 0.0)
        inten = scene.plight_intensity[i]
        total = total + f * V3(inten[0] * s, inten[1] * s, inten[2] * s)
    return total


def nee_sphere_soa(scene, hit, key, occluded_fn, sh, mis: bool = True,
                   wo=None) -> V3:
    """Direct light from emissive spheres: one direction per sphere light,
    uniform in the visible cone (pdf_sa = 1 / (2 pi (1 - cos_max))), power-2
    MIS against the BSDF pdf. The cone geometry is detached: it
    parameterizes the sampler, not the integrand. Shading points inside a
    sphere light are left to the BSDF side."""
    SL = scene.slight_center.shape[0]
    zero = torch.zeros_like(hit.t)
    total = V3(zero, zero, zero)
    if SL == 0:
        return total
    B = hit.t.shape[0]
    origin = hit.point + hit.normal * SHADOW_EPS
    hp = hit.point.map(torch.Tensor.detach)
    geoms = []
    for i in range(SL):
        u = rng.uniforms(rng.split_dim(key, 40 + i), 0, (2,))
        c = V3.of(scene.slight_center[i].detach())
        r = scene.slight_radius[i].detach()
        to_c = c - hp
        dc2 = torch.clamp(v3.dot(to_c, to_c), min=1e-12)
        w_axis = to_c * torch.rsqrt(dc2)
        sin2_max = torch.clamp(r * r / dc2, 0.0, 1.0)
        cos_max = torch.sqrt(1.0 - sin2_max)
        cos_t = 1.0 - u[..., 0] * (1.0 - cos_max)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = 2.0 * math.pi * u[..., 1]
        wl = local_to_world(sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                            cos_t, w_axis)
        # nearest sphere intersection from the offset shadow origin; lanes
        # whose offset ray misses the sphere are rejected
        oc = origin - c
        bq = v3.dot(oc, wl)
        cq = v3.dot(oc, oc) - r * r
        disc_o = bq * bq - cq
        tno = -bq - torch.sqrt(torch.clamp(disc_o, min=0.0))
        hits_light = (disc_o > 0.0) & (tno > 0.0)
        dist = torch.where(hits_light, tno, 0.0)
        pdf_sa = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-12)
        cos_s = v3.dot(hit.normal, wl)
        f, pdf_b = eval_bsdf_soa(sh, hit, wl, wo=wo)
        inside = r * r >= dc2
        candidate = (scene.slight_mask[i] & hit.valid & (cos_s > 0.0) & ~inside
                     & hits_light & ((f.x > 0.0) | (f.y > 0.0) | (f.z > 0.0)))
        if mis:
            w_mis = pdf_sa**2 / torch.clamp(pdf_sa**2 + pdf_b**2, min=1e-20)
        else:
            w_mis = torch.ones_like(pdf_sa)
        geoms.append((wl, dist, cos_s, f, candidate, pdf_sa, w_mis))
    so = origin.map(lambda cc: cc.repeat(SL))
    sd = V3(*(torch.cat([g[0][k] for g in geoms]) for k in range(3)))
    t_far = torch.cat([torch.where(g[4], g[1] - SHADOW_EPS, 0.0) for g in geoms])
    blocked = occluded_fn(so, sd, SHADOW_EPS, t_far).reshape(SL, B)
    for i, (wl, dist, cos_s, f, candidate, pdf_sa, w_mis) in enumerate(geoms):
        s = torch.where(candidate & ~blocked[i], cos_s * w_mis / pdf_sa, 0.0)
        Le = scene.slight_radiance[i]
        total = total + f * V3(Le[0] * s, Le[1] * s, Le[2] * s)
    return total
