"""Ray/primitive intersection: brute-force search, sphere merge, and the
differentiable hit-attribute recompute.

Port of `mafrixraytracing_tpu/geometry/intersect.py`:
- `tri_hit_terms`: Moller-Trumbore, double-sided via |det| (reference
  `Core/Shape/Trangle.fs:120-145`);
- `find_closest` / `occluded`: brute force over every triangle in chunks,
  with the sphere merge — an oracle independent of the clusters, the cull
  and the kernels in `ops.intersect`;
- `closest_sphere_soa`: all spheres at once (reference
  `Core/Shape/Sphere.fs:21-43`);
- `packed_attr_table`: every per-primitive attribute joined into one
  (T + Sp, 36) table, so a hit's attributes are one row fetch;
- `hit_attributes_soa`: the hit is chosen detached (the search), and its
  attributes are recomputed differentiably from the fetched row. Gradients
  reach vertex positions and materials through the recompute only, so the
  backward costs O(rays), not O(rays x primitives).
"""
from __future__ import annotations

import math

import torch

from mafrixraytracing_torch.core import v3
from mafrixraytracing_torch.core.math import safe_sqrt
from mafrixraytracing_torch.core.types import HitS, ShadingS
from mafrixraytracing_torch.core.v3 import V3
from mafrixraytracing_torch.materials.texture import sample_atlas
from mafrixraytracing_torch.ops.unpack import gather_rows

BIG = 1e30
DET_EPS = 1e-10
PACKED_COLS = 36
_INT_MAX = 2**31 - 1


def tri_hit_terms(o: V3, d: V3, v0: V3, e1: V3, e2: V3):
    """Moller-Trumbore core on broadcastable SoA columns -> (t, u, v, det)."""
    pvec = v3.cross(d, e2)
    det = v3.dot(e1, pvec)
    ok = det.abs() > DET_EPS
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = o - v0
    u = v3.dot(tvec, pvec) * inv_det
    qvec = v3.cross(tvec, e1)
    v = v3.dot(d, qvec) * inv_det
    t = v3.dot(e2, qvec) * inv_det
    return t, u, v, det


def closest_sphere_soa(scene, o: V3, d: V3, t_min, t_max):
    """Nearest sphere hit in (t_min, t_max) per ray -> (t (B,), BIG on a
    miss; sphere index (B,) int64). Assumes unit directions (reference
    `Sphere.fs:23-24`). `t_max` is a (B,) tensor."""
    c = scene.sph_center
    r = scene.sph_radius[None, :]
    ocx = o.x[:, None] - c[None, :, 0]
    ocy = o.y[:, None] - c[None, :, 1]
    ocz = o.z[:, None] - c[None, :, 2]
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - cc
    ok = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    tm = t_max[:, None]
    t0_ok = ok & (t0 > t_min) & (t0 < tm)
    t1_ok = ok & (t1 > t_min) & (t1 < tm)
    t = torch.where(t0_ok, t0, torch.where(t1_ok, t1, BIG))
    t = torch.where(scene.sph_mask[None, :], t, BIG)
    best = t.amin(dim=1)
    Sp = t.shape[1]
    ids = torch.arange(Sp, device=t.device)[None, :]
    arg = torch.where(t <= best[:, None], ids, Sp).amin(dim=1)
    return best, torch.clamp(arg, max=Sp - 1)


@torch.no_grad()
def find_closest(scene, o: V3, d: V3, t_min: float, t_max, chunk: int = 1024):
    """Brute-force closest hit over every triangle (chunks of `chunk`) and
    every sphere -> (t, idx) with the `ops.intersect.find_closest_soa`
    contract: idx triangle [0, T), sphere T + s, -1 on a miss."""
    B = o.x.shape[0]
    T = scene.tri_v0.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.x.device).expand(B)
    col = lambda a: a[:, None]  # noqa: E731
    oc, dc = o.map(col), d.map(col)
    best_t = torch.full((B,), BIG, dtype=torch.float32, device=o.x.device)
    best_i = torch.full((B,), -1, dtype=torch.int64, device=o.x.device)
    for s in range(0, T, chunk):
        sl = slice(s, min(T, s + chunk))
        row = lambda a: V3.of(a[sl][None])  # noqa: E731
        t, u, v, det = tri_hit_terms(oc, dc, row(scene.tri_v0),
                                     row(scene.tri_e1), row(scene.tri_e2))
        valid = (scene.tri_mask[sl][None] & (det.abs() > DET_EPS)
                 & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                 & (t > t_min) & (t < t_max[:, None]))
        t = torch.where(valid, t, BIG)
        cand_t = t.amin(dim=1)
        ids = torch.arange(sl.start, sl.stop, device=t.device)[None, :]
        cand_i = torch.where(t <= cand_t[:, None], ids, _INT_MAX).amin(dim=1)
        better = cand_t < best_t
        best_t = torch.where(better, cand_t, best_t)
        best_i = torch.where(better, cand_i, best_i)
    if scene.num_live_spheres > 0:
        st, si = closest_sphere_soa(scene, o, d, t_min, t_max)
        use_sphere = st < best_t
        best_t = torch.where(use_sphere, st, best_t)
        best_i = torch.where(use_sphere, T + si, best_i)
    return best_t, torch.where(best_t < BIG, best_i, -1)


def occluded(scene, o: V3, d: V3, t_min: float, t_max, chunk: int = 1024):
    """Brute-force any-hit in (t_min, t_max) (reference shadow test
    `Core/Integrator/Integrators.fs:44`)."""
    return find_closest(scene, o, d, t_min, t_max, chunk)[1] >= 0


def packed_attr_table(scene) -> torch.Tensor:
    """(T + Sp, 36) joined attribute table, differentiable in the scene.
    Column layout (triangle rows | sphere rows):
      0:3 v0 | center    3:6 e1 | radius (col 3)    6:9 e2 | velocity
      9:18 n0 n1 n2 (shading normals) | 0    18:24 uv0 uv1 uv2 | 0
      24:27 albedo  27:30 emission  30 fuzz  31 ior  32 material type
      33 texture page  34 emitter two-sided  35 material id
    Albedo and emission, the material leaves a fit optimizes, are joined with
    `gather_rows`: thousands of rows share a material, and its backward sums
    them with the deterministic scatter-add kernel (advanced indexing's
    backward took 11 ms of a 78 ms train step on an H100 here)."""
    m = scene.tri_mat.long()
    lid = scene.tri_light.long()
    L = scene.light_v0.shape[0]
    two = torch.where(lid >= 0, scene.light_two_sided[lid.clamp(0, L - 1)], False)
    f = lambda x: x.to(torch.float32)[:, None]  # noqa: E731
    tri_rows = torch.cat(
        [
            scene.tri_v0, scene.tri_e1, scene.tri_e2,
            scene.tri_n0, scene.tri_n1, scene.tri_n2,
            scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
            gather_rows(scene.mat_albedo, m), gather_rows(scene.mat_emission, m),
            scene.mat_fuzz[m][:, None], scene.mat_ior[m][:, None],
            f(scene.mat_type[m]), f(scene.mat_tex[m]), f(two), f(m),
        ],
        dim=1,
    )
    Sp = scene.sph_center.shape[0]
    ms = scene.sph_mat.long()
    zeros = lambda n: torch.zeros((Sp, n), dtype=torch.float32,  # noqa: E731
                                  device=scene.sph_center.device)
    sph_rows = torch.cat(
        [
            scene.sph_center, scene.sph_radius[:, None], zeros(2),
            scene.sph_velocity, zeros(15),
            gather_rows(scene.mat_albedo, ms), gather_rows(scene.mat_emission, ms),
            scene.mat_fuzz[ms][:, None], scene.mat_ior[ms][:, None],
            f(scene.mat_type[ms]), f(scene.mat_tex[ms]), zeros(1), f(ms),
        ],
        dim=1,
    )
    return torch.cat([tri_rows, sph_rows], dim=0)


def hit_attributes_soa(scene, o: V3, d: V3, prim_idx: torch.Tensor,
                       t_hint: torch.Tensor, packed=None):
    """Differentiable attribute + shading recompute for the selected
    primitives -> (HitS, ShadingS). One packed row fetch per ray
    (`ops.unpack.fetch_cols`), then Moller-Trumbore / the sphere quadratic on
    the fetched columns. `t_hint` (the detached search result) picks the
    sphere root. A textured material's albedo is modulated by its atlas page
    at the hit's uv."""
    from mafrixraytracing_torch.ops.unpack import fetch_cols

    T = scene.tri_v0.shape[0]
    P = T + scene.sph_center.shape[0]
    valid = prim_idx >= 0
    is_tri = valid & (prim_idx < T)
    is_sph = valid & (prim_idx >= T)
    if packed is None:
        packed = packed_attr_table(scene)
    cols = fetch_cols(packed, prim_idx.clamp(0, P - 1))
    col = lambda k: cols[k]  # noqa: E731
    vec = lambda k: V3(cols[k], cols[k + 1], cols[k + 2])  # noqa: E731

    # --- triangle attributes (Moller-Trumbore on the fetched columns) ---
    v0, e1, e2 = vec(0), vec(3), vec(6)
    t_tri, u, v, _ = tri_hit_terms(o, d, v0, e1, e2)
    gn = v3.normalize(v3.cross(e1, e2))
    w = 1.0 - u - v
    sn = v3.normalize(vec(9) * w + vec(12) * u + vec(15) * v)
    sn = v3.where(v3.dot(sn, sn) > 0.5, sn, gn)
    uu_tri = w * col(18) + u * col(20) + v * col(22)
    vv_tri = w * col(19) + u * col(21) + v * col(23)

    # --- sphere attributes (statically skipped for sphere-free scenes) ---
    has_sph = scene.num_live_spheres > 0
    if has_sph:
        c = vec(0)
        r = col(3)
        oc = o - c
        b = v3.dot(oc, d)
        disc = b * b - (v3.dot(oc, oc) - r * r)
        sq = safe_sqrt(disc)
        t0, t1 = -b - sq, -b + sq
        th = t_hint.detach()
        t_sph = torch.where((t0 - th).abs() < (t1 - th).abs(), t0, t1)
        inv_r = 1.0 / torch.clamp(r, min=1e-8)
        n_sph = (o + d * t_sph - c) * inv_r
        deg = (n_sph.x * n_sph.x + n_sph.z * n_sph.z) < 1e-12
        phi = torch.atan2(n_sph.z, torch.where(deg, 1.0, n_sph.x))
        theta = torch.acos(torch.clamp(n_sph.y, -1.0 + 1e-6, 1.0 - 1e-6))
        uu_sph = 0.5 + phi / (2.0 * math.pi)
        vv_sph = theta / math.pi

        t = torch.where(is_tri, t_tri, torch.where(is_sph, t_sph, 0.0))
        point = o + d * t
        geo_n = v3.where(is_tri, gn, n_sph)
        shade_n = v3.where(is_tri, sn, n_sph)
        front = v3.dot(geo_n, d) < 0.0
        shade_n = shade_n * torch.where(front, 1.0, -1.0)
        uu = torch.where(is_tri, uu_tri, uu_sph)
        vv = torch.where(is_tri, vv_tri, vv_sph)
    else:
        t = torch.where(is_tri, t_tri, 0.0)
        point = o + d * t
        front = v3.dot(gn, d) < 0.0
        shade_n = sn * torch.where(front, 1.0, -1.0)
        uu, vv = uu_tri, vv_tri

    hit = HitS(valid=valid, t=t, point=point, normal=shade_n, front_face=front,
               material=col(35).to(torch.int64), prim_idx=prim_idx, u=uu, v=vv)
    # detached solid-angle pdf of the sphere-light cone sampler for this ray
    # (0 inside the sphere and for triangle rows): the BSDF-side MIS weight
    if has_sph and scene.slight_center.shape[0] > 0:
        oc_l = (o - c).map(torch.Tensor.detach)
        dc2 = v3.dot(oc_l, oc_l)
        r_sg = r.detach()
        sin2_max = r_sg * r_sg / torch.clamp(dc2, min=1e-12)
        cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, 0.0, 1.0))
        cone_solid = 2.0 * math.pi * torch.clamp(1.0 - cos_max, min=1e-12)
        light_pdf_sa = torch.where(is_sph & (sin2_max < 1.0), 1.0 / cone_solid, 0.0)
    else:
        light_pdf_sa = torch.zeros_like(t)
    albedo = vec(24)
    if scene.has_textures:
        # nearest, as the JAX package's hit_attributes_soa: one gather
        tex_rgb = sample_atlas(scene.tex_atlas, col(33).to(torch.int64),
                               torch.stack([uu, vv], dim=-1), mode="nearest")
        albedo = albedo * V3.of(tex_rgb)
    sh = ShadingS(albedo=albedo, emission=vec(27), fuzz=col(30), ior=col(31),
                  mtype=col(32).to(torch.int64), two_sided=col(34) > 0.5,
                  light_pdf_sa=light_pdf_sa)
    return hit, sh
