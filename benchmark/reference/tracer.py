"""The reference path tracer: the physical estimator (cosine-sampled
lambert BSDF, next-event estimation of area lights with power-2 multiple
importance sampling, Russian roulette from bounce 3), wavefront compaction
with its population control, and the three renders the benchmark drives:
a full frame (`render_image`), a flat batch of pixels (`render_pixels`) and
the progressive film's sum over passes (`film_sum`).

The search is exact and plain: the large "mega" triangles densely by
Moller-Trumbore, then each ray against every other triangle of every
128-triangle run whose widened box it enters, by the triangle's plane and
barycentric record (the arithmetic the measured program's search kernels
state); the hit with the smallest (distance, index) wins. Hit attributes are recomputed from the
chosen triangle with autograd on, so gradients reach albedo, light radiance
and vertices through plain PyTorch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import rng
from .scenes import CLUSTER, EMISSIVE, LAMBERT

RAY_EPS = 1e-3
SHADOW_EPS = 1e-3
DET_EPS = 1e-10
INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi
TILE = 128
PAIR_CHUNK = 1 << 16
RAY_CHUNK = 1 << 16


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

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

    def map(self, fn):
        return V3(fn(self.x), fn(self.y), fn(self.z))

    def max_component(self):
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    @staticmethod
    def of(a):
        return V3(a[..., 0], a[..., 1], a[..., 2])


def dot(a, b):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a, b):
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x)


def normalize(v, eps=1e-12):
    n2 = dot(v, v)
    return v * torch.where(n2 > eps, torch.rsqrt(torch.clamp(n2, min=eps)), 1.0)


def vwhere(m, a, b):
    return V3(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
              torch.where(m, a.z, b.z))


def moller_trumbore(o, d, v0, e1, e2):
    p = cross(d, e2)
    det = dot(e1, p)
    ok = det.abs() > DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tv = o - v0
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    return dot(e2, q) * inv, u, dot(d, q) * inv, det


# --- search -----------------------------------------------------------------


def plane_records(scene) -> torch.Tensor:
    """(T, 12) plane-and-barycentric records of the triangles, the form the
    search tests: n = e1 x e2, n.v0; g1 = (e2 x n) / n.n, g1.v0;
    g2 = (n x e1) / n.n, g2.v0. The mega triangles' records are zero: the
    dense Moller-Trumbore test owns them."""
    v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
    n = torch.linalg.cross(e1, e2)
    nn = torch.clamp(torch.sum(n * n, dim=1, keepdim=True), min=1e-30)
    g1 = torch.linalg.cross(e2, n) / nn
    g2 = torch.linalg.cross(n, e1) / nn
    rec = torch.cat([n, torch.sum(n * v0, dim=1, keepdim=True),
                     g1, torch.sum(g1 * v0, dim=1, keepdim=True),
                     g2, torch.sum(g2 * v0, dim=1, keepdim=True)], dim=1)
    return rec.index_fill(0, scene.mega, 0.0) if scene.mega.numel() else rec


def plane_hit(o, d, rec):
    """(t, inside) of rays against plane records, broadcast."""
    det = d.x * rec[..., 0] + d.y * rec[..., 1] + d.z * rec[..., 2]
    ok = det.abs() > DET_EPS
    t = (rec[..., 3] - (o.x * rec[..., 0] + o.y * rec[..., 1] + o.z * rec[..., 2])) \
        / torch.where(ok, det, 1.0)
    px, py, pz = o.x + t * d.x, o.y + t * d.y, o.z + t * d.z
    u = rec[..., 4] * px + rec[..., 5] * py + rec[..., 6] * pz - rec[..., 7]
    v = rec[..., 8] * px + rec[..., 9] * py + rec[..., 10] * pz - rec[..., 11]
    return t, ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)


def mega_hits(scene, o: V3, d: V3, t_min, t_max):
    """Nearest mega-triangle hit in (t_min, t_max) by Moller-Trumbore ->
    (t, index), (inf, -1) on a miss; the smaller index on equal t."""
    B = o.x.shape[0]
    inf = torch.full((B,), math.inf, dtype=o.x.dtype, device=o.x.device)
    if not scene.mega.numel():
        return inf, torch.full((B,), -1, dtype=torch.int64, device=o.x.device)
    col = lambda c: c[:, None]  # noqa: E731
    row = lambda a: V3.of(a.index_select(0, scene.mega)[None])  # noqa: E731
    t, u, v, det = moller_trumbore(o.map(col), d.map(col), row(scene.tri_v0),
                                   row(scene.tri_e1), row(scene.tri_e2))
    ok = ((det.abs() > DET_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < t_max[:, None]))
    t = torch.where(ok, t, math.inf)
    best = t.amin(dim=1)
    i = torch.where(t <= best[:, None], scene.mega[None], torch.iinfo(torch.int64).max).amin(1)
    return best, torch.where(torch.isfinite(best), i, -1)


@torch.no_grad()
def run_boxes(scene):
    """The bounds of each run of 128 triangles in the layout that holds a
    live triangle other than a mega one, from the triangles as they are now
    (a fit moves them), widened by a thousandth of the scene's extent so
    that no grazing hit is lost -> (lo, hi, run index)."""
    v0, e1, e2 = (t.detach().float() for t in (scene.tri_v0, scene.tri_e1, scene.tri_e2))
    p1, p2 = v0 + e1, v0 + e2
    boxed = scene.tri_mask.clone()
    boxed[scene.mega] = False
    lo = torch.where(boxed[:, None], torch.minimum(torch.minimum(v0, p1), p2), math.inf)
    hi = torch.where(boxed[:, None], torch.maximum(torch.maximum(v0, p1), p2), -math.inf)
    lo, hi = lo.reshape(-1, CLUSTER, 3).amin(1), hi.reshape(-1, CLUSTER, 3).amax(1)
    run = torch.nonzero(torch.isfinite(lo).all(1)).squeeze(1)
    lo, hi = lo[run], hi[run]
    margin = 1e-3 * (hi.amax(0) - lo.amin(0)).max()
    return lo - margin, hi + margin, run


@torch.no_grad()
def closest(scene, o: V3, d: V3, t_min: float, t_max: torch.Tensor) -> torch.Tensor:
    """Index of the nearest triangle hit in (t_min, t_max) for every ray,
    -1 on a miss: the mega triangles densely first, which cap t_max, then
    every other triangle of each run whose box the ray enters, by its plane
    record; on equal distances the smaller index."""
    B = o.x.shape[0]
    dev = o.x.device
    big = torch.iinfo(torch.int64).max
    best = torch.full((B,), big, dtype=torch.int64, device=dev)
    out = torch.full((B,), -1, dtype=torch.int64, device=dev)
    T = scene.tri_v0.shape[0]
    tab = plane_records(scene).reshape(-1, CLUSTER, 12)
    box_min, box_max, box_run = run_boxes(scene)
    ids = torch.arange(T, device=dev).reshape(-1, CLUSTER)
    asks = torch.nonzero(t_max > t_min).squeeze(1)
    for r0 in range(0, asks.shape[0], RAY_CHUNK):
        rays = asks[r0:r0 + RAY_CHUNK]
        ro, rd = o.map(lambda c: c[rays]), d.map(lambda c: c[rays])
        m_t, m_i = mega_hits(scene, ro, rd, t_min, t_max[rays])
        out[rays] = m_i
        cap = torch.minimum(t_max[rays], m_t)
        o32 = torch.stack(list(ro), 1).float()
        inv = 1.0 / torch.stack(list(rd), 1).float()
        a = (box_min[None] - o32[:, None]) * inv[:, None]
        b = (box_max[None] - o32[:, None]) * inv[:, None]
        near = torch.nan_to_num(torch.fmin(a, b), nan=-math.inf).amax(2)
        far = torch.nan_to_num(torch.fmax(a, b), nan=math.inf).amin(2)
        pairs = torch.nonzero((near <= far) & (far >= t_min)
                              & (near <= cap.float()[:, None]))
        for p0 in range(0, pairs.shape[0], PAIR_CHUNK):
            pr = pairs[p0:p0 + PAIR_CHUNK]
            lane, cl = rays[pr[:, 0]], box_run[pr[:, 1]]
            col = lambda c: c[lane][:, None]  # noqa: E731
            t, inside = plane_hit(o.map(col), d.map(col), tab[cl])
            ok = inside & (t > t_min) & (t < cap[pr[:, 0]][:, None])
            key = (t.float().view(torch.int32).to(torch.int64) << 32) | ids[cl]
            best.scatter_reduce_(0, lane, torch.where(ok, key, big).amin(1), "amin")
    return torch.where(best == big, out, best & 0xFFFFFFFF)


def occluded(scene, o, d, t_min, t_max):
    return closest(scene, o.map(torch.Tensor.detach), d.map(torch.Tensor.detach),
                   t_min, t_max.detach()) >= 0


class Hit(NamedTuple):
    valid: torch.Tensor
    t: torch.Tensor
    point: V3
    normal: V3
    front: torch.Tensor
    albedo: V3
    emission: V3
    mtype: torch.Tensor


def intersect(scene, o: V3, d: V3, t_min: float, t_max) -> Hit:
    """The nearest hit (searched without gradient) and its attributes,
    recomputed from the triangle's vertices with gradient."""
    idx = closest(scene, o.map(torch.Tensor.detach), d.map(torch.Tensor.detach),
                  t_min, t_max)
    valid = idx >= 0
    i = idx.clamp(0, scene.tri_v0.shape[0] - 1)
    row = lambda a: V3.of(a.index_select(0, i))  # noqa: E731
    v0, e1, e2, n = row(scene.tri_v0), row(scene.tri_e1), row(scene.tri_e2), row(scene.tri_n)
    t_tri, u, v, _ = moller_trumbore(o, d, v0, e1, e2)
    gn = normalize(cross(e1, e2))
    w = 1.0 - u - v
    sn = normalize(n * w + n * u + n * v)
    sn = vwhere(dot(sn, sn) > 0.5, sn, gn)
    t = torch.where(valid, t_tri, 0.0)
    front = dot(gn, d) < 0.0
    m = scene.tri_mat.index_select(0, i)
    return Hit(valid, t, o + d * t, sn * torch.where(front, 1.0, -1.0), front,
               V3.of(scene.mat_albedo.index_select(0, m)),
               V3.of(scene.mat_emission.index_select(0, m)),
               scene.mat_type.index_select(0, m))


# --- lights and BSDF ----------------------------------------------------------


def light_pdf_area(scene):
    a = scene.light_total_area
    return torch.where(a > 0.0, 1.0 / torch.clamp(a, min=1e-12), 0.0)


def eval_lambert(hit, wi):
    cos = dot(wi, hit.normal)
    lam = (hit.mtype == LAMBERT) & (cos > 0.0)
    zero = torch.zeros_like(cos)
    f = vwhere(lam, hit.albedo * INV_PI, V3(zero, zero, zero))
    return f, torch.where(lam, torch.clamp(cos, min=0.0) * INV_PI, 0.0)


def onb_to_world(lx, ly, lz, n):
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bt = V3(b, sign + n.y * n.y * a, -n.y)
    return t * lx + bt * ly + n * lz


def next_event(scene, hit, key) -> V3:
    """One area-light sample per ray: a light triangle by the area CDF, a
    point by square-root barycentrics, visibility from the offset origin,
    weighted against the BSDF's pdf."""
    dt = scene.dtype
    u_pick = rng.uniforms(key, 10, dtype=dt)
    u_bary = rng.uniforms(key, 11, (2,), dtype=dt)
    L = scene.light_v0.shape[0]
    li = torch.searchsorted(scene.light_cdf, u_pick, right=True).clamp(0, L - 1)
    flags = scene.light_two_sided.to(dt) + 2.0 * scene.light_mask.to(dt)
    row = torch.cat([scene.light_v0, scene.light_e1, scene.light_e2,
                     scene.light_normal, scene.light_radiance, flags[:, None]],
                    1).index_select(0, li)
    vec = lambda k: V3(row[:, k], row[:, k + 1], row[:, k + 2])  # noqa: E731
    su = torch.sqrt(torch.clamp(u_bary[..., 0], 0.0, 1.0))
    b1, b2 = 1.0 - su, u_bary[..., 1] * su
    p = vec(0) + vec(3) * b1 + vec(6) * b2
    ln, radiance = vec(9), vec(12)
    two_sided = torch.remainder(row[:, 15], 2.0) > 0.5
    ls_valid = scene.light_mask.any() & (row[:, 15] >= 2.0)
    pdf_area = light_pdf_area(scene)

    to_l = p - hit.point
    d2 = torch.clamp(dot(to_l, to_l), min=1e-12)
    wl = to_l * torch.rsqrt(d2)
    cos_s = dot(hit.normal, wl)
    cos_l = -dot(ln, wl)
    facing = torch.where(two_sided, cos_l != 0.0, cos_l > 0.0)
    cos_l_eff = cos_l.abs()
    f, pdf_b = eval_lambert(hit, wl)
    candidate = (ls_valid & hit.valid & (cos_s > 0.0) & facing & (pdf_area > 0.0)
                 & ((f.x > 0.0) | (f.y > 0.0) | (f.z > 0.0)))
    origin = hit.point + hit.normal * SHADOW_EPS
    to_p = p - origin
    d2o = torch.clamp(dot(to_p, to_p), min=1e-12)
    inv_do = torch.rsqrt(d2o)
    blocked = occluded(scene, origin, to_p * inv_do, SHADOW_EPS,
                       torch.where(candidate, d2o * inv_do - SHADOW_EPS, 0.0))
    scale = cos_s * (cos_l_eff / d2) / torch.clamp(pdf_area, min=1e-12)
    pdf_l_sa = pdf_area * d2 / torch.clamp(cos_l_eff, min=1e-8)
    scale = scale * pdf_l_sa**2 / torch.clamp(pdf_l_sa**2 + pdf_b**2, min=1e-20)
    scale = torch.where(candidate & ~blocked, scale, 0.0)
    return f * radiance * scale


# --- the integrator settings it follows ---------------------------------------

# the settings (the program's PathTracerConfig names) that this reference
# follows with one value only, and those it takes as they are
ONLY = {"estimator": "physical", "nee": True, "mis": True, "rr_enable": True,
        "t_min": RAY_EPS, "motion_blur": False}
TAKEN = {"max_depth": "depth", "rr_start": "rr_start", "wavefront": "wavefront"}


def follow(integrator: dict) -> dict:
    """The keyword arguments of this reference's renders for a
    configuration's integrator settings. A setting it does not follow, or
    a value of one that it follows with one value only, is refused
    (ValueError), never ignored. `remat` changes where the program keeps
    its tape, not its result, and is accepted with any value."""
    kw = {}
    for k, v in integrator.items():
        if k in TAKEN:
            kw[TAKEN[k]] = int(v)
        elif k in ONLY:
            if v != ONLY[k]:
                raise ValueError(f"the reference follows {k} = {ONLY[k]!r} only, not {v!r}")
        elif k != "remat":
            raise ValueError(f"the reference does not follow the integrator setting {k!r}")
    return kw


# --- the bounce loop ----------------------------------------------------------


class State(NamedTuple):
    o: V3
    d: V3
    thr: V3
    rad: V3
    prev_pdf: torch.Tensor
    alive: torch.Tensor
    specular: torch.Tensor


def bounce(scene, s: State, keys, b: int, rr_start: int) -> State:
    dt = scene.dtype
    bkey = rng.fold_in(keys, b)
    o, d, thr, rad, alive = s.o, s.d, s.thr, s.rad, s.alive
    hit = intersect(scene, o, d, RAY_EPS, torch.where(alive, 1e8, 0.0).to(dt))
    zc = torch.zeros_like(hit.t)
    zero = V3(zc, zc, zc)
    # a miss adds the (black) background, an emitter its radiance under MIS
    emits = hit.valid & hit.front
    Le = vwhere(emits, hit.emission, zero)
    hit_light = alive & hit.valid & ((Le.x > 0.0) | (Le.y > 0.0) | (Le.z > 0.0))
    cos_l = dot(hit.normal, d).abs()
    pdf_l_sa = light_pdf_area(scene) * hit.t**2 / torch.clamp(cos_l, min=1e-8)
    w_bsdf = s.prev_pdf**2 / torch.clamp(s.prev_pdf**2 + pdf_l_sa**2, min=1e-20)
    w = torch.where(s.specular, 1.0, w_bsdf)
    rad = rad + vwhere(hit_light, thr * Le * w, zero)
    alive = alive & hit.valid & (hit.mtype != EMISSIVE)
    rad = rad + vwhere(alive, thr * next_event(scene, hit, bkey), zero)

    # cosine-weighted lambert sample
    u = rng.uniforms(bkey, 0, (2,), dtype=dt)
    r = torch.sqrt(torch.clamp(u[..., 0], 0.0, 1.0))
    phi = TWO_PI * u[..., 1]
    lz = torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))
    pdf = torch.clamp(lz, min=1e-8) / math.pi
    wi = onb_to_world(r * torch.cos(phi), r * torch.sin(phi), lz, hit.normal)
    ok = torch.clamp(dot(wi, hit.normal), min=0.0) > 0.0
    thr = thr * hit.albedo
    alive = alive & ok & ((thr.x > 0.0) | (thr.y > 0.0) | (thr.z > 0.0))
    flip = torch.where(dot(hit.normal, wi) >= 0.0, RAY_EPS, -RAY_EPS)
    o, d = hit.point + hit.normal * flip, wi
    if b >= rr_start:
        p = torch.clamp(thr.max_component(), 0.05, 0.95).detach()
        thr = thr * (1.0 / p)
        alive = alive & (rng.uniforms(bkey, 99, dtype=dt) < p)
    thr = vwhere(alive, thr, zero)
    # a finished lane's next ray is a fixed one with no graph
    o = vwhere(alive, o, zero)
    d = vwhere(alive, d, V3(zc, zc, zc + 1.0))
    return State(o, d, thr, rad, pdf, alive, torch.zeros_like(alive))


def buckets(fractions, max_depth: int, B: int) -> list:
    """Lanes kept at each bounce: fraction * B rounded up to 1024, never
    more than the bounce before."""
    ks, prev = [], B
    for f in fractions:
        k = min(B, -(-int(round(f * B)) // 1024) * 1024) if B >= 1024 else \
            min(B, max(1, int(round(f * B))))
        prev = min(k, prev)
        ks.append(prev)
    return ks


def kth_pair(u, pid, k):
    o1 = torch.argsort(pid, stable=True)
    u1, p1 = u[o1], pid[o1]
    o2 = torch.argsort(u1, stable=True)
    return u1[o2][k], p1[o2][k]


def radiance(scene, o: V3, d: V3, keys, depth: int, rr_start: int,
             compact=()) -> V3:
    """Radiance of each camera ray. With a compaction schedule, before a
    bounce whose bucket is smaller than the lanes in flight, a uniform
    random subset of the live lanes (by (u, lane) order, u from the lane's
    key) is kept and reweighted by live / bucket; the others end."""
    B = o.x.shape[0]
    one = torch.ones((B,), dtype=scene.dtype, device=o.x.device)
    zero = torch.zeros_like(one)
    alive = torch.ones((B,), dtype=torch.bool, device=o.x.device)
    s = State(o, d, V3(one, one, one), V3(zero, zero, zero), one, alive,
              torch.ones_like(alive))
    ks = buckets(compact, depth, B) if compact and depth > 1 else None
    pid = torch.arange(B, device=o.x.device)
    inflight = B
    for b in range(depth):
        if ks is not None and b >= 1 and ks[b] < inflight:
            K = inflight = ks[b]
            u = rng.uniforms(rng.fold_in(keys, b), 97)
            u = torch.where(s.alive, u, 2.0)
            tu, tp = kth_pair(u, pid, K - 1)
            sel = s.alive & ((u < tu) | ((u == tu) & (pid <= tp)))
            comp = torch.clamp(s.alive.sum().to(scene.dtype) / K, min=1.0)
            s = s._replace(thr=vwhere(sel, s.thr * comp, s.thr), alive=sel)
        s = bounce(scene, s, keys, b, rr_start)
    return s.rad


# --- renders -----------------------------------------------------------------


def spp_group(spp: int, B: int, target: int) -> int:
    cap = max(1, min(spp, target // max(B, 1)))
    best = 1
    for g in range(1, cap + 1):
        if spp % g == 0 and TILE % g == 0:
            best = g
    if best > 1:
        return best
    g = cap
    while spp % g:
        g -= 1
    return g


def tile_shape(G: int):
    px = max(1, TILE // max(G, 1))
    h = 1
    while h * 2 * h * 2 <= px:
        h *= 2
    return max(1, px // h), h


def tiled_order(width: int, height: int, tw: int, th: int):
    ids = np.arange(width * height, dtype=np.int64)
    x, y = ids % width, ids // width
    key = (((y // th) * ((width + tw - 1) // tw) + (x // tw)) * (tw * th)
           + (y % th) * tw + (x % tw))
    perm = np.argsort(key, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv


def camera_rays(cam, u, v, lens_uv):
    """Rays through film points (u, v); the lens sample is drawn and
    scaled by a zero lens radius, as a thin lens of radius 0."""
    tl, rv, dv = V3.of(cam.topleft), V3.of(cam.right_vec), V3.of(cam.down_vec)
    target = tl + rv * u + dv * v
    pos = V3.of(cam.position)
    origin = V3(*(c.expand_as(u) for c in pos))
    r = torch.sqrt(torch.clamp(lens_uv[..., 0], 0.0, 1.0))
    phi = TWO_PI * lens_uv[..., 1]
    dx, dy = r * torch.cos(phi) * 0.0, r * torch.sin(phi) * 0.0
    target = pos + (target - pos) * 1.0
    origin = origin + V3(dx + dy, dx + dy, dx + dy)
    dd = target - origin
    n2 = dot(dd, dd)
    eps2 = 1e-8 * 1e-8
    return origin, dd * torch.where(n2 > eps2, torch.rsqrt(torch.clamp(n2, min=eps2)), 1.0)


def render_image(scene, cam, width, height, spp, key, depth=5, rr_start=3,
                 wavefront=1 << 19, compact=()):
    """A frame: (height, width, 3), the mean of `spp` jittered samples, the
    samples of a pixel G to a wavefront, lanes in tile order."""
    dev = scene.tri_v0.device
    dt = scene.dtype
    B = width * height
    G = spp_group(spp, B, wavefront)
    n_chunks = max(1, -(-B // wavefront)) if G == 1 else 1
    Bc = -(-B // n_chunks)
    Bc = -(-Bc // TILE) * TILE
    j, i = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                          torch.arange(width, dtype=torch.float32, device=dev),
                          indexing="ij")
    px, py = i.reshape(-1), j.reshape(-1)
    perm, inv = tiled_order(width, height, *tile_shape(G))
    perm_t = torch.as_tensor(perm, device=dev)
    px, py = px[perm_t], py[perm_t]
    if n_chunks * Bc != B:
        reps = torch.arange(n_chunks * Bc - B, device=dev) % B
        px, py = torch.cat([px, px[reps]]), torch.cat([py, py[reps]])
    base = rng.fold_in(key, torch.arange(n_chunks * Bc, device=dev))
    pxg, pyg = px.repeat_interleave(G), py.repeat_interleave(G)
    acc = [torch.zeros((Bc, 3), dtype=dt, device=dev) for _ in range(n_chunks)]
    for step in range((spp // G) * n_chunks):
        g, ci = divmod(step, n_chunks)
        off = ci * Bc
        sidx = g * G + torch.arange(G, device=dev)
        skeys = rng.fold_in(base[off:off + Bc][:, None, :], sidx[None, :]).reshape(Bc * G, 2)
        jit = rng.uniforms(skeys, 1000, (2,))
        lens = rng.uniforms(skeys, 1001, (2,))
        u = (pxg[off * G:(off + Bc) * G] + jit[:, 0]) / width
        v = (pyg[off * G:(off + Bc) * G] + jit[:, 1]) / height
        o, d = camera_rays(cam, u.to(dt), v.to(dt), lens.to(dt))
        rad = radiance(scene, o, d, skeys, depth, rr_start, compact)
        rad = torch.stack([rad.x, rad.y, rad.z], -1)
        acc[ci] = acc[ci] + rad.reshape(Bc, G, 3).sum(dim=1)
    img = torch.cat(acc)[:B].index_select(0, torch.as_tensor(inv, device=dev)) / spp
    return img.reshape(height, width, 3)


def render_pixels(scene, cam, ids, width, height, spp, key, depth=5, rr_start=3,
                  wavefront=1 << 19, compact=(), sample_offset=0):
    """`spp` samples of the flat pixel ids -> (B, 3): sample s of pixel p
    keyed fold_in(fold_in(key, p), s + offset)."""
    dev = scene.tri_v0.device
    dt = scene.dtype
    B = ids.shape[0]
    px, py = (ids % width).to(torch.float32), (ids // width).to(torch.float32)
    base = rng.fold_in(key, ids)
    G = spp_group(spp, B, wavefront)
    pxg, pyg = px.repeat_interleave(G), py.repeat_interleave(G)
    acc = torch.zeros((B, 3), dtype=dt, device=dev)
    for g in range(spp // G):
        sidx = sample_offset + g * G + torch.arange(G, device=dev)
        skeys = rng.fold_in(base[:, None, :], sidx[None, :]).reshape(B * G, 2)
        jit = rng.uniforms(skeys, 1000, (2,))
        lens = rng.uniforms(skeys, 1001, (2,))
        o, d = camera_rays(cam, ((pxg + jit[:, 0]) / width).to(dt),
                           ((pyg + jit[:, 1]) / height).to(dt), lens.to(dt))
        rad = radiance(scene, o, d, skeys, depth, rr_start, compact)
        acc = acc + torch.stack([rad.x, rad.y, rad.z], -1).reshape(B, G, 3).sum(dim=1)
    return acc / spp


@torch.no_grad()
def film_sum(scene, cam, ids, width, height, passes, key, depth=5, rr_start=3,
             lanes=1 << 19):
    """The progressive film's running sum at `ids` after `passes` one-sample
    passes without compaction (pass s draws sample s), summed pass by pass."""
    dev = scene.tri_v0.device
    n = ids.shape[0]
    rows = []
    per = max(1, lanes // max(n, 1))
    for s0 in range(0, passes, per):
        s = torch.arange(s0, min(passes, s0 + per), device=dev)
        pix = ids.repeat(s.shape[0])
        samp = s.repeat_interleave(n)
        base = rng.fold_in(key, pix)
        skeys = rng.fold_in(base, samp)
        px, py = (pix % width).to(torch.float32), (pix // width).to(torch.float32)
        jit = rng.uniforms(skeys, 1000, (2,))
        lens = rng.uniforms(skeys, 1001, (2,))
        o, d = camera_rays(cam, ((px + jit[:, 0]) / width).to(scene.dtype),
                           ((py + jit[:, 1]) / height).to(scene.dtype),
                           lens.to(scene.dtype))
        rad = radiance(scene, o, d, skeys, depth, rr_start)
        rows.append(torch.stack([rad.x, rad.y, rad.z], -1).reshape(-1, n, 3))
    frames = torch.cat(rows)
    total = torch.zeros((n, 3), dtype=frames.dtype, device=dev)
    for f in frames:
        total = total + f
    return total
