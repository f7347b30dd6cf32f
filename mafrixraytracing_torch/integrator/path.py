"""Wavefront path integrator with next-event estimation (physical estimator).

Port of `mafrixraytracing_tpu/integrator/path.py`: a wavefront of path
states advances through a bounce loop (a Python loop here), dead paths are
masked, and between bounces the wavefront can be compacted: live lanes are
packed to the front with one stable sort and the wavefront is cut to a
per-bounce bucket (`compact` schedule). If more rays survive than a bucket
holds, a uniform-random subset is kept and reweighted by live / bucket
(population-control Russian roulette, unbiased). With `remat`,
`render_image` checkpoints each step (`ops.remat`): the backward holds the
searches' results, not the activations.

Two estimators (`PathTracerConfig.estimator`):
- "physical" (default): cosine-sampled BSDFs, NEE with power-2 MIS against
  BSDF sampling, emissive surfaces visible, Russian roulette from `rr_start`.
- "mafrix": the reference renderer's estimator with its quirks, for the
  parity gate (JAX `_trace_mafrix`, `path.py:625-687`): uniform-hemisphere
  lambert with weight albedo * 2 cos; direct light cos_s * I * |cos_l| *
  Area^2 / d^2; the direct term multiplied by the BSDF sample's weight; the
  shadow ray cast from the hit point itself; lights invisible to camera and
  BSDF rays; a miss is black; no Russian roulette.
Gradients flow through autograd to material albedo, light radiance and
vertex positions (detached closest-hit selection and visibility,
reparameterized hit attributes — see `geometry.intersect`).

Ray order is part of the result's bits: keys are assigned by position in
the tile-swizzled pixel order, which depends on TILE = 128 (the
`ops.intersect` ray tile), so `tiled_pixel_order` and `_spp_group` keep it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from mafrixraytracing_torch.core import rng, v3
from mafrixraytracing_torch.core.v3 import V3
from mafrixraytracing_torch.geometry.intersect import packed_attr_table
from mafrixraytracing_torch.lights import lights as L
from mafrixraytracing_torch.materials.bsdf import (
    EMISSIVE,
    emitted_soa,
    sample_bsdf_soa,
)
from mafrixraytracing_torch.ops import dispatch, graph, remat
from mafrixraytracing_torch.ops import intersect as ops_isect
from mafrixraytracing_torch.ops.intersect import TILE
from mafrixraytracing_torch.utils.trace import spanned

RAY_EPS = 1e-3


@dataclass(frozen=True)
class PathTracerConfig:
    """Integrator configuration (reference hard-codes: depth 3,
    `Scene/Scene.fs:304`; shadow epsilon, `Integrators.fs:44,108`)."""

    max_depth: int = 5          # number of surface interactions
    estimator: str = "physical"  # "physical" | "mafrix"
    mis: bool = True
    nee: bool = True
    rr_start: int = 3           # bounce index where Russian roulette begins
    rr_enable: bool = True
    t_min: float = RAY_EPS
    wavefront: int = 1 << 19    # target rays in flight: render_image groups
                                # several spp into one wavefront
    compact: tuple = ()         # fraction of the initial wavefront kept at
                                # each bounce (len == max_depth, first 1.0);
                                # () = no compaction
    motion_blur: bool = False   # sample a shutter time per camera ray and
                                # intersect moving spheres at that time
    remat: bool | None = None   # checkpoint each (pixel-chunk, spp-group)
                                # step of render_image: the backward holds
                                # the searches' results, not the activations,
                                # and runs no walk or cull again. None: where
                                # the graph would not fit (`ops.remat.needed`).
                                # The same result either way (JAX: True)


class PathState(NamedTuple):
    o: V3
    d: V3
    thr: V3                     # throughput
    rad: V3                     # accumulated radiance
    prev_pdf: torch.Tensor      # pdf of the previous BSDF sample (MIS)
    alive: torch.Tensor
    specular: torch.Tensor      # previous bounce was a delta lobe
    keys: torch.Tensor          # (B, 2) per-path RNG keys
    times: torch.Tensor         # shutter time of the path's camera ray
                                # (zeros without motion blur)


def _take(state: PathState, perm: torch.Tensor, n: int) -> PathState:
    """Gather every column by `perm` and keep the first n lanes."""
    p = perm[:n]
    g = lambda c: c.index_select(0, p)  # noqa: E731
    return PathState(state.o.map(g), state.d.map(g), state.thr.map(g),
                     state.rad.map(g), g(state.prev_pdf), g(state.alive),
                     g(state.specular), g(state.keys), g(state.times))


def _retire(alive, o: V3, d: V3):
    """The next ray of each lane: a dead lane's becomes a fixed finite ray
    with no graph. Its own is built from a hit that may be a miss, whose
    attributes come from a row it did not hit (on a sphere scene, a normal
    of ~1e8 from a padding row); over the next bounces it grows to inf, and
    the masked computations on it return NaN cotangents to the scene."""
    zero = torch.zeros_like(o.x)
    return (v3.where(alive, o, V3(zero, zero, zero)),
            v3.where(alive, d, V3(zero, zero, zero + 1.0)))


@spanned("bounce")
def _bounce(scene, state: PathState, bounce: int, config: PathTracerConfig,
            packed: torch.Tensor) -> PathState:
    """One wavefront bounce of the physical estimator (JAX
    `_trace_physical.bounce_step`, `path.py:473-586`)."""
    o, d, thr, rad = state.o, state.d, state.thr, state.rad
    alive, prev_pdf, prev_specular = state.alive, state.prev_pdf, state.specular
    bkey = rng.bounce_key(state.keys, bounce)
    # secondary rays inherit their camera ray's shutter time
    times = state.times if config.motion_blur else None

    def occluded_fn(so, sd, t_min, t_max):
        # NEE batches one shadow ray per light row: the origins are tiled
        reps = so.x.shape[0] // o.x.shape[0]
        return dispatch.occluded_soa(
            scene, so, sd, t_min, t_max,
            times=None if times is None else times.repeat(reps))

    # dead lanes get t_max = 0: the cull then drops every cluster for them
    t_max = torch.where(alive, 1e8, 0.0)
    hit, sh = dispatch.intersect_shade_soa(scene, o, d, config.t_min, t_max,
                                           packed=packed, times=times)
    zero_c = torch.zeros_like(hit.t)
    zero = V3(zero_c, zero_c, zero_c)

    # --- miss: constant background, then retire the path ---
    miss = alive & ~hit.valid
    rad = rad + v3.where(miss, thr * V3.of(scene.background), zero)

    # --- emissive hit (BSDF-sampling side of MIS) ---
    Le = emitted_soa(sh, hit)
    hit_light = alive & hit.valid & ((Le.x > 0.0) | (Le.y > 0.0) | (Le.z > 0.0))
    if config.nee and config.mis:
        pdf_a = L.light_pdf_area(scene)
        cos_l = v3.dot(hit.normal, d).abs()
        pdf_l_sa = pdf_a * hit.t**2 / torch.clamp(cos_l, min=1e-8)
        w_bsdf = prev_pdf**2 / torch.clamp(prev_pdf**2 + pdf_l_sa**2, min=1e-20)
        w = torch.where(prev_specular, 1.0, w_bsdf)
    elif config.nee:
        w = torch.where(prev_specular, 1.0, 0.0)
    else:
        w = torch.ones_like(hit.t)
    if config.nee:
        # sphere lights: MIS against the cone sampler's solid-angle pdf
        if config.mis:
            pls = sh.light_pdf_sa
            w_sph = prev_pdf**2 / torch.clamp(prev_pdf**2 + pls**2, min=1e-20)
            w_sph = torch.where(prev_specular, 1.0, w_sph)
        else:
            w_sph = torch.where(prev_specular, 1.0, 0.0)
        w = torch.where(hit.prim_idx >= scene.tri_v0.shape[0], w_sph, w)
    rad = rad + v3.where(hit_light, thr * Le * w, zero)

    alive = alive & hit.valid & (sh.mtype != EMISSIVE)

    # --- next-event estimation ---
    if config.nee:
        wo = -d if scene.has_glossy else None
        direct = (
            L.nee_area_soa(scene, hit, bkey, occluded_fn, config.mis, sh, wo=wo)
            + L.nee_point_soa(scene, hit, occluded_fn, sh, wo=wo)
            + L.nee_sphere_soa(scene, hit, bkey, occluded_fn, sh,
                               mis=config.mis, wo=wo, times=times)
        )
        rad = rad + v3.where(alive, thr * direct, zero)

    # --- BSDF sample & bounce (lobes pruned to the scene's materials) ---
    bs = sample_bsdf_soa(sh, hit, -d, bkey, glossy=scene.has_glossy,
                         metal=scene.has_metal, dielectric=scene.has_dielectric)
    thr = thr * bs.weight
    alive = alive & bs.valid & ((thr.x > 0.0) | (thr.y > 0.0) | (thr.z > 0.0))
    flip = torch.where(v3.dot(hit.normal, bs.wi) >= 0.0, RAY_EPS, -RAY_EPS)
    o = hit.point + hit.normal * flip
    d = bs.wi

    # --- Russian roulette (detached probability) ---
    if config.rr_enable and bounce >= config.rr_start:
        p = torch.clamp(thr.max_component(), 0.05, 0.95).detach()
        u = rng.uniforms(bkey, 99)
        thr = thr * (1.0 / p)
        alive = alive & (u < p)

    thr = v3.where(alive, thr, zero)
    o, d = _retire(alive, o, d)
    return PathState(o, d, thr, rad, bs.pdf, alive, bs.specular, state.keys,
                     state.times)


@spanned("bounce")
def _bounce_mafrix(scene, state: PathState, bounce: int,
                   config: PathTracerConfig, packed: torch.Tensor) -> PathState:
    """One wavefront bounce of the reference-parity estimator (JAX
    `_trace_mafrix.bounce_step`, `path.py:632-678`, the reference's
    `Integrators.fs:107-138`). `prev_pdf` and `specular` are carried
    unused."""
    o, d, thr, rad, alive = state.o, state.d, state.thr, state.rad, state.alive
    bkey = rng.bounce_key(state.keys, bounce)
    t_max = torch.where(alive, 1e8, 0.0)
    hit, sh = dispatch.intersect_shade_soa(scene, o, d, config.t_min, t_max,
                                           packed=packed)
    zero_c = torch.zeros_like(hit.t)
    zero = V3(zero_c, zero_c, zero_c)
    alive = alive & hit.valid

    # BSDF sample first: its weight multiplies the direct term and the
    # recursion alike, `(l / pdf + TraceRay(...)) * col / pdf`. An emitter
    # scatters nothing: it ends the path with weight 0.
    bs = sample_bsdf_soa(sh, hit, -d, bkey, glossy=scene.has_glossy,
                         metal=scene.has_metal, dielectric=scene.has_dielectric,
                         uniform_lambert=True)
    emitter = sh.mtype == EMISSIVE
    thr = v3.where(alive, thr * v3.where(emitter, zero, bs.weight), thr)

    # direct light with the reference's Area^2 fold:
    # l / pdf_li = cos_s * I * |cos_l| * Area^2 / d^2 (`Light.fs:48-59`)
    p, ln, radiance, _, ls_valid = L.sample_area_lights_soa(scene, bkey)
    to_l = p - hit.point
    d2 = torch.clamp(v3.dot(to_l, to_l), min=1e-12)
    dist = torch.sqrt(d2)
    wl = to_l.map(lambda c: c / dist)
    cos_s = v3.dot(hit.normal, wl)
    cos_l = -v3.dot(ln, wl)
    # the reference's shadow protocol: from the hit point itself over
    # (eps, dist - eps), no offset (`Integrators.fs:44`); lanes that cannot
    # contribute get t_max = 0 so the cull drops them
    candidate = alive & ls_valid & (cos_l > 0.0) & (cos_s > 0.0)
    blocked = dispatch.occluded_soa(
        scene, hit.point, wl, L.SHADOW_EPS,
        torch.where(candidate, dist - L.SHADOW_EPS, 0.0))
    direct = radiance * (cos_s * cos_l.abs() * scene.light_total_area**2 / d2)
    rad = rad + v3.where(candidate & ~blocked, thr * direct, zero)

    alive = alive & bs.valid & ~emitter
    flip = torch.where(v3.dot(hit.normal, bs.wi) >= 0.0, RAY_EPS, -RAY_EPS)
    o, d = _retire(alive, hit.point + hit.normal * flip, bs.wi)
    thr = v3.where(alive, thr, zero)
    return PathState(o, d, thr, rad, state.prev_pdf, alive, state.specular,
                     state.keys, state.times)


def _bounce_fn(config: PathTracerConfig):
    if config.estimator == "physical":
        return _bounce
    if config.estimator == "mafrix":
        return _bounce_mafrix
    raise ValueError(f"unknown estimator {config.estimator!r}")


# --- wavefront compaction ---------------------------------------------------


def compact_buckets(config: PathTracerConfig, B: int) -> list[int]:
    """Per-bounce wavefront sizes from the fraction schedule, rounded up to
    1024 (as the JAX package does, so both keep the same lanes);
    non-increasing."""
    fr = config.compact
    if len(fr) != config.max_depth:
        raise ValueError(f"compact has {len(fr)} entries, max_depth is "
                         f"{config.max_depth}")
    if abs(fr[0] - 1.0) > 1e-9:
        raise ValueError("the first bucket must keep the full wavefront")
    ks, prev = [], B
    for f in fr:
        if B >= 1024:
            k = min(B, -(-int(round(f * B)) // 1024) * 1024)
        else:
            k = min(B, max(1, int(round(f * B))))
        k = min(k, prev)
        ks.append(k)
        prev = k
    return ks


def _lex_kth(u: torch.Tensor, pid: torch.Tensor, k: int):
    """The k-th smallest (u, pid) pair in lexicographic order: sort by pid,
    then stable-sort by u (pid is not ascending after a compaction)."""
    o1 = torch.argsort(pid, stable=True)
    u1, p1 = u[o1], pid[o1]
    o2 = torch.argsort(u1, stable=True)
    return u1[o2][k], p1[o2][k]


def _population_select(alive, keys, pid, bounce: int, K: int):
    """Pick a uniform-random subset of at most K live lanes; ties on the
    random key are broken by lane id, so the pick does not depend on the
    wavefront's order. Returns (selected, compensation = max(live/K, 1))."""
    u = rng.uniforms(rng.bounce_key(keys, bounce), 97)
    u = torch.where(alive, u, 2.0)
    tau_u, tau_p = _lex_kth(u, pid, K - 1)
    selected = alive & ((u < tau_u) | ((u == tau_u) & (pid <= tau_p)))
    comp = torch.clamp(alive.sum().to(torch.float32) / K, min=1.0)
    return selected, comp


def _coherence_key_soa(scene, o: V3, d: V3, alive) -> torch.Tensor:
    """21-bit wavefront-coherence sort key: origin Morton (4 bits/axis) |
    direction octant (3) | direction Morton (2 bits/axis); dead rays sort
    last. The image does not depend on it (each lane is an independent
    path); it groups similar rays into the same 128-ray tile."""
    cmin, cmax = scene.cluster_min, scene.cluster_max
    lo = torch.where(cmin < 1e30, cmin, torch.inf).amin(dim=0)
    hi = torch.where(cmax > -1e30, cmax, -torch.inf).amax(dim=0)
    span = torch.clamp(hi - lo, min=1e-6)

    def interleave(cols, bits):
        k = torch.zeros_like(cols[0])
        for b in range(bits):
            k = (k | (((cols[0] >> b) & 1) << (3 * b + 2))
                 | (((cols[1] >> b) & 1) << (3 * b + 1))
                 | (((cols[2] >> b) & 1) << (3 * b)))
        return k

    q = tuple(torch.nan_to_num((c - lo[a]) / span[a] * 16.0)
              .clamp(0, 15).to(torch.int32) for a, c in enumerate(o))
    octant = (((d.x > 0).to(torch.int32) << 2) | ((d.y > 0).to(torch.int32) << 1)
              | (d.z > 0).to(torch.int32))
    qd = tuple(((c * 0.5 + 0.5) * 4.0).clamp(0, 3).to(torch.int32) for c in d)
    key = (interleave(q, 4) << 9) | (octant << 6) | interleave(qd, 2)
    return torch.where(alive, key, 1 << 30)


def _compact_bounce_loop(scene, state: PathState, config, packed) -> V3:
    """Bounce loop with per-bounce wavefront shrinking. Returns the radiance
    per lane in the original lane order."""
    B = state.alive.shape[0]
    buckets = compact_buckets(config, B)
    bounce = _bounce_fn(config)
    state = bounce(scene, state, 0, config, packed)
    pid = torch.arange(B, device=state.alive.device)
    frag_pid, frag_rad = [], []
    for b in range(1, config.max_depth):
        K = buckets[b]
        if K < state.alive.shape[0]:
            selected, comp = _population_select(state.alive, state.keys, pid, b, K)
            state = state._replace(thr=v3.where(selected, state.thr * comp, state.thr))
            # pack the selected lanes first, grouped by coherence key (stable:
            # equal keys keep their order); retire the rest into fragments
            skey = _coherence_key_soa(scene, state.o, state.d, selected)
            perm = torch.sort(skey, stable=True).indices
            n_sel = selected.sum()
            rest = perm[K:]
            frag_pid.append(pid[rest])
            frag_rad.append(state.rad.map(lambda c: c.index_select(0, rest)))
            state = _take(state, perm, K)
            state = state._replace(
                alive=torch.arange(K, device=pid.device) < n_sel)
            pid = pid[perm[:K]]
        state = bounce(scene, state, b, config, packed)
    frag_pid.append(pid)
    frag_rad.append(state.rad)
    order = torch.argsort(torch.cat(frag_pid))
    return V3(*(torch.cat([f[c] for f in frag_rad]).index_select(0, order)
                for c in range(3)))


def trace_radiance(scene, o: V3, d: V3, keys: torch.Tensor,
                   config: PathTracerConfig, packed=None,
                   times=None) -> torch.Tensor:
    """Estimate radiance for a batch of camera rays (o, d as V3 of (B,)
    columns, keys (B, 2)); `times` (B,) are the rays' shutter times, read
    when `config.motion_blur` (the physical estimator only, as in the JAX
    package). Returns (B, 3)."""
    if packed is None:
        packed = packed_attr_table(scene)
    B = o.x.shape[0]
    one = torch.ones((B,), dtype=torch.float32, device=o.x.device)
    zero = torch.zeros_like(one)
    state = PathState(o, d, V3(one, one, one), V3(zero, zero, zero), one,
                      torch.ones((B,), dtype=torch.bool, device=o.x.device),
                      torch.ones((B,), dtype=torch.bool, device=o.x.device),
                      keys, zero if times is None else times)
    if config.compact and config.max_depth > 1:
        rad = _compact_bounce_loop(scene, state, config, packed)
    else:
        bounce = _bounce_fn(config)
        for b in range(config.max_depth):
            state = bounce(scene, state, b, config, packed)
        rad = state.rad
    return rad.arr()


@torch.no_grad()
def trace_stats(scene, o: V3, d: V3, keys: torch.Tensor,
                config: PathTracerConfig, return_profile: bool = False):
    """Count ray queries (closest-hit + shadow) for one wavefront: the ray
    accounting of the benchmark. Mirrors the estimator's control flow
    without shading, including the Russian-roulette survival rule and the
    compaction schedule's population-control kills (same RNG streams), so
    the count tracks what a render traces. With `return_profile`, also the
    (max_depth,) live fraction at the top of each bounce."""
    B = o.x.shape[0]
    dev = o.x.device
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    one = torch.ones((B,), dtype=torch.float32, device=dev)
    thr = V3(one, one, one)
    queries = torch.zeros((), dtype=torch.float32, device=dev)
    pid = torch.arange(B, device=dev)
    buckets = compact_buckets(config, B) if config.compact else None
    profile = []
    # shadow-query families per bounce: one batched area-light query when
    # any area light exists, one per live point light and sphere light
    n_shadow = (scene.light_mask.any().to(torch.float32)
                + scene.plight_mask.to(torch.float32).sum()
                + scene.slight_mask.to(torch.float32).sum())
    for bounce in range(config.max_depth):
        if buckets and bounce >= 1 and buckets[bounce] < buckets[bounce - 1]:
            selected, comp = _population_select(alive, keys, pid, bounce,
                                                buckets[bounce])
            thr = v3.where(selected, thr * comp, thr)
            alive = selected
        bkey = rng.bounce_key(keys, bounce)
        profile.append(alive.to(torch.float32).mean())
        queries = queries + alive.sum()
        t_max = 1e8 if bounce == 0 else torch.where(alive, 1e8, 0.0)
        hit, sh = dispatch.intersect_shade_soa(scene, o, d, config.t_min, t_max)
        alive = alive & hit.valid & (sh.mtype != EMISSIVE)
        if config.nee:
            queries = queries + n_shadow * alive.sum()
        bs = sample_bsdf_soa(sh, hit, -d, bkey)
        thr = thr * bs.weight
        alive = alive & bs.valid & (thr.max_component() > 0.0)
        offset = torch.where(v3.dot(hit.normal, bs.wi) >= 0.0, 1.0, -1.0)
        o = hit.point + hit.normal * offset * RAY_EPS
        d = bs.wi
        if config.rr_enable and bounce >= config.rr_start:
            p = torch.clamp(thr.max_component(), 0.05, 0.95)
            u = rng.uniforms(bkey, 99)
            alive = alive & (u < p)
            thr = V3(thr.x / p, thr.y / p, thr.z / p)
        thr = v3.where(alive, thr, V3(*(torch.zeros_like(c) for c in thr)))
    if return_profile:
        return queries, torch.stack(profile)
    return queries


# --- pixel sampling / full-frame rendering ----------------------------------


def make_pixel_uv(width: int, height: int, device=None):
    """Flat pixel grid: u along +x (columns), v along +y downward (rows)
    (`Integrators.fs:161-171`)."""
    j, i = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return i.reshape(-1), j.reshape(-1)


def tiled_pixel_order(width: int, height: int, tile_w: int, tile_h: int):
    """Permutation putting pixels in (tile-row, tile-col, in-tile) order so
    each run of tile_w * tile_h rays is a compact screen block (a tighter
    cull per 128-ray tile). Returns (perm, inv_perm) as numpy int64."""
    ids = np.arange(width * height, dtype=np.int64)
    x = ids % width
    y = ids // width
    key = (
        ((y // tile_h) * ((width + tile_w - 1) // tile_w) + (x // tile_w))
        * (tile_w * tile_h)
        + (y % tile_h) * tile_w
        + (x % tile_w)
    )
    perm = np.argsort(key, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv


def _spp_group(spp: int, B: int, target: int) -> int:
    """Largest divisor of spp keeping the wavefront B * G near `target`,
    preferring divisors of TILE so a pixel's samples never straddle tiles."""
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


def _spp_tile_shape(G: int):
    """Pixel block of a 128-ray tile when each pixel carries G consecutive
    samples: TILE / G pixels, near-square."""
    px = max(1, TILE // max(G, 1))
    h = 1
    while h * 2 * h * 2 <= px:
        h *= 2
    return max(1, px // h), h


@spanned("render")
def render_image(scene, camera, width: int, height: int, spp: int,
                 key: torch.Tensor,
                 config: PathTracerConfig = PathTracerConfig()) -> torch.Tensor:
    """Render a frame: (height, width, 3) linear radiance averaged over `spp`
    jittered samples per pixel, from root key `key` ((2,), `rng.root_key`).
    Samples are grouped G to a wavefront of ~config.wavefront rays; a frame
    larger than one wavefront at G = 1 is rendered in pixel chunks.
    Differentiable with respect to the scene's tensors."""
    dev = scene.tri_v0.device
    B = width * height
    G = _spp_group(spp, B, config.wavefront)
    n_chunks = max(1, -(-B // config.wavefront)) if G == 1 else 1
    Bc = -(-B // n_chunks)
    Bc = -(-Bc // TILE) * TILE
    B_pad = n_chunks * Bc
    px, py = make_pixel_uv(width, height, dev)
    perm, inv = tiled_pixel_order(width, height, *_spp_tile_shape(G))
    perm_t = torch.as_tensor(perm, device=dev)
    px, py = px[perm_t], py[perm_t]  # tile-swizzled ray order
    if B_pad != B:
        # pad with repeated pixels (rendered, then dropped at the end)
        reps = torch.arange(B_pad - B, device=dev) % B
        px = torch.cat([px, px[reps]])
        py = torch.cat([py, py[reps]])
    base_keys = rng.pixel_keys(key.to(dev), B_pad)
    # a pixel's G samples sit consecutively, so one 128-ray tile covers
    # TILE / G pixels
    pxg, pyg = px.repeat_interleave(G), py.repeat_interleave(G)
    packed = packed_attr_table(scene)

    def group(g: int, ci: int) -> torch.Tensor:
        off = ci * Bc
        keys_c = base_keys[off:off + Bc]
        sidx = g * G + torch.arange(G, device=dev)
        skeys = rng.sample_key(keys_c[:, None, :], sidx[None, :]).reshape(Bc * G, 2)
        jit_uv = rng.uniforms(skeys, 1000, (2,))
        lens_uv = rng.uniforms(skeys, 1001, (2,))
        u = (pxg[off * G:(off + Bc) * G] + jit_uv[:, 0]) / width
        v = (pyg[off * G:(off + Bc) * G] + jit_uv[:, 1]) / height
        o, d = camera.get_rays(u, v, lens_uv=lens_uv)
        times = rng.uniforms(skeys, 1002) if config.motion_blur else None
        rad = trace_radiance(scene, o, d, skeys, config, packed, times=times)
        return rad.reshape(Bc, G, 3).sum(dim=1)

    if remat.needed(config, spp, B, dev):
        # each step under a checkpoint: the backward keeps the searches'
        # results, not the step's activations
        group = remat.checkpointed(group)
    acc = [torch.zeros((Bc, 3), dtype=torch.float32, device=dev)
           for _ in range(n_chunks)]
    for step in range((spp // G) * n_chunks):
        g, ci = divmod(step, n_chunks)
        acc[ci] = acc[ci] + group(g, ci)
    img = torch.cat(acc)[:B].index_select(0, torch.as_tensor(inv, device=dev)) / spp
    return img.reshape(height, width, 3)


def render_sample_batch(scene, camera, width: int, height: int, sample_idx: int,
                        key: torch.Tensor, config: PathTracerConfig) -> torch.Tensor:
    """One 1-spp pass over all pixels in row-major order (the progressive
    film's unit of work, reference `Film.GetFrame(integrator, 1)`,
    `Scene/Scene.fs:332`) -> flat (width * height, 3). On a card without
    grad the pass is replayed as one CUDA graph (`ops.graph`): run eager
    the first time these tensors and settings are seen, captured the
    second, replayed after that, bit-equal to the eager pass."""
    dev = scene.tri_v0.device

    def one_pass(key, sample_idx):
        ids = torch.arange(width * height, device=dev)
        return render_flat_pixels(scene, camera, ids, width, height, 1, key, config,
                                  sample_offset=sample_idx)

    if not scene.tri_v0.is_cuda or torch.is_grad_enabled():
        return one_pass(key, sample_idx)
    return _PASSES.run(pass_signature(scene, camera, width, height, key, config),
                       one_pass, (key, sample_idx), dev)


_PASSES = graph.PassGraphs()


def pass_signature(scene, camera, width: int, height: int, key: torch.Tensor,
                   config: PathTracerConfig) -> tuple:
    """What a captured `render_sample_batch` pass bakes in: the scene's and
    camera's tensors (addresses, shapes, strides) and flags, the film, the
    configuration, the route switches of `ops.intersect`, and the root
    key's shape and dtype, not its value; the sample index is not in it."""
    return graph.signature(scene, camera, width, height, config, tuple(key.shape),
                           key.dtype, torch.is_inference_mode_enabled(),
                           ops_isect.FUSED_CULL, ops_isect.SUPER_MIN_C)


@spanned("render")
def render_flat_pixels(scene, camera, pixel_ids: torch.Tensor, width: int,
                       height: int, spp: int, key: torch.Tensor,
                       config: PathTracerConfig,
                       sample_offset: int | torch.Tensor = 0) -> torch.Tensor:
    """Trace `spp` jittered samples for a flat batch of pixel ids (row-major
    y * width + x) -> (B, 3), the mean over the samples (JAX
    `_render_flat_pixels`, `parallel/render.py:26-53`). Sample s of a pixel
    has the key `sample_key(fold_in(key, pixel_id), s + sample_offset)`,
    whatever the batch's order, so callers can split one sample set across
    calls (`opt.inverse`'s microbatches) without reusing a stream.
    `sample_offset` is an int or a 0-d int64 tensor on the scene's device
    (what a replayed graph reads), with the same sample indices. The JAX
    version scans the samples one wavefront each; here G samples of a pixel
    sit consecutively in one wavefront of ~config.wavefront rays, which
    changes only the order of the sum over samples."""
    dev = scene.tri_v0.device
    B = pixel_ids.shape[0]
    ids = pixel_ids.to(device=dev, dtype=torch.int64)
    px = (ids % width).to(torch.float32)
    py = (ids // width).to(torch.float32)
    base_keys = rng.fold_in(key.to(dev), ids)
    G = _spp_group(spp, B, config.wavefront)
    pxg, pyg = px.repeat_interleave(G), py.repeat_interleave(G)
    packed = packed_attr_table(scene)
    acc = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    for g in range(spp // G):
        sidx = sample_offset + g * G + torch.arange(G, device=dev)
        skeys = rng.sample_key(base_keys[:, None, :], sidx[None, :]).reshape(B * G, 2)
        jit_uv = rng.uniforms(skeys, 1000, (2,))
        lens_uv = rng.uniforms(skeys, 1001, (2,))
        o, d = camera.get_rays((pxg + jit_uv[:, 0]) / width,
                               (pyg + jit_uv[:, 1]) / height, lens_uv=lens_uv)
        times = rng.uniforms(skeys, 1002) if config.motion_blur else None
        rad = trace_radiance(scene, o, d, skeys, config, packed, times=times)
        acc = acc + rad.reshape(B, G, 3).sum(dim=1)
    return acc / spp
