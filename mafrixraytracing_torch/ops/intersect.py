"""Closest-hit and any-hit search over 128-triangle clusters.

Port of the list paths of `mafrixraytracing_tpu/ops/intersect_pallas.py`
(flat and two-level), in two phases:

1. **Cull.** Slab-test every ray against every cluster AABB, take the
   entry distance per 128-ray tile, and sort each tile's surviving clusters
   front to back. `far` is each ray's exit from its last surviving cluster.
   `cull_lists` chooses by the tensors' device and the box count: kernel K
   (`cull_kernel`, `csrc/cull.cu`, one launch a query) for CUDA tensors and at
   most `CP` = 128 boxes; otherwise `cull_reference`, the same function in
   PyTorch (`_cull`: one dense (B, C) computation and a stable `torch.sort` in
   place of the TPU's bitonic network, then the walks' integer types). The
   two agree bit for bit.
2. **Walk (CUDA kernels, `csrc/intersect.cu`).** Kernel A (`closest_kernel`)
   finds each ray's closest hit; kernel B (`anyhit_kernel`) answers shadow
   queries. Both walk a tile's list front to back and exit early; for each
   listed cluster every ray tests its own box (the scene's `cluster_min` and
   `cluster_max`, operands of the flat walk), and the cluster's triangles
   are tested against only the rays that ask for it (a thread a triangle
   when few ask, a ray a thread over the cluster's faces when many do). At
   most `CP` = 128 clusters.

Scenes with more than `SUPER_MIN_C` clusters take the **two-level path**:
the cull runs on the superclusters (16 consecutive clusters each, a 16x
smaller dense pass), the lists hold supercluster ids, and kernels D
(`closest_super_kernel`) and E (`anyhit_super_kernel`,
`csrc/intersect_super.cu`) refine each listed supercluster against its 16
child AABBs (`pack_bounds`), then test each child's triangles against only
the rays that ask for it (a thread a triangle).

With `FUSED_CULL` set (off by default, as in the JAX package) the cull moves
into the walk's block: kernels F, G (flat) and H, I (two-level) of
`csrc/intersect_fused.cu` take the packed box table (`pack_aabbs`, at most
`CP` = 128 clusters or superclusters) and the rays, slab-test, order and walk
in one launch, and `_prep` runs no cull of its own. Their lists equal
`_cull`'s, so they agree bit for bit with A, B, D, E fed by the cull. More
than 128 boxes raise `ValueError`; the fused path never drops to the list
path on its own.

Two instrumented walks, `closest_dbg_kernel` and `closest_full_kernel`
(`csrc/intersect_stats.cu`), run kernel A's own walk on A's operands: one
with a counter of the listed clusters a tile reached before the early exit,
one with the exit off. Only `mafrixraytracing_torch.profile_walk` launches
them; their plain versions (`closest_dbg_reference`,
`closest_full_reference`) model that walk step by step (`_walk_model`).

Around them, as in the JAX package: mega triangles (huge walls and floors,
excluded from the clusters) are tested densely first and cap `t_max`
(`_mega_hits`); spheres are merged densely as index T + s. The search is
detached: gradients come from the attribute recompute in
`geometry.intersect.hit_attributes_soa`.

Each kernel has a plain PyTorch version in this module (`closest_reference`,
`anyhit_reference`, `closest_super_reference`, `anyhit_super_reference`, and
for the fused kernels `fused_*_reference`: `_cull` on the packed boxes, then
the list kernel's plain version): a dense test of every ray against every triangle of the clusters (or of the
children of the superclusters) listed for its tile, in the kernel's
arithmetic and tie-break. The wrappers (`closest_hit`, `any_hit`,
`closest_super_hit`, `any_super_hit`, `fused_closest_hit`, `fused_any_hit`,
`fused_closest_super_hit`, `fused_any_super_hit`) launch the kernel for CUDA tensors and
run the plain version for CPU tensors. The walk's early exit and the box
tests are culls that never change the result, so the plain versions have
neither; `refine_children` (and `refine_clusters` for the flat table) states
the box test's arithmetic in plain PyTorch so that tests can show it keeps
every cluster that holds a hit.
"""
from __future__ import annotations

import torch

from mafrixraytracing_torch.accel.clusters import CLUSTER_SIZE, SUPER
from mafrixraytracing_torch.core.v3 import V3
from mafrixraytracing_torch.geometry.intersect import closest_sphere_soa
from mafrixraytracing_torch.ops import cuda
from mafrixraytracing_torch.utils import trace

# 128-ray tiles: the kernels' block, and the unit whose rays share one
# cluster list. The integrator's ray order (tiled_pixel_order, _spp_group)
# is tied to the same constant.
TILE = 128
COMP = 12           # packed components per triangle (pack_tris)
# Scenes with more clusters than this take the two-level path. A module
# variable so that tests can force that path on small scenes.
SUPER_MIN_C = 128
# Cull inside the walk's block (kernels F-I) instead of before the walk. A
# module variable that callers patch; off by default, as in the JAX package.
FUSED_CULL = False
CP = 128            # boxes of the cull kernel and box slots of pack_aabbs' table
AABB_ROWS = 8       # its rows: min xyz, max xyz, live, pad
BOUNDS_ROWS = 7     # rows per supercluster in pack_bounds: min xyz, max xyz, live
# The walks grow each box of their box test by REFINE_REL times the scale of
# the coordinates plus REFINE_ABS and widen its two comparisons by as much
# relative to t (their launchers pass these two numbers; `refine_children`
# uses the same), so that neither rounding at a flat or axis-aligned box
# (entry == exit == limit) nor a grazing ray's inexact plane t can drop a
# cluster whose triangle the dense plain version finds.
REFINE_REL = 4e-6
REFINE_ABS = 1e-6
BIG = 1e30
DET_EPS = 1e-10
_INT_MAX = 2**31 - 1
_REF_PAIRS = 1 << 22  # ray-triangle pairs per chunk of the plain versions


def pack_tris(scene) -> torch.Tensor:
    """(C, 12, 128) packed triangle records: [c, k, j] is component k of
    triangle c * 128 + j, in the plane + barycentric form
      n = e1 x e2, dp = n.v0            (plane: n.p = dp)
      g1 = (e2 x n)/(n.n), c1 = g1.v0   (u(p) = g1.p - c1)
      g2 = (n x e1)/(n.n), c2 = g2.v0   (v(p) = g2.p - c2)
    Mega triangles are zeroed (det == 0, never hit): `_mega_hits` owns them."""
    T = scene.tri_v0.shape[0]
    C = T // CLUSTER_SIZE
    v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
    n = torch.linalg.cross(e1, e2)
    nn = torch.clamp(torch.sum(n * n, dim=1, keepdim=True), min=1e-30)
    g1 = torch.linalg.cross(e2, n) / nn
    g2 = torch.linalg.cross(n, e1) / nn
    comp = torch.cat(
        [n, torch.sum(n * v0, dim=1, keepdim=True),
         g1, torch.sum(g1 * v0, dim=1, keepdim=True),
         g2, torch.sum(g2 * v0, dim=1, keepdim=True)], dim=1)  # (T, 12)
    if scene.num_mega:
        comp = comp.index_fill(0, scene.mega_ids[:scene.num_mega].long(), 0.0)
    return comp.reshape(C, CLUSTER_SIZE, COMP).permute(0, 2, 1).contiguous()


def pack_bounds(scene) -> torch.Tensor:
    """(S, 7, 16) child-cluster AABBs for the two-level kernels: [s, :, j]
    holds [min x, y, z, max x, y, z, live] of cluster s * 16 + j. Children
    past the last cluster and empty clusters carry the +-3e38 sentinels and
    live 0: the kernels never stage them."""
    C = scene.cluster_min.shape[0]
    S = scene.super_min.shape[0]
    cmin, cmax = scene.cluster_min, scene.cluster_max
    pad = S * SUPER - C
    if pad:
        cmin = torch.cat([cmin, cmin.new_full((pad, 3), 3e38)])
        cmax = torch.cat([cmax, cmax.new_full((pad, 3), -3e38)])
    live = (cmin[:, :1] <= cmax[:, :1]).to(torch.float32)
    rows = torch.cat([cmin, cmax, live], dim=1)  # (S * 16, 7)
    return rows.reshape(S, SUPER, BOUNDS_ROWS).permute(0, 2, 1).contiguous()


def pack_aabbs(cmin: torch.Tensor, cmax: torch.Tensor) -> torch.Tensor:
    """(8, CP) component-major box table of the fused kernels: rows [min x,
    y, z, max x, y, z, live, pad] across CP = 128 slots. Empty boxes carry
    the +-3e38 sentinels, whose slabs overflow and would pass the interval
    test: the live row masks them, as in `_cull`. Slots past the last box
    are zero (live 0). More than CP boxes raise `ValueError`."""
    C = cmin.shape[0]
    if C > CP:
        raise ValueError(f"the packed box table takes at most {CP} boxes, got {C}")
    live = (cmin[:, 0] <= cmax[:, 0]).to(torch.float32)
    rows = torch.cat([cmin.t(), cmax.t(), live[None, :],
                      torch.zeros_like(live)[None, :]])  # (8, C)
    return torch.nn.functional.pad(rows, (0, CP - C)).contiguous()


def _unpack_aabbs(aabbs: torch.Tensor, n: int):
    """The first n boxes of a `pack_aabbs` table as (cmin, cmax) of (n, 3),
    with the sentinels of an empty box wherever the live row is 0, so that
    `_cull`'s own live test reads the table's."""
    live = aabbs[6, :n, None] > 0.5
    cmin = torch.where(live, aabbs[0:3, :n].t(), 3e38)
    cmax = torch.where(live, aabbs[3:6, :n].t(), -3e38)
    return cmin, cmax


def _safe_inverse(da):
    """IEEE 1 / d with |d| floored at 1e-12 (the cull's and the child
    refinement's reciprocal)."""
    return 1.0 / torch.where(da.abs() > 1e-12, da,
                             torch.where(da >= 0, 1e-12, -1e-12))


def _cull(o: V3, d: V3, t_max, cmin, cmax):
    """Per-tile ordered cluster lists (B a multiple of TILE). Returns
      lists   (tiles, C) int64 cluster ids, front to back, survivors first
      counts  (tiles,)   int64 number of survivors
      entries (tiles, C) f32 tile-min entry distance per sorted slot
      far     (B,)       f32 exit of the ray's last surviving cluster
    Empty (padded) clusters have min > max; their +-3e38 slabs overflow to
    +-inf and would pass the interval test, so a `live` mask drops them."""
    B, C = o.x.shape[0], cmin.shape[0]
    tn = torch.full((B, C), -BIG, dtype=torch.float32, device=o.x.device)
    tf = torch.full((B, C), BIG, dtype=torch.float32, device=o.x.device)
    for oa, da, a in ((o.x, d.x, 0), (o.y, d.y, 1), (o.z, d.z, 2)):
        inv = _safe_inverse(da)
        t0 = (cmin[None, :, a] - oa[:, None]) * inv[:, None]
        t1 = (cmax[None, :, a] - oa[:, None]) * inv[:, None]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    live = (cmin[:, 0] <= cmax[:, 0])[None, :]
    hit = live & (tn <= tf) & (tf > 0.0) & (tn < t_max[:, None])
    entry = torch.where(hit, torch.clamp(tn, min=0.0), BIG)
    far = torch.where(hit, tf, -BIG).amax(dim=1)
    far = torch.minimum(far, t_max)
    tile_entry = entry.reshape(B // TILE, TILE, C).amin(dim=1)
    # stable: equal entries keep ascending cluster id, as the bitonic
    # network's (key, id) order does
    entries, lists = torch.sort(tile_entry, dim=1, stable=True)
    counts = (tile_entry < BIG).sum(dim=1)
    return lists, counts, entries, far


def cull_reference(cmin, cmax, rays, far=None):
    """Plain version of kernel K: `_cull` on the n boxes (cmin, cmax), (n, 3)
    each, for rays (8, B) = [o, d, tmax, unused], B a multiple of TILE.
    Returns
      lists   (tiles, n) int32 box ids, front to back, survivors first
      counts  (tiles,)   int32 number of survivors
      entries (tiles, n) f32 tile-min entry distance per sorted slot
      far     (B,)       f32 exit of the ray's last surviving box, capped at
                         tmax; written into `far` when it is given (the
                         rays' row 7, for the list walks)
    The columns from `counts` on hold the boxes no ray of the tile can meet,
    by ascending id, with entry BIG; the walks never read them."""
    o, d = V3(rays[0], rays[1], rays[2]), V3(rays[3], rays[4], rays[5])
    lists, counts, entries, f = _cull(o, d, rays[6], cmin, cmax)
    if far is not None:
        far.copy_(f)
        f = far
    return lists.to(torch.int32), counts.to(torch.int32), entries.contiguous(), f


def cull_kernel(cmin, cmax, rays, far=None):
    """Launch kernel K (csrc/cull.cu). Same contract as `cull_reference`, to
    which it is bit-equal, for 1 to CP boxes: rows of n columns, the stride
    kernels A, B, D and E take. It reads the boxes as they are, (n, 3)
    minima and maxima, so no table is packed for it."""
    B, n = rays.shape[1], cmin.shape[0]
    if not 1 <= n <= CP:
        raise ValueError(f"the cull kernel takes 1 to {CP} boxes, got {n}")
    if B % TILE:
        raise ValueError(f"ray batch {B} is not a multiple of {TILE}")
    cuda.require(cmin, "cmin", torch.float32, (n, 3))
    cuda.require(cmax, "cmax", torch.float32, (n, 3))
    cuda.require(rays, "rays", torch.float32, (8, B))
    tiles = B // TILE
    lists = torch.empty((tiles, n), dtype=torch.int32, device=rays.device)
    entries = torch.empty((tiles, n), dtype=torch.float32, device=rays.device)
    counts = torch.empty((tiles,), dtype=torch.int32, device=rays.device)
    if far is None:
        far = torch.empty((B,), dtype=torch.float32, device=rays.device)
    cuda.require(far, "far", torch.float32, (B,))
    cuda.launch("cull", cmin, cmax, rays, B, n, lists, entries, counts, far)
    return lists, counts, entries, far


def cull_lists(cmin, cmax, rays, far=None):
    """The list walks' cull, chosen by the tensors' device and the box count:
    kernel K for CUDA tensors and at most CP boxes, its plain version (the
    same numbers) for CPU tensors and for more boxes."""
    if rays.is_cuda and cmin.shape[0] <= CP:
        return cull_kernel(cmin, cmax, rays, far)
    return cull_reference(cmin, cmax, rays, far)


def _mega_hits(scene, o: V3, d: V3, t_min: float, t_max):
    """Dense Moller-Trumbore over the live mega triangles -> (t, idx): the
    nearest mega hit in (t_min, t_max) with its global triangle index, or
    (BIG, -1)."""
    B = o.x.shape[0]
    n = scene.num_mega
    dev = o.x.device
    if n == 0:
        return (torch.full((B,), BIG, dtype=torch.float32, device=dev),
                torch.full((B,), -1, dtype=torch.int64, device=dev))
    T = scene.tri_v0.shape[0]
    ids = scene.mega_ids[:n].long()
    live = ids >= 0
    idc = ids.clamp(0, T - 1)
    v0, e1, e2 = scene.tri_v0[idc], scene.tri_e1[idc], scene.tri_e2[idc]
    ox, oy, oz = o.x[:, None], o.y[:, None], o.z[:, None]
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() > DET_EPS
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tx = ox - v0[None, :, 0]
    ty = oy - v0[None, :, 1]
    tz = oz - v0[None, :, 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (live[None] & ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < t_max[:, None]))
    t = torch.where(ok, t, BIG)
    best = t.amin(dim=1)
    idx = torch.where(t <= best[:, None], idc[None, :], _INT_MAX).amin(dim=1)
    return best, torch.where(best < BIG, idx, -1)


# ---------------------------------------------------------------------------
# Plain versions of kernels A, B, D and E
# ---------------------------------------------------------------------------


def _plane_terms(r, comp):
    """The kernel's ray-triangle test, broadcast: r = 6 ray columns (n, 1),
    comp = 12 component rows (1, T). Returns (t, valid) as (n, T)."""
    ox, oy, oz, dx, dy, dz = r
    nx, ny, nz, dp, g1x, g1y, g1z, c1, g2x, g2y, g2z, c2 = comp
    det = dx * nx + dy * ny + dz * nz
    ok = det.abs() > DET_EPS
    t = (dp - (ox * nx + oy * ny + oz * nz)) / torch.where(ok, det, 1.0)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    u = g1x * px + g1y * py + g1z * pz - c1
    v = g2x * px + g2y * py + g2z * pz - c2
    return t, ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)


def _listed_chunks(tri, lists, counts, rays, group: int = 1):
    """Yield (start, end, ray columns, per-ray mask of listed triangles,
    t, geometric validity) over chunks of rays, for the plain versions. A
    list entry e stands for the clusters e * group .. e * group + group - 1
    (group = 1: clusters; group = SUPER: superclusters)."""
    C = tri.shape[0]
    T = C * CLUSTER_SIZE
    B = rays.shape[1]
    N = lists.shape[1]
    comp = tri.permute(1, 0, 2).reshape(COMP, 1, T).unbind(0)
    slot = torch.arange(N, device=tri.device)[None, :] < counts[:, None]
    member = torch.zeros((lists.shape[0], N + 1), dtype=torch.bool,
                         device=tri.device)
    member.scatter_(1, torch.where(slot, lists.long(), N), True)
    member = member[:, :N].repeat_interleave(group, dim=1)[:, :C]
    step = max(TILE, (_REF_PAIRS // T) // TILE * TILE)
    for s in range(0, B, step):
        e = min(B, s + step)
        r = tuple(rays[k, s:e, None] for k in range(8))
        tiles = torch.arange(s, e, device=tri.device) // TILE
        listed = member[tiles].repeat_interleave(CLUSTER_SIZE, dim=1)
        t, ok = _plane_terms(r[:6], comp)
        yield s, e, r, listed, t, ok


def _dense_closest(tri, lists, counts, rays, t_min: float, group: int):
    """The hit with the smallest t in (t_min, tmax) over the triangles of the
    ray's tile's listed clusters (group 1) or superclusters (group SUPER),
    smallest index on ties -> (t (B,) f32 = tmax on a miss, idx (B,) int32,
    -1 on a miss)."""
    B = rays.shape[1]
    T = tri.shape[0] * CLUSTER_SIZE
    t_out = torch.empty((B,), dtype=torch.float32, device=rays.device)
    i_out = torch.empty((B,), dtype=torch.int32, device=rays.device)
    ids = torch.arange(T, dtype=torch.int32, device=rays.device)[None, :]
    for s, e, r, listed, t, ok in _listed_chunks(tri, lists, counts, rays,
                                                 group):
        tmax = r[6]
        valid = ok & listed & (t > t_min) & (t < tmax)
        tt = torch.where(valid, t, torch.inf)
        best = tt.amin(dim=1)
        bi = torch.where(valid & (tt == best[:, None]), ids, _INT_MAX).amin(dim=1)
        hit = valid.any(dim=1)
        t_out[s:e] = torch.where(hit, best, tmax[:, 0])
        i_out[s:e] = torch.where(hit, bi, -1)
    return t_out, i_out


def _dense_anyhit(tri, lists, counts, rays, t_min: float, group: int):
    """True where any triangle of the ray's tile's listed clusters (group 1)
    or superclusters (group SUPER) is hit in (t_min, tmax)."""
    occ = torch.empty((rays.shape[1],), dtype=torch.bool, device=rays.device)
    for s, e, r, listed, t, ok in _listed_chunks(tri, lists, counts, rays,
                                                 group):
        occ[s:e] = (ok & listed & (t > t_min) & (t < r[6])).any(dim=1)
    return occ


def closest_reference(tri, cmin, cmax, lists, counts, entries, rays, t_min: float):
    """Plain version of kernel A: for each ray, the hit with the smallest t
    in (t_min, tmax) over every triangle of its tile's listed clusters,
    smallest index on ties. Returns (t (B,) f32 = tmax on a miss,
    idx (B,) int32, -1 on a miss). Dense: the kernel's box tests (`cmin`,
    `cmax`) and early exit (`entries`) are culls and are not repeated here."""
    return _dense_closest(tri, lists, counts, rays, t_min, 1)


def anyhit_reference(tri, cmin, cmax, lists, counts, entries, rays, t_min: float):
    """Plain version of kernel B: True where any triangle of the ray's
    tile's listed clusters is hit in (t_min, tmax). Dense, as
    `closest_reference`."""
    return _dense_anyhit(tri, lists, counts, rays, t_min, 1)


def closest_super_reference(tri, bounds, lists, counts, entries, rays,
                            t_min: float):
    """Plain version of kernel D. The contract: the closest hit in
    (t_min, tmax) over all triangles of all children of the superclusters
    listed for the ray's tile, smallest index on ties (across clusters
    too, as kernel A). Dense: the kernel's child refinement (`bounds`) and
    early exit (`entries`) are culls and are not repeated here. Children
    without triangles hold degenerate records that are never hit."""
    return _dense_closest(tri, lists, counts, rays, t_min, SUPER)


def anyhit_super_reference(tri, bounds, lists, counts, entries, rays,
                           t_min: float):
    """Plain version of kernel E: any hit in (t_min, tmax) over the children
    of the ray's tile's listed superclusters."""
    return _dense_anyhit(tri, lists, counts, rays, t_min, SUPER)


def _walk_model(tri, lists, counts, entries, rays, t_min: float,
                early_exit: bool):
    """The instrumented kernels' walk (kernel A's), step by step: at step k
    every tile that is still walking tests its k-th listed cluster against
    its 128 rays and keeps, per ray, the smallest (t, index) pair (A's box
    tests only skip pairs that hold no closer hit, so they are not repeated).
    With `early_exit` and t_min >= 0 a tile stops at the first k whose entry
    lies beyond the max over its rays of min(best t, far) (a ray with a NaN
    there does not count, as in the kernel's `fmaxf`), else at its count:
    the cull's entries and far bound only the hits ahead of the origin, so
    at t_min < 0 (or NaN) there is no exit, as in A. Returns (t, idx,
    walked): A's outputs and, per tile, the number of listed clusters the
    walk reached."""
    B = rays.shape[1]
    tiles = B // TILE
    dev = rays.device
    r = rays.reshape(8, tiles, TILE)
    tmax, far = r[6], r[7]
    best_t = tmax.clone()
    best_i = torch.full((tiles, TILE), -1, dtype=torch.int32, device=dev)
    walked = torch.zeros((tiles,), dtype=torch.int32, device=dev)
    active = torch.ones((tiles,), dtype=torch.bool, device=dev)
    lane = torch.arange(CLUSTER_SIZE, dtype=torch.int32, device=dev)
    chunk = max(1, _REF_PAIRS // (TILE * CLUSTER_SIZE))
    for k in range(int(counts.max()) if tiles else 0):
        active = active & (k < counts)
        if early_exit and t_min >= 0.0:
            limit = torch.fmin(best_t, far)
            worst = torch.where(limit.isnan(), -torch.inf, limit).amax(dim=1)
            active = active & (entries[:, k] <= worst)
        ids = active.nonzero()[:, 0]
        if ids.numel() == 0:
            break
        walked[ids] += 1
        for s in range(0, ids.numel(), chunk):
            sel = ids[s:s + chunk]
            c = lists[sel, k].long()
            comp = tri[c]                                  # (n, 12, 128)
            t, ok = _plane_terms(
                tuple(r[j][sel][:, :, None] for j in range(6)),
                tuple(comp[:, j, None, :] for j in range(COMP)))
            bt, bi = best_t[sel][:, :, None], best_i[sel][:, :, None]
            gid = (c[:, None, None] * CLUSTER_SIZE).to(torch.int32) + lane
            better = ok & (t > t_min) & ((t < bt) | ((t == bt) & (gid < bi)))
            tt = torch.where(better, t, torch.inf)
            m = tt.amin(dim=2)
            mi = torch.where(better & (tt == m[:, :, None]), gid, _INT_MAX).amin(dim=2)
            upd = better.any(dim=2)
            best_t[sel] = torch.where(upd, m, bt[:, :, 0])
            best_i[sel] = torch.where(upd, mi, bi[:, :, 0])
    hit = best_t < tmax
    return (best_t.reshape(B), torch.where(hit, best_i, -1).reshape(B), walked)


def closest_dbg_reference(tri, cmin, cmax, lists, counts, entries, rays,
                          t_min: float):
    """Plain version of `closest_dbg_kernel`, on kernel A's operands (the
    boxes are A's culls and are not repeated): A's (t, idx) and, per tile,
    `walked` (tiles,) int32: how many of its listed clusters the walk reached
    before its early exit. The exit is tested before every cluster, so the
    number is exact and at most `counts` (the TPU kernel tests every four
    clusters, so its number is a multiple of four capped at the count). At
    t_min < 0 (or NaN) there is no exit, as in A, and `walked` is `counts`."""
    return _walk_model(tri, lists, counts, entries, rays, t_min, True)


def closest_full_reference(tri, cmin, cmax, lists, counts, entries, rays,
                           t_min: float):
    """Plain version of `closest_full_kernel`: kernel A's (t, idx) from a walk
    that reaches every listed cluster (A's walk with its exit off)."""
    return _walk_model(tri, lists, counts, entries, rays, t_min, False)[:2]


def _box_floor(t_min: float) -> float:
    """The lower end of the box test's range: a hit needs t > t_min, so a box
    the ray has left by t = 0 can hold one only when t_min < 0, and then no
    box is ruled out from behind (`box_floor` in csrc/intersect_common.cuh)."""
    return 0.0 if t_min >= 0.0 else -BIG


def refine_children(bounds, rays, limit, t_min: float = 0.0) -> torch.Tensor:
    """The box test of the walks (`box_meets` in csrc/intersect_common.cuh,
    the child refinement of kernels D and E) in plain PyTorch: (B, S, W)
    bool, True where ray b can meet box j of group s (bounds (S, 7, W):
    min xyz, max xyz, live) within `limit` (B,). One slab test per box with
    the cull's IEEE reciprocal against the box grown on every side by
    REFINE_REL * (the largest |coordinate| of the ray's origin + that of the
    box) + REFINE_ABS, which keeps the hits that the plane test reports for
    rays grazing a triangle's plane; then entry <= exit, exit >
    `_box_floor(t_min)` and entry <= limit, the two inclusive comparisons
    widened by REFINE_REL * |x| + REFINE_ABS. Used by tests (it must keep
    every box that holds a hit) and to count the work a walk needs; the
    render path does not call it."""
    omag = torch.fmax(torch.fmax(rays[0].abs(), rays[1].abs()), rays[2].abs())
    # max |coordinate| of a box (lo <= hi): max over its axes of max(-lo, hi)
    bmag = torch.maximum(-bounds[:, 0:3], bounds[:, 3:6]).amax(dim=1)
    m = (REFINE_REL * (omag[:, None, None] + bmag[None]) + REFINE_ABS)
    tn = tf = None
    for a in range(3):
        oa = rays[a][:, None, None]
        inv = _safe_inverse(rays[3 + a])[:, None, None]
        t0 = ((bounds[None, :, a, :] - m) - oa) * inv
        t1 = ((bounds[None, :, 3 + a, :] + m) - oa) * inv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    tn = tn.clamp(min=-BIG)
    tf = tf.clamp(max=BIG)
    lim = limit[:, None, None]
    return ((bounds[None, :, 6, :] > 0.5)
            & (tn <= tf + (REFINE_REL * tf.abs() + REFINE_ABS))
            & (tf > _box_floor(t_min))
            & (tn <= lim + (REFINE_REL * lim.abs() + REFINE_ABS)))


def refine_clusters(cmin, cmax, rays, limit, t_min: float = 0.0) -> torch.Tensor:
    """The flat walks' box test in plain PyTorch: (B, C) bool, True where
    ray b can meet cluster c (boxes `cmin`, `cmax` (C, 3), live where min x
    <= max x, as `stage_boxes` stages them) within `limit` (B,); the
    arithmetic of `refine_children`."""
    live = (cmin[:, 0] <= cmax[:, 0]).to(torch.float32)
    bounds = torch.cat([cmin.t(), cmax.t(), live[None]])[None]   # (1, 7, C)
    return refine_children(bounds, rays, limit, t_min)[:, 0]


# ---------------------------------------------------------------------------
# Kernels A, B, D and E
# ---------------------------------------------------------------------------


def _check_walk_args(tri, cmin, cmax, lists, counts, entries, rays):
    C = tri.shape[0]
    B = rays.shape[1]
    if B % TILE:
        raise ValueError(f"ray batch {B} is not a multiple of {TILE}")
    if C > CP:
        raise ValueError(f"the flat walks take at most {CP} clusters, got {C}")
    if tri.data_ptr() % 16:
        raise ValueError("tri must be 16-byte aligned")
    cuda.require(tri, "tri", torch.float32, (C, COMP, CLUSTER_SIZE))
    cuda.require(cmin, "cmin", torch.float32, (C, 3))
    cuda.require(cmax, "cmax", torch.float32, (C, 3))
    cuda.require(lists, "lists", torch.int32, (B // TILE, C))
    cuda.require(counts, "counts", torch.int32, (B // TILE,))
    cuda.require(entries, "entries", torch.float32, (B // TILE, C))
    cuda.require(rays, "rays", torch.float32, (8, B))


def closest_kernel(tri, cmin, cmax, lists, counts, entries, rays, t_min: float):
    """Launch kernel A (csrc/intersect.cu). Same contract as
    `closest_reference`; int32 lists/counts, the (C, 3) cluster boxes of
    the scene; any t_min."""
    _check_walk_args(tri, cmin, cmax, lists, counts, entries, rays)
    B, C = rays.shape[1], tri.shape[0]
    t_out = torch.empty((B,), dtype=torch.float32, device=rays.device)
    i_out = torch.empty((B,), dtype=torch.int32, device=rays.device)
    cuda.launch("closest", tri, cmin, cmax, lists, counts, entries, rays, B, C, float(t_min),
                REFINE_REL, REFINE_ABS, t_out, i_out)
    return t_out, i_out


def anyhit_kernel(tri, cmin, cmax, lists, counts, entries, rays, t_min: float):
    """Launch kernel B (csrc/intersect.cu). Same contract as
    `anyhit_reference`; operands as `closest_kernel`'s."""
    _check_walk_args(tri, cmin, cmax, lists, counts, entries, rays)
    B, C = rays.shape[1], tri.shape[0]
    occ = torch.empty((B,), dtype=torch.uint8, device=rays.device)
    cuda.launch("anyhit", tri, cmin, cmax, lists, counts, entries, rays, B, C, float(t_min),
                REFINE_REL, REFINE_ABS, occ)
    return occ.bool()


def closest_dbg_kernel(tri, cmin, cmax, lists, counts, entries, rays, t_min: float):
    """Launch the counting walk (csrc/intersect_stats.cu: kernel A's walk with
    a counter) on kernel A's operands. Same contract as
    `closest_dbg_reference`: A's (t, idx) plus walked (tiles,) int32."""
    _check_walk_args(tri, cmin, cmax, lists, counts, entries, rays)
    B, C = rays.shape[1], tri.shape[0]
    t_out = torch.empty((B,), dtype=torch.float32, device=rays.device)
    i_out = torch.empty((B,), dtype=torch.int32, device=rays.device)
    walked = torch.empty((B // TILE,), dtype=torch.int32, device=rays.device)
    cuda.launch("closest_dbg", tri, cmin, cmax, lists, counts, entries, rays, B, C,
                float(t_min), REFINE_REL, REFINE_ABS, t_out, i_out, walked)
    return t_out, i_out, walked


def closest_full_kernel(tri, cmin, cmax, lists, counts, entries, rays, t_min: float):
    """Launch the walk without early exit (csrc/intersect_stats.cu: kernel
    A's walk with its exit off) on kernel A's operands. Same contract as
    `closest_full_reference`."""
    _check_walk_args(tri, cmin, cmax, lists, counts, entries, rays)
    B, C = rays.shape[1], tri.shape[0]
    t_out = torch.empty((B,), dtype=torch.float32, device=rays.device)
    i_out = torch.empty((B,), dtype=torch.int32, device=rays.device)
    cuda.launch("closest_full", tri, cmin, cmax, lists, counts, entries, rays, B, C,
                float(t_min), REFINE_REL, REFINE_ABS, t_out, i_out)
    return t_out, i_out


def _check_super_args(tri, bounds, lists, counts, entries, rays):
    C, S = tri.shape[0], bounds.shape[0]
    B = rays.shape[1]
    if B % TILE:
        raise ValueError(f"ray batch {B} is not a multiple of {TILE}")
    if tri.data_ptr() % 16:
        raise ValueError("tri must be 16-byte aligned")
    if S * SUPER < C:
        raise ValueError(f"{S} superclusters do not cover {C} clusters")
    cuda.require(tri, "tri", torch.float32, (C, COMP, CLUSTER_SIZE))
    cuda.require(bounds, "bounds", torch.float32, (S, BOUNDS_ROWS, SUPER))
    cuda.require(lists, "lists", torch.int32, (B // TILE, S))
    cuda.require(counts, "counts", torch.int32, (B // TILE,))
    cuda.require(entries, "entries", torch.float32, (B // TILE, S))
    cuda.require(rays, "rays", torch.float32, (8, B))


def closest_super_kernel(tri, bounds, lists, counts, entries, rays,
                         t_min: float):
    """Launch kernel D (csrc/intersect_super.cu). Same contract as
    `closest_super_reference`; int32 lists/counts of supercluster ids."""
    _check_super_args(tri, bounds, lists, counts, entries, rays)
    B, C, S = rays.shape[1], tri.shape[0], bounds.shape[0]
    t_out = torch.empty((B,), dtype=torch.float32, device=rays.device)
    i_out = torch.empty((B,), dtype=torch.int32, device=rays.device)
    cuda.launch("closest_super", tri, bounds, lists, counts, entries, rays, B, C, S,
                float(t_min), REFINE_REL, REFINE_ABS, t_out, i_out)
    return t_out, i_out


def anyhit_super_kernel(tri, bounds, lists, counts, entries, rays,
                        t_min: float):
    """Launch kernel E (csrc/intersect_super.cu). Same contract as
    `anyhit_super_reference`; int32 lists/counts of supercluster ids."""
    _check_super_args(tri, bounds, lists, counts, entries, rays)
    B, C, S = rays.shape[1], tri.shape[0], bounds.shape[0]
    occ = torch.empty((B,), dtype=torch.uint8, device=rays.device)
    cuda.launch("anyhit_super", tri, bounds, lists, counts, entries, rays, B, C, S,
                float(t_min), REFINE_REL, REFINE_ABS, occ)
    return occ.bool()


# ---------------------------------------------------------------------------
# Kernels F, G, H and I: the cull inside the walk
# ---------------------------------------------------------------------------


def _fused_walk(tri, aabbs, rays, n_box: int):
    """`_cull` on the first n_box boxes of the packed table -> the list
    walk's (lists, counts, entries, rays with `far` in row 7)."""
    lists, counts, entries, far = cull_reference(*_unpack_aabbs(aabbs, n_box), rays)
    return lists, counts, entries, torch.cat([rays[:7], far[None]])


def fused_closest_reference(tri, aabbs, rays, t_min: float):
    """Plain version of kernel F: `_cull` on the packed boxes, then
    `closest_reference`. rays (8, B) = [o, d, tmax, unused]."""
    n = tri.shape[0]
    return closest_reference(tri, *_unpack_aabbs(aabbs, n),
                             *_fused_walk(tri, aabbs, rays, n), t_min)


def fused_anyhit_reference(tri, aabbs, rays, t_min: float):
    """Plain version of kernel G: `_cull`, then `anyhit_reference`."""
    n = tri.shape[0]
    return anyhit_reference(tri, *_unpack_aabbs(aabbs, n),
                            *_fused_walk(tri, aabbs, rays, n), t_min)


def fused_closest_super_reference(tri, bounds, aabbs, rays, t_min: float):
    """Plain version of kernel H: `_cull` on the packed supercluster boxes,
    then `closest_super_reference`."""
    return closest_super_reference(
        tri, bounds, *_fused_walk(tri, aabbs, rays, bounds.shape[0]), t_min)


def fused_anyhit_super_reference(tri, bounds, aabbs, rays, t_min: float):
    """Plain version of kernel I: `_cull`, then `anyhit_super_reference`."""
    return anyhit_super_reference(
        tri, bounds, *_fused_walk(tri, aabbs, rays, bounds.shape[0]), t_min)


def _check_fused_args(tri, aabbs, rays, bounds=None):
    """Validate the fused kernels' operands -> the number of boxes."""
    C = tri.shape[0]
    B = rays.shape[1]
    n_box = C if bounds is None else bounds.shape[0]
    if n_box > CP:
        raise ValueError(f"the fused cull takes at most {CP} boxes, got {n_box}")
    if B % TILE:
        raise ValueError(f"ray batch {B} is not a multiple of {TILE}")
    if tri.data_ptr() % 16:
        raise ValueError("tri must be 16-byte aligned")
    cuda.require(tri, "tri", torch.float32, (C, COMP, CLUSTER_SIZE))
    cuda.require(aabbs, "aabbs", torch.float32, (AABB_ROWS, CP))
    cuda.require(rays, "rays", torch.float32, (8, B))
    if bounds is not None:
        if n_box * SUPER < C:
            raise ValueError(f"{n_box} superclusters do not cover {C} clusters")
        cuda.require(bounds, "bounds", torch.float32, (n_box, BOUNDS_ROWS, SUPER))
    return n_box


def fused_closest_kernel(tri, aabbs, rays, t_min: float):
    """Launch kernel F (csrc/intersect_fused.cu). Same contract as
    `fused_closest_reference`."""
    n_box = _check_fused_args(tri, aabbs, rays)
    B = rays.shape[1]
    t_out = torch.empty((B,), dtype=torch.float32, device=rays.device)
    i_out = torch.empty((B,), dtype=torch.int32, device=rays.device)
    cuda.launch("fused_closest", tri, aabbs, rays, B, n_box, float(t_min), REFINE_REL,
                REFINE_ABS, t_out, i_out)
    return t_out, i_out


def fused_anyhit_kernel(tri, aabbs, rays, t_min: float):
    """Launch kernel G (csrc/intersect_fused.cu). Same contract as
    `fused_anyhit_reference`."""
    n_box = _check_fused_args(tri, aabbs, rays)
    B = rays.shape[1]
    occ = torch.empty((B,), dtype=torch.uint8, device=rays.device)
    cuda.launch("fused_anyhit", tri, aabbs, rays, B, n_box, float(t_min), REFINE_REL,
                REFINE_ABS, occ)
    return occ.bool()


def fused_closest_super_kernel(tri, bounds, aabbs, rays, t_min: float):
    """Launch kernel H (csrc/intersect_fused.cu). Same contract as
    `fused_closest_super_reference`."""
    n_box = _check_fused_args(tri, aabbs, rays, bounds)
    B, C = rays.shape[1], tri.shape[0]
    t_out = torch.empty((B,), dtype=torch.float32, device=rays.device)
    i_out = torch.empty((B,), dtype=torch.int32, device=rays.device)
    cuda.launch("fused_closest_super", tri, bounds, aabbs, rays, B, C, n_box,
                float(t_min), REFINE_REL, REFINE_ABS, t_out, i_out)
    return t_out, i_out


def fused_anyhit_super_kernel(tri, bounds, aabbs, rays, t_min: float):
    """Launch kernel I (csrc/intersect_fused.cu). Same contract as
    `fused_anyhit_super_reference`."""
    n_box = _check_fused_args(tri, aabbs, rays, bounds)
    B, C = rays.shape[1], tri.shape[0]
    occ = torch.empty((B,), dtype=torch.uint8, device=rays.device)
    cuda.launch("fused_anyhit_super", tri, bounds, aabbs, rays, B, C, n_box,
                float(t_min), REFINE_REL, REFINE_ABS, occ)
    return occ.bool()


# ---------------------------------------------------------------------------
# Dispatch on the tensors' device
# ---------------------------------------------------------------------------


def closest_hit(tri, cmin, cmax, lists, counts, entries, rays, t_min: float):
    """Kernel A for CUDA tensors, its plain version for CPU tensors."""
    if rays.is_cuda:
        return closest_kernel(tri, cmin, cmax, lists, counts, entries, rays, t_min)
    return closest_reference(tri, cmin, cmax, lists, counts, entries, rays, t_min)


def any_hit(tri, cmin, cmax, lists, counts, entries, rays, t_min: float):
    """Kernel B for CUDA tensors, its plain version for CPU tensors."""
    if rays.is_cuda:
        return anyhit_kernel(tri, cmin, cmax, lists, counts, entries, rays, t_min)
    return anyhit_reference(tri, cmin, cmax, lists, counts, entries, rays, t_min)


def closest_dbg_hit(tri, cmin, cmax, lists, counts, entries, rays, t_min: float):
    """The counting walk's kernel for CUDA tensors, its plain version for CPU
    tensors."""
    if rays.is_cuda:
        return closest_dbg_kernel(tri, cmin, cmax, lists, counts, entries, rays, t_min)
    return closest_dbg_reference(tri, cmin, cmax, lists, counts, entries, rays, t_min)


def closest_full_hit(tri, cmin, cmax, lists, counts, entries, rays, t_min: float):
    """The full walk's kernel for CUDA tensors, its plain version for CPU
    tensors."""
    if rays.is_cuda:
        return closest_full_kernel(tri, cmin, cmax, lists, counts, entries, rays, t_min)
    return closest_full_reference(tri, cmin, cmax, lists, counts, entries, rays, t_min)


def closest_super_hit(tri, bounds, lists, counts, entries, rays, t_min: float):
    """Kernel D for CUDA tensors, its plain version for CPU tensors."""
    if rays.is_cuda:
        return closest_super_kernel(tri, bounds, lists, counts, entries, rays,
                                    t_min)
    return closest_super_reference(tri, bounds, lists, counts, entries, rays,
                                   t_min)


def any_super_hit(tri, bounds, lists, counts, entries, rays, t_min: float):
    """Kernel E for CUDA tensors, its plain version for CPU tensors."""
    if rays.is_cuda:
        return anyhit_super_kernel(tri, bounds, lists, counts, entries, rays,
                                   t_min)
    return anyhit_super_reference(tri, bounds, lists, counts, entries, rays,
                                  t_min)


def fused_closest_hit(tri, aabbs, rays, t_min: float):
    """Kernel F for CUDA tensors, its plain version for CPU tensors."""
    if rays.is_cuda:
        return fused_closest_kernel(tri, aabbs, rays, t_min)
    return fused_closest_reference(tri, aabbs, rays, t_min)


def fused_any_hit(tri, aabbs, rays, t_min: float):
    """Kernel G for CUDA tensors, its plain version for CPU tensors."""
    if rays.is_cuda:
        return fused_anyhit_kernel(tri, aabbs, rays, t_min)
    return fused_anyhit_reference(tri, aabbs, rays, t_min)


def fused_closest_super_hit(tri, bounds, aabbs, rays, t_min: float):
    """Kernel H for CUDA tensors, its plain version for CPU tensors."""
    if rays.is_cuda:
        return fused_closest_super_kernel(tri, bounds, aabbs, rays, t_min)
    return fused_closest_super_reference(tri, bounds, aabbs, rays, t_min)


def fused_any_super_hit(tri, bounds, aabbs, rays, t_min: float):
    """Kernel I for CUDA tensors, its plain version for CPU tensors."""
    if rays.is_cuda:
        return fused_anyhit_super_kernel(tri, bounds, aabbs, rays, t_min)
    return fused_anyhit_super_reference(tri, bounds, aabbs, rays, t_min)


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------


def _prep(scene, o: V3, d: V3, t_min: float, t_max, anyhit: bool,
          fused: bool = False):
    """Detach, pad to a TILE multiple (dead padding rays), run the dense
    mega test (capping t_max so the cull prunes everything behind the first
    mega hit), cull and pack. Returns the walk's operands plus what the
    caller merges. With more than SUPER_MIN_C clusters the cull runs on the
    superclusters and the walk's operands are those of kernels D and E
    (`pack_bounds` second); else those of kernels A and B (the cluster boxes
    `cluster_min` and `cluster_max` second and third). The cull is
    `cull_lists`'s: kernel K on CUDA tensors and at most CP boxes, `_cull`
    otherwise; it writes `far` into the rays' row 7. With `fused` there is no
    cull here: the operands are those of kernels F and G, or H and I (the
    packed box table in place of lists, counts and entries; the rays' `far`
    row is zero and unread)."""
    use_super = scene.cluster_min.shape[0] > SUPER_MIN_C
    o = o.map(torch.Tensor.detach)
    d = d.map(torch.Tensor.detach)
    B = o.x.shape[0]
    dev = o.x.device
    t_max_arr = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(B)
    Bp = -(-B // TILE) * TILE
    pad = Bp - B
    if pad:
        zpad = torch.zeros((pad,), dtype=torch.float32, device=dev)
        o = o.map(lambda c: torch.cat([c, zpad]))
        d = V3(torch.cat([d.x, zpad]), torch.cat([d.y, zpad]),
               torch.cat([d.z, torch.ones_like(zpad)]))
        t_max_p = torch.cat([t_max_arr, zpad])
    else:
        t_max_p = t_max_arr.contiguous()
    mega_t, mega_idx = _mega_hits(scene, o, d, t_min, t_max_p)
    if anyhit:
        # a mega hit already occludes: zero t_max skips every cluster
        t_max_k = torch.where(mega_idx >= 0, 0.0, t_max_p)
    else:
        t_max_k = torch.minimum(t_max_p, mega_t)
    if use_super:
        boxes = (scene.super_min, scene.super_max)
        packed = (pack_tris(scene), pack_bounds(scene))
        head = packed      # the list walks' operands before the lists
    else:
        boxes = (scene.cluster_min, scene.cluster_max)
        packed = (pack_tris(scene),)
        head = (*packed, *boxes)
    rows = [o.x, o.y, o.z, d.x, d.y, d.z, t_max_k]
    if fused:
        rays = torch.stack([*rows, torch.zeros_like(t_max_k)])
        walk = (*packed, pack_aabbs(*boxes), rays)
    else:
        # row 7, far, is the cull's to write
        rays = torch.empty((8, Bp), dtype=torch.float32, device=dev)
        torch.stack(rows, out=rays[:7])
        lists, counts, entries, _ = cull_lists(*boxes, rays, far=rays[7])
        walk = (*head, lists, counts, entries, rays)
    return walk, B, t_max_arr, mega_t[:B], mega_idx[:B]


def _is_super(walk) -> bool:
    """Whether `_prep` made the two-level walk's operands, read from the
    second operand's shape: the child bounds (S, 7, 16) of (tri, bounds,
    lists, counts, entries, rays) or, fused, (tri, bounds, aabbs, rays); the
    flat walks' second operand is two-dimensional, the cluster boxes' minima
    (C, 3) of (tri, cmin, cmax, lists, counts, entries, rays) or, fused, the
    (8, CP) box table of (tri, aabbs, rays)."""
    return walk[1].dim() == 3


def _is_fused(walk) -> bool:
    """Whether `_prep` made the fused kernels' operands: they hold no lists,
    counts and entries, so three or four operands where the list walks have
    six or seven."""
    return len(walk) < 6


def _searches(walk):
    """(closest-hit, any-hit) dispatchers for the operands `_prep` made."""
    if _is_fused(walk):
        if _is_super(walk):
            return fused_closest_super_hit, fused_any_super_hit
        return fused_closest_hit, fused_any_hit
    if _is_super(walk):
        return closest_super_hit, any_super_hit
    return closest_hit, any_hit


def _count_lanes(o: V3) -> None:
    """Add the query's lanes, padded to the ray tile as `_prep` pads them,
    to the `search_lanes` counter."""
    trace.count("search_lanes", -(-o.x.shape[0] // TILE) * TILE)


@trace.spanned("search")
@torch.no_grad()
def find_closest_soa(scene, o: V3, d: V3, t_min: float, t_max, times=None):
    """Closest hit per ray: clustered triangles through kernel A (kernel D
    on the two-level path; F or H with `FUSED_CULL`), mega triangles and
    spheres merged densely. `times` (B,) shifts the spheres by their
    velocities (motion blur; the clustered triangles are static).
    Returns (t (B,) f32, BIG on a miss; idx (B,) int64: triangle [0, T),
    sphere T + s, -1 on a miss). Not differentiable by design."""
    _count_lanes(o)
    walk, B, t_max_arr, mega_t, mega_idx = _prep(scene, o, d, t_min, t_max,
                                                 anyhit=False, fused=FUSED_CULL)
    tt, ti = _searches(walk)[0](*walk, t_min)
    tt, ti = tt[:B], ti[:B].long()
    tt = torch.where(ti >= 0, tt, BIG)
    # the walk's t_max was capped at mega_t, so a clustered hit is closer
    use_mega = (mega_idx >= 0) & (mega_t < tt)
    tt = torch.where(use_mega, mega_t, tt)
    ti = torch.where(use_mega, mega_idx, ti)
    if scene.num_live_spheres > 0:
        st, si = closest_sphere_soa(scene, o.map(torch.Tensor.detach),
                                    d.map(torch.Tensor.detach), t_min, t_max_arr,
                                    times=times)
        use_sphere = st < tt
        tt = torch.where(use_sphere, st, tt)
        ti = torch.where(use_sphere, scene.tri_v0.shape[0] + si, ti)
    return tt, torch.where(tt < BIG, ti, -1)


@trace.spanned("search")
@torch.no_grad()
def occluded_soa(scene, o: V3, d: V3, t_min: float, t_max, times=None):
    """Any hit in (t_min, t_max) per ray (shadow queries): clustered
    triangles through kernel B (kernel E on the two-level path; G or I with
    `FUSED_CULL`), mega triangles and spheres densely; `times` as in
    `find_closest_soa`."""
    _count_lanes(o)
    walk, B, t_max_arr, mega_t, mega_idx = _prep(scene, o, d, t_min, t_max,
                                                 anyhit=True, fused=FUSED_CULL)
    occ = _searches(walk)[1](*walk, t_min)[:B] | (mega_idx >= 0)
    if scene.num_live_spheres > 0:
        st, _ = closest_sphere_soa(scene, o.map(torch.Tensor.detach),
                                   d.map(torch.Tensor.detach), t_min, t_max_arr,
                                   times=times)
        occ = occ | (st < BIG)
    return occ
