"""Clustered triangle acceleration (host build).

A copy of the numpy build in `mafrixraytracing_tpu/accel/clusters.py`
(`build_clusters`, `_median_split_order`, `_super_bounds_np`): importing any
module of that package imports JAX, and the port runs where JAX is absent.
The port must lay triangles out exactly as the JAX package does, because
triangle indices are compared between the two.

Build (NumPy): recursively median-split triangle centroids on the widest
axis (the same split rule as the reference's BVH build,
`Core/Accelerate/BvhNode.fs:42-61`) until each leaf holds exactly
`CLUSTER_SIZE` triangles, then lay leaves out consecutively. Each leaf is
one *cluster* with a tight AABB; traversal tests a cluster's AABB, then its
triangles. The device-side consumer is `ops.intersect` (cull + the
closest-hit and any-hit kernels). `refresh_clusters` recomputes the boxes on
the device after an optimization step has moved vertices.
"""
from __future__ import annotations

import numpy as np
import torch

from mafrixraytracing_torch.utils.trace import spanned

# 128 triangles per cluster: the CUDA kernels stage one cluster (12 x 128
# packed components, 6 KB) in shared memory and test it against a 128-ray tile.
CLUSTER_SIZE = 128

# Two-level hierarchy: SUPER consecutive clusters form one supercluster
# (the median-split layout keeps consecutive clusters spatially coherent,
# so parent AABBs stay tight). Large scenes cull rays against the (B, S)
# supercluster slabs instead of the (B, C) cluster slabs — a 16x smaller
# dense pass — and the kernel refines each surviving supercluster against
# its 16 child cluster AABBs (`ops.intersect.pack_bounds`, kernels D and E
# in `csrc/intersect_super.cu`).
SUPER = 16

# "Mega" triangles (ground planes, room walls): any triangle whose AABB
# diagonal exceeds MEGA_FRAC of the scene diagonal would blow up its
# cluster's AABB so badly that every ray tests the whole cluster. They are
# excluded from clustering and handled by a dense test instead (at most
# MAX_MEGA of them), which also yields a per-ray t_max cap *before* the
# cluster cull — everything behind the first mega hit is culled for free.
MEGA_FRAC = 0.35
MAX_MEGA = 32

_EMPTY_MIN = np.float32(3e38)
_EMPTY_MAX = np.float32(-3e38)


def _median_split_order(centroids: np.ndarray, leaf: int) -> np.ndarray:
    """Recursive count-median split on the widest centroid axis: returns a
    permutation laying triangles out so each consecutive run of `leaf` is a
    spatially tight kd-leaf. Iterative worklist, O(T log T) host time."""
    n = centroids.shape[0]
    order = np.arange(n, dtype=np.int64)
    if n <= leaf:
        return order
    stack = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        if hi - lo <= leaf:
            continue
        seg = order[lo:hi]
        c = centroids[seg]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        # split point must be a multiple of `leaf`: the device groups
        # consecutive runs of `leaf` triangles into clusters, so any
        # non-aligned split would make leaves straddle cluster boundaries.
        # Only the global tail run may be partial (it stays rightmost).
        half = (hi - lo) // 2
        mid = max(leaf, (half // leaf) * leaf)
        part = np.argpartition(c[:, axis], mid - 1)
        order[lo:hi] = seg[part]
        stack.append((lo, lo + mid))
        stack.append((lo + mid, hi))
    return order


def build_clusters(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, mask: np.ndarray):
    """Compute the kd-leaf permutation and cluster/supercluster AABBs for a
    padded triangle SoA. Returns a dict:
      perm        (T,)   permutation to apply to every per-tri array
      cluster_min (C,3), cluster_max (C,3)
    Padded (masked-out) triangles sort to the end and produce empty AABBs
    (min > max), which fail every slab test.
    """
    T = v0.shape[0]
    n_valid = int(mask.sum())
    centroids = v0 + (e1 + e2) / 3.0

    # --- split off mega triangles (see MEGA_FRAC above) ---
    p1_all, p2_all = v0 + e1, v0 + e2
    tmin_all = np.minimum(np.minimum(v0, p1_all), p2_all)
    tmax_all = np.maximum(np.maximum(v0, p1_all), p2_all)
    diag = np.linalg.norm(tmax_all[:n_valid] - tmin_all[:n_valid], axis=1) if n_valid else np.zeros(0)
    scene_diag = (
        float(np.linalg.norm(tmax_all[:n_valid].max(0) - tmin_all[:n_valid].min(0)))
        if n_valid
        else 1.0
    )
    is_mega = diag > MEGA_FRAC * max(scene_diag, 1e-12)
    if int(is_mega.sum()) > MAX_MEGA:
        # keep only the MAX_MEGA largest as mega
        order_by_diag = np.argsort(-diag)
        keep = order_by_diag[:MAX_MEGA]
        is_mega = np.zeros(n_valid, bool)
        is_mega[keep] = True
    reg_ids = np.nonzero(~is_mega)[0]
    mega_ids_local = np.nonzero(is_mega)[0]
    n_mega = mega_ids_local.size

    perm_reg = (
        reg_ids[_median_split_order(centroids[reg_ids], CLUSTER_SIZE)]
        if reg_ids.size
        else np.zeros(0, np.int64)
    )
    perm = np.concatenate(
        [perm_reg, mega_ids_local, np.arange(n_valid, T)]
    ).astype(np.int64)

    v0s, e1s, e2s = v0[perm], e1[perm], e2[perm]
    masks = mask[perm]
    # mega triangles live at positions [n_valid - n_mega, n_valid) after the
    # permutation; exclude them from cluster AABBs (the dense test owns them)
    clustered = masks.copy()
    if n_mega:
        clustered[n_valid - n_mega : n_valid] = False

    p0 = v0s
    p1 = v0s + e1s
    p2 = v0s + e2s
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    tri_min = np.where(clustered[:, None], tri_min, _EMPTY_MIN)
    tri_max = np.where(clustered[:, None], tri_max, _EMPTY_MAX)

    C = (T + CLUSTER_SIZE - 1) // CLUSTER_SIZE
    pad = C * CLUSTER_SIZE - T
    if pad:
        tri_min = np.concatenate(
            [tri_min, np.full((pad, 3), _EMPTY_MIN, np.float32)]
        )
        tri_max = np.concatenate(
            [tri_max, np.full((pad, 3), _EMPTY_MAX, np.float32)]
        )
    cluster_min = tri_min.reshape(C, CLUSTER_SIZE, 3).min(axis=1)
    cluster_max = tri_max.reshape(C, CLUSTER_SIZE, 3).max(axis=1)

    mega_ids = np.full((MAX_MEGA,), -1, np.int32)
    if n_mega:
        mega_ids[:n_mega] = np.arange(n_valid - n_mega, n_valid, dtype=np.int32)

    super_min, super_max = _super_bounds_np(cluster_min, cluster_max)

    return {
        "perm": perm,
        "cluster_min": cluster_min.astype(np.float32),
        "cluster_max": cluster_max.astype(np.float32),
        "super_min": super_min,
        "super_max": super_max,
        "mega_ids": mega_ids,
    }


def _super_bounds_np(cluster_min: np.ndarray, cluster_max: np.ndarray):
    """Group SUPER consecutive clusters into supercluster AABBs (host).
    Empty children (min > max) keep the union correct because their
    sentinels are +-3e38; an all-empty supercluster stays min > max."""
    C = cluster_min.shape[0]
    S = (C + SUPER - 1) // SUPER
    pad = S * SUPER - C
    if pad:
        cluster_min = np.concatenate(
            [cluster_min, np.full((pad, 3), _EMPTY_MIN, np.float32)]
        )
        cluster_max = np.concatenate(
            [cluster_max, np.full((pad, 3), _EMPTY_MAX, np.float32)]
        )
    smin = cluster_min.reshape(S, SUPER, 3).min(axis=1).astype(np.float32)
    smax = cluster_max.reshape(S, SUPER, 3).max(axis=1).astype(np.float32)
    return smin, smax


@spanned("refresh")
def refresh_clusters(scene):
    """Recompute cluster and supercluster AABBs on the device from the
    scene's (possibly updated) triangle tensors, as the JAX package's
    `refresh_clusters` (`accel/clusters.py:182-218`): required after a
    vertex-position step so the cull stays conservative. O(T); the
    median-split order stays fixed (a stale order loosens bounds, never
    correctness). The inputs are detached: bounds carry no gradient."""
    v0, e1, e2 = (scene.tri_v0.detach(), scene.tri_e1.detach(),
                  scene.tri_e2.detach())
    T = v0.shape[0]
    # mega triangles are owned by the dense test, not the clusters; the -1
    # pads are dropped (a negative index would wrap around)
    ids = scene.mega_ids.long()
    mega = torch.zeros((T,), dtype=torch.bool, device=v0.device)
    mega[ids[ids >= 0]] = True
    mask = (scene.tri_mask & ~mega)[:, None]
    p1, p2 = v0 + e1, v0 + e2
    tmin = torch.minimum(torch.minimum(v0, p1), p2)
    tmax = torch.maximum(torch.maximum(v0, p1), p2)
    tmin = torch.where(mask, tmin, float(_EMPTY_MIN))
    tmax = torch.where(mask, tmax, float(_EMPTY_MAX))

    C = scene.cluster_min.shape[0]
    cmin = tmin.reshape(C, T // C, 3).amin(dim=1)
    cmax = tmax.reshape(C, T // C, 3).amax(dim=1)
    # supercluster bounds follow their children (padded to SUPER groups)
    S = scene.super_min.shape[0]
    pad = S * SUPER - C
    pmin, pmax = cmin, cmax
    if pad:
        pmin = torch.cat([cmin, cmin.new_full((pad, 3), float(_EMPTY_MIN))])
        pmax = torch.cat([cmax, cmax.new_full((pad, 3), float(_EMPTY_MAX))])
    smin = pmin.reshape(S, SUPER, 3).amin(dim=1)
    smax = pmax.reshape(S, SUPER, 3).amax(dim=1)
    return scene.replace(cluster_min=cmin, cluster_max=cmax,
                         super_min=smin, super_max=smax)
