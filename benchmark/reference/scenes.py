"""The reference's own scene compiler: the benchmark's scene inputs (the
Cornell box's walls, boxes and light; a mesh OBJ file framed over a ground
plane under a light) to padded triangle, material and light tables and a
pinhole camera, in NumPy, then tensors of one dtype.

It covers what the benchmark's configurations hold: lambert and emissive
materials, area lights, pinhole cameras. The tables are padded and ordered
as the measured program lays them out (triangles in buckets of 128 ordered
by a median split of their centroids, the large "mega" triangles after
them), so triangle indices and the smallest-index rule for equal distances
are the same on both sides.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

LAMBERT, EMISSIVE = 0, 3
CLUSTER = 128
MEGA_FRAC = 0.35
MAX_MEGA = 32


def bucket_size(n: int, multiple: int) -> int:
    """Round up to `multiple`, then to a power-of-two count of multiples."""
    units = ((max(n, 1) + multiple - 1) // multiple * multiple) // multiple
    return (1 << (units - 1).bit_length()) * multiple


def pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    width = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, width, constant_values=fill)


def rect(p0, p1, p2, p3):
    """A quad as the two triangles (p0, p1, p2) and (p0, p2, p3)."""
    return (np.asarray([p0, p1, p2, p3], np.float32),
            np.asarray([[0, 1, 2], [0, 2, 3]], np.int64))


def box(center, half, rotate_y_deg):
    """A box rotated about +y as 12 triangles with outward winding."""
    hx, hy, hz = half
    corners = np.array([[sx * hx, sy * hy, sz * hz] for sx in (-1, 1)
                        for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    a = np.deg2rad(rotate_y_deg)
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]], np.float32)
    corners = corners @ rot.T + np.asarray(center, np.float32)
    quads = [(4, 5, 7, 6), (1, 0, 2, 3), (2, 6, 7, 3), (0, 1, 5, 4),
             (1, 3, 7, 5), (0, 4, 6, 2)]
    faces = [f for q in quads for f in ([q[0], q[1], q[2]], [q[0], q[2], q[3]])]
    return corners, np.asarray(faces, np.int64)


@dataclass
class Inputs:
    """A scene before compilation: shapes (vertices, faces, material),
    materials (type, albedo, emission), area lights (vertices, faces,
    radiance, visible) and a pinhole camera."""
    shapes: list
    materials: list
    lights: list
    camera: dict


def cornell(width: int, height: int, light_radiance=(10.0, 10.0, 10.0)) -> Inputs:
    """The upstream demo's Cornell box (RayTracing4.fs with Scene.xml): box
    x, z in [-1, 1], y in [0, 2]; white floor, ceiling, back wall and boxes,
    green right wall, red left wall, a visible rect light under the ceiling;
    camera at (0, 1, 3) looking down -z with the upstream's fov 120."""
    mats = [(LAMBERT, (0.725, 0.71, 0.68), (0, 0, 0)),
            (LAMBERT, (0.14, 0.45, 0.091), (0, 0, 0)),
            (LAMBERT, (0.63, 0.065, 0.05), (0, 0, 0))]
    shapes = [
        (*rect((-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1)), 0),
        (*rect((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)), 0),
        (*rect((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)), 0),
        (*rect((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)), 1),
        (*rect((-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1)), 2),
        (*box((0.33, 0.3, 0.37), (0.29, 0.3, 0.29), -17.0), 0),
        (*box((-0.33, 0.6, -0.28), (0.29, 0.6, 0.29), 17.0), 0),
    ]
    h, s = 1.98, 0.235
    light = (*rect((-s, h, -s), (s, h, -s), (s, h, s), (-s, h, s)),
             tuple(light_radiance), True)
    cam = dict(position=(0.0, 1.0, 3.0), direction=(0.0, 0.0, -1.0), fov=120.0,
               aspect=width / height, convention="mafrix")
    return Inputs(shapes, mats, [light], cam)


def read_obj(path: str):
    """Vertices and triangles of an OBJ file (v and f lines; a face corner's
    first index; polygons fanned)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                ids = [int(p.split("/")[0]) for p in parts[1:]]
                ids = [i - 1 if i > 0 else len(verts) + i for i in ids]
                faces += [[ids[0], ids[k], ids[k + 1]] for k in range(1, len(ids) - 1)]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def framed_mesh(obj_path: str, width: int, height: int,
                albedo=(0.7, 0.5, 0.4), light_radiance=(12.0, 12.0, 12.0)) -> Inputs:
    """A mesh framed for a hero shot: camera above and in front of its box,
    a ground quad three sizes wide under it, a hidden rect light 1.5 sizes
    above it."""
    v, f = read_obj(obj_path)
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2.0
    size = float(np.max(hi - lo))
    cam_pos = center + np.array([0.0, 0.35 * size, 1.8 * size], np.float32)
    gy, g = float(lo[1]) - 0.02 * size, 3.0 * size
    cx, cz = center[0], center[2]
    ground = rect((cx - g, gy, cz + g), (cx + g, gy, cz + g),
                  (cx + g, gy, cz - g), (cx - g, gy, cz - g))
    ls, lh = 0.8 * size, float(hi[1]) + 1.5 * size
    light = rect((cx - ls, lh, cz - ls), (cx + ls, lh, cz - ls),
                 (cx + ls, lh, cz + ls), (cx - ls, lh, cz + ls))
    mats = [(LAMBERT, tuple(albedo), (0, 0, 0)), (LAMBERT, (0.8, 0.8, 0.8), (0, 0, 0))]
    cam = dict(position=tuple(cam_pos), direction=tuple(center - cam_pos), fov=45.0,
               aspect=width / height, convention="standard")
    return Inputs([(v, f, 0), (*ground, 1)], mats,
                  [(*light, tuple(light_radiance), False)], cam)


def _faces(v, f):
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    gn = np.cross(e1, e2)
    norm = np.linalg.norm(gn, axis=1, keepdims=True)
    return p0, e1, e2, gn / np.maximum(norm, 1e-12), 0.5 * norm[:, 0]


def _median_split(centroids: np.ndarray, leaf: int) -> np.ndarray:
    """Permutation from recursive count-median splits on the widest axis,
    each split at a multiple of `leaf`."""
    n = centroids.shape[0]
    order = np.arange(n, dtype=np.int64)
    stack = [(0, n)] if n > leaf else []
    while stack:
        lo, hi = stack.pop()
        if hi - lo <= leaf:
            continue
        seg = order[lo:hi]
        c = centroids[seg]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = max(leaf, ((hi - lo) // 2 // leaf) * leaf)
        order[lo:hi] = seg[np.argpartition(c[:, axis], mid - 1)]
        stack.append((lo, lo + mid))
        stack.append((lo + mid, hi))
    return order


def triangle_order(v0, e1, e2, n_valid: int):
    """The layout: regular triangles by median split, then the mega
    triangles (box diagonal over MEGA_FRAC of the scene's), then padding.
    Returns (permutation, number of mega triangles)."""
    T = v0.shape[0]
    p1, p2 = v0 + e1, v0 + e2
    tmin = np.minimum(np.minimum(v0, p1), p2)[:n_valid]
    tmax = np.maximum(np.maximum(v0, p1), p2)[:n_valid]
    diag = np.linalg.norm(tmax - tmin, axis=1)
    scene_diag = float(np.linalg.norm(tmax.max(0) - tmin.min(0))) if n_valid else 1.0
    mega = diag > MEGA_FRAC * max(scene_diag, 1e-12)
    if int(mega.sum()) > MAX_MEGA:
        mega = np.zeros(n_valid, bool)
        mega[np.argsort(-diag)[:MAX_MEGA]] = True
    reg = np.nonzero(~mega)[0]
    centroids = v0 + (e1 + e2) / 3.0
    order = reg[_median_split(centroids[reg], CLUSTER)] if reg.size else reg
    megas = np.nonzero(mega)[0]
    return np.concatenate([order, megas, np.arange(n_valid, T)]), megas.size


@dataclass
class Scene:
    """Compiled tables as tensors. Triangles: v0, e1, e2, the shading
    normal of each corner (n0, n1, n2: the compile-time face normal), the
    material, the light row of an emitter, a mask; `verts` and `face_vi`
    index the shared vertex buffer. Materials: type, albedo, emission.
    Lights: v0, e1, e2, normal, radiance, two-sided, mask, the area CDF and
    total area. `mega`: the mega triangles' indices."""
    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n: torch.Tensor
    tri_mat: torch.Tensor
    tri_light: torch.Tensor
    tri_mask: torch.Tensor
    verts: torch.Tensor
    face_vi: torch.Tensor
    mat_type: torch.Tensor
    mat_albedo: torch.Tensor
    mat_emission: torch.Tensor
    light_v0: torch.Tensor
    light_e1: torch.Tensor
    light_e2: torch.Tensor
    light_normal: torch.Tensor
    light_radiance: torch.Tensor
    light_two_sided: torch.Tensor
    light_mask: torch.Tensor
    light_cdf: torch.Tensor
    light_total_area: torch.Tensor
    mega: torch.Tensor

    @property
    def dtype(self):
        return self.tri_v0.dtype

    def replace(self, **kw) -> "Scene":
        return Scene(**{**self.__dict__, **kw})


def compile_inputs(inp: Inputs, device, dtype=torch.float32) -> Scene:
    tri = {k: [] for k in ("v0", "e1", "e2", "n", "mat", "light", "vi")}
    verts, offset = [], 0
    mats = list(inp.materials)

    def add(v, f, mat, light_rows):
        nonlocal offset
        p0, e1, e2, gn, _ = _faces(v, f)
        for k, x in zip(("v0", "e1", "e2", "n"), (p0, e1, e2, gn)):
            tri[k].append(x)
        tri["mat"].append(np.full(len(f), mat, np.int64))
        tri["light"].append(np.asarray(light_rows, np.int64))
        tri["vi"].append(f + offset)
        verts.append(np.asarray(v, np.float32))
        offset += len(v)

    for v, f, mat in inp.shapes:
        add(v, f, mat, np.full(len(f), -1))
    light = {k: [] for k in ("v0", "e1", "e2", "n", "rad", "area")}
    row = 0
    for v, f, radiance, visible in inp.lights:
        p0, e1, e2, gn, area = _faces(v, f)
        for k, x in zip(("v0", "e1", "e2", "n", "area"), (p0, e1, e2, gn, area)):
            light[k].append(x)
        light["rad"].append(np.tile(np.asarray(radiance, np.float32), (len(f), 1)))
        if visible:
            mats.append((EMISSIVE, (0, 0, 0), radiance))
            add(v, f, len(mats) - 1, np.arange(row, row + len(f)))
        row += len(f)

    tri = {k: np.concatenate(x) for k, x in tri.items()}
    n = tri["v0"].shape[0]
    T = bucket_size(n, CLUSTER)
    mask = pad_rows(np.ones(n, bool), T, False)
    tri = {k: pad_rows(x, T, -1 if x.dtype == np.int64 else 0) for k, x in tri.items()}
    perm, n_mega = triangle_order(tri["v0"], tri["e1"], tri["e2"], n)
    tri = {k: x[perm] for k, x in tri.items()}
    mask = mask[perm]
    mega = np.arange(n - n_mega, n)
    vbuf = np.concatenate(verts)
    V = bucket_size(vbuf.shape[0], CLUSTER)
    vbuf = pad_rows(vbuf, V)

    M = bucket_size(len(mats), 8)
    mtype = np.zeros(M, np.int64)
    albedo = np.zeros((M, 3), np.float32)
    emission = np.zeros((M, 3), np.float32)
    for i, (t, a, e) in enumerate(mats):
        mtype[i], albedo[i], emission[i] = t, a, e

    light = {k: np.concatenate(x) for k, x in light.items()}
    nl = light["v0"].shape[0]
    L = bucket_size(nl, 8)
    lmask = pad_rows(np.ones(nl, bool), L, False)
    light = {k: pad_rows(x, L) for k, x in light.items()}
    areas = light["area"] * lmask
    total = float(np.sum(areas))
    cdf = np.cumsum(areas) / total
    cdf[-1] = 1.0 + 1e-6

    f = dict(dtype=dtype, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    t = lambda x, **kw: torch.as_tensor(np.ascontiguousarray(x), **(kw or f))  # noqa: E731
    scene = Scene(
        tri_v0=t(tri["v0"]), tri_e1=t(tri["e1"]), tri_e2=t(tri["e2"]),
        tri_n=t(tri["n"]), tri_mat=t(np.clip(tri["mat"], 0, M - 1), **i64),
        tri_light=t(tri["light"], **i64), tri_mask=t(mask, device=device),
        verts=t(vbuf), face_vi=t(np.clip(tri["vi"], 0, V - 1), **i64),
        mat_type=t(mtype, **i64), mat_albedo=t(albedo), mat_emission=t(emission),
        light_v0=t(light["v0"]), light_e1=t(light["e1"]), light_e2=t(light["e2"]),
        light_normal=t(light["n"]), light_radiance=t(light["rad"]),
        light_two_sided=torch.zeros(L, dtype=torch.bool, device=device),
        light_mask=t(lmask, device=device), light_cdf=t(cdf.astype(np.float32)),
        light_total_area=torch.tensor(np.float32(total), **f),
        mega=torch.as_tensor(mega, dtype=torch.int64, device=device))
    return scene


@dataclass
class Camera:
    position: torch.Tensor
    topleft: torch.Tensor
    right_vec: torch.Tensor
    down_vec: torch.Tensor


def _normalize3(a: torch.Tensor) -> torch.Tensor:
    n2 = a[0] * a[0] + a[1] * a[1] + a[2] * a[2]
    eps2 = 1e-8 * 1e-8
    return a * torch.where(n2 > eps2, torch.rsqrt(torch.clamp(n2, min=eps2)), 1.0)


def camera(spec: dict, device, dtype=torch.float32) -> Camera:
    """A pinhole camera. "mafrix": the view plane 0.5 ahead with
    half-extent tan(fov * pi / 720); "standard": `fov` is the horizontal
    field of view and the plane is at 1."""
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.as_tensor(spec["position"], **f32)
    fwd = _normalize3(torch.as_tensor(spec["direction"], **f32))
    up = _normalize3(torch.tensor([0.0, 1.0, 0.0], **f32))
    right = _normalize3(torch.linalg.cross(fwd, up))
    true_up = torch.linalg.cross(right, fwd)
    fov = torch.tensor(spec["fov"], **f32)
    if spec["convention"] == "mafrix":
        plane, hori = 0.5, torch.tan(0.5 * fov * math.pi / 360.0)
    else:
        plane, hori = 1.0, 2.0 * torch.tan(0.5 * fov * math.pi / 180.0)
    vert = hori / torch.tensor(spec["aspect"], **f32)
    right_vec, up_vec = right * hori, true_up * vert
    topleft = pos + plane * fwd - 0.5 * right_vec + 0.5 * up_vec
    return Camera(*(x.to(dtype) for x in (pos, topleft, right_vec, -up_vec)))
