#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py

Phases, each fatal on failure (a traceback and a non-zero exit; the final
`ok` line is printed only when every phase passed):

1. Device and build: the card's name and power limit (nvidia-smi), the CUDA
   version, and the build of the CUDA kernels from `mafrixraytracing_torch/
   csrc/` with its seconds.
2. Kernel parity: each kernel against its plain PyTorch version on the same
   inputs, and each one's time beside its plain version's, its bound on the
   card and, where one PyTorch call computes the same function, that call's
   time. The flat walks (closest, anyhit) and the gather on Cornell primary
   and shadow rays at B = 524,288 and on a seeded soup of 8,192 small
   triangles (64 clusters) at a non-aligned B with ~10% dead rays. The
   two-level walks (closest_super, anyhit_super) and the gather at P =
   65,544 on a seeded mesh of 36,996 faces (512 clusters, 32 superclusters)
   that is written as an OBJ file to the temp directory and loaded through
   `scene.assets.mesh_scene`: primary and shadow rays at B = 524,288 and a
   non-aligned batch with ~10% dead rays.
3. Forward, Cornell: 256x256, 64 spp, depth 5, NEE + MIS + Russian roulette,
   compaction calibrated from `trace_stats` as the benchmark does. The image
   must be finite with a sane mean, the launch counts of closest, anyhit and
   unpack must be > 0, a PNG goes to the temp directory, and a 64x64 render
   through the kernels must match the same render through the plain
   versions.
4. Forward + backward, Cornell: the benchmark's timed gradient of the mean
   image with respect to albedo, light radiance and vertices; all finite,
   the albedo and radiance gradients non-zero. Prints the benchmark's JSON
   line.
5. Forward, mesh: the same as 3 on the 36,996-face mesh scene; the launch
   counts of closest_super, anyhit_super and unpack must be > 0 and those of
   closest and anyhit 0. Also a 64x64 render with a checker texture on the
   mesh, finite and different from the untextured one.
6. Forward + backward, mesh: the same as 4 on the mesh scene, with the peak
   device memory.

Then, on lines of their own: the kernels' JSON record, the nvidia-smi line,
and last `{"ok": true, "device": {...}}`. Exits non-zero without a CUDA
device. Imports no JAX.

A kernel's bound is the larger of two times: the bytes of its inputs and
outputs over the card's memory rate (3.35 TB/s), and the fp32 operations of
the ray-triangle tests that these inputs need over the card's fp32 rate
outside the tensor cores (67 TFLOP/s). The tests a walk needs are counted
ray by ray from this run's data, whatever order a kernel takes them in and
whatever it shares across a tile: a live closest-hit ray needs the 128
triangles of every cluster (flat path: listed for its tile; two-level path:
child of a supercluster listed for its tile) whose box it enters no later
than its final hit; a live any-hit ray that ends unoccluded needs every such
cluster whose box it enters before tmax, and one that ends occluded needs one
cluster; a dead ray needs none. "Enters" is the slab test of
`ops.intersect.refine_children`.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from contextlib import contextmanager
from unittest import mock

# the full-size configuration of the main path
WIDTH = HEIGHT = 256
SPP = 64
DEPTH = 5
WAVEFRONT = 1 << 19         # rays per kernel call on the main path
SMALL = 64                  # side of the kernels-vs-plain comparison renders
MESH_FACES = 36996          # the face count of the reference's largest model

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12          # fp32 outside the tensor cores, same sheet
FLOPS_PER_TEST = 30         # one plane + barycentric ray-triangle test


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of fn() over `reps` calls (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextmanager
def plain_versions():
    """Route the five kernels' wrappers to their plain PyTorch versions
    (for the comparison renders only)."""
    from mafrixraytracing_torch.ops import intersect as oi
    from mafrixraytracing_torch.ops import unpack as ou

    with mock.patch.object(oi, "closest_hit", oi.closest_reference), \
            mock.patch.object(oi, "any_hit", oi.anyhit_reference), \
            mock.patch.object(oi, "closest_super_hit", oi.closest_super_reference), \
            mock.patch.object(oi, "any_super_hit", oi.anyhit_super_reference), \
            mock.patch.object(ou, "gather_unpack", ou.fetch_cols_reference):
        yield


def pick(walk):
    """(closest kernel, closest plain, any-hit kernel, any-hit plain) for a
    walk input of the flat or of the two-level path."""
    from mafrixraytracing_torch.ops import intersect as oi

    if oi._is_super(walk):
        return (oi.closest_super_kernel, oi.closest_super_reference,
                oi.anyhit_super_kernel, oi.anyhit_super_reference)
    return (oi.closest_kernel, oi.closest_reference,
            oi.anyhit_kernel, oi.anyhit_reference)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def walk_bound(scene, walk, t_min, t_final=None, occ=None):
    """The bound of one walk call on these inputs (see the module docstring)
    -> dict(bound_ms, bound_by, ray_cluster_pairs). `t_final` (closest hit:
    the kernel's t, tmax on a miss) or `occ` (any hit) is this run's result."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    lists, counts, rays = walk[-4], walk[-3], walk[-1]
    tiles, N = lists.shape
    B = rays.shape[1]
    tmax = rays[6]
    bounds = oi.pack_bounds(scene)   # every cluster's box, (S, 7, 16)
    S = bounds.shape[0]
    # member[tile, s, j]: cluster s * 16 + j is listed for the tile
    slot = torch.arange(N, device=rays.device)[None, :] < counts[:, None]
    member = torch.zeros((tiles, N + 1), dtype=torch.bool, device=rays.device)
    member.scatter_(1, torch.where(slot, lists.long(), N), True)
    if oi._is_super(walk):
        member = member[:, :S, None]
    else:
        member = torch.nn.functional.pad(member[:, :N], (0, S * oi.SUPER - N))
        member = member.reshape(tiles, S, oi.SUPER)
    live = tmax > t_min
    if occ is None:
        limit = torch.where(live, t_final, -oi.BIG)
        pairs = 0
    else:
        limit = torch.where(live & ~occ, tmax, -oi.BIG)
        pairs = int(occ.sum())
    step = 1 << 16
    for s in range(0, B, step):
        e = min(B, s + step)
        keep = oi.refine_children(bounds, rays[:, s:e], limit[s:e])
        keep = keep.reshape(-1, oi.TILE, S, oi.SUPER)
        pairs += int((keep & member[s // oi.TILE:e // oi.TILE, None]).sum())
    flops = pairs * oi.CLUSTER_SIZE * FLOPS_PER_TEST
    out_bytes = B * (8 if occ is None else 1)
    t_bytes = (nbytes(*walk) + out_bytes) / HBM_BYTES_PER_S
    t_flops = flops / FP32_FLOPS
    return dict(bound_ms=1e3 * max(t_bytes, t_flops),
                bound_by="operations" if t_flops >= t_bytes else "bytes",
                ray_cluster_pairs=pairs)


def compare_closest(walk, t_min, label):
    """Kernel A vs its plain version on one walk input. Returns (max |dt|,
    idx mismatches outside ties)."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    kernel, plain, _, _ = pick(walk)
    tk, ik = kernel(*walk, t_min)
    torch.cuda.synchronize()
    tp, ip = plain(*walk, t_min)
    torch.cuda.synchronize()
    tie = (tk - tp).abs() <= 1e-5
    bad_idx = int(((ik != ip) & ~tie).sum())
    t_ok = torch.isclose(tk, tp, rtol=1e-4, atol=1e-5).all().item()
    err = float((tk - tp).abs().max())
    n_hit = int((ik >= 0).sum())
    print(f"  closest {label}: B={tk.shape[0]} hits={n_hit} max|dt|={err:.3g} "
          f"idx mismatches (non-tie)={bad_idx} exact_idx={bool((ik == ip).all())}")
    check(bad_idx == 0 and t_ok, f"closest kernel disagrees on {label}")
    return err, tk, ik


def compare_anyhit(walk, t_min, label):
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    _, _, kernel, plain = pick(walk)
    ok_ = kernel(*walk, t_min)
    torch.cuda.synchronize()
    op = plain(*walk, t_min)
    torch.cuda.synchronize()
    diff = int((ok_ != op).sum())
    print(f"  anyhit {label}: B={ok_.shape[0]} occluded={int(ok_.sum())} "
          f"mismatches={diff}")
    check(diff == 0, f"any-hit kernel disagrees on {label}")
    return float(diff > 0), ok_


def soup_scene(device):
    """8,192 small random triangles (64 clusters), from a numpy seed."""
    import numpy as np

    from mafrixraytracing_torch.scene import spec as S
    from mafrixraytracing_torch.scene.compiler import compile_scene

    rs = np.random.default_rng(1234)
    n = 8192
    centers = rs.uniform(-1.0, 1.0, (n, 1, 3))
    verts = (centers + rs.normal(0.0, 0.04, (n, 3, 3))).reshape(-1, 3)
    mesh = S.Mesh(vertices=verts.astype(np.float32),
                  faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3))
    spec = S.SceneSpec(shapes=[S.ShapeSpec(mesh=mesh, material=0)])
    return compile_scene(spec, device=device).scene


def write_mesh_obj(path):
    """A seeded mesh of MESH_FACES = 36,996 faces as an OBJ file with uvs: a
    displaced UV sphere of 136 x 136 quads (36,992 triangles) and a small
    tetrahedron on top (4)."""
    import numpy as np

    rows = cols = 136
    rs = np.random.default_rng(2024)
    th = np.linspace(0.02, np.pi - 0.02, rows + 1)[:, None]
    ph = np.linspace(0.0, 2.0 * np.pi, cols + 1)[None, :]
    bump = rs.normal(size=(rows + 1, cols))
    r = 1.0 + 0.04 * np.concatenate([bump, bump[:, :1]], axis=1)  # closed seam
    v = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                  r * np.sin(th) * np.sin(ph)], axis=-1).reshape(-1, 3)
    uv = np.stack(np.broadcast_arrays(ph / (2.0 * np.pi), 1.0 - th / np.pi),
                  axis=-1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    a = (i * (cols + 1) + j).ravel()
    b, c, d = a + 1, a + cols + 1, a + cols + 2
    faces = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)])
    n = v.shape[0]
    tet = np.array([[0.0, 1.35, 0.0], [0.1, 1.1, 0.1], [-0.1, 1.1, 0.1],
                    [0.0, 1.1, -0.12]])
    tet_f = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]]) + n
    v = np.concatenate([v, tet])
    uv = np.concatenate([uv, np.full((4, 2), 0.5)])
    faces = np.concatenate([faces, tet_f]) + 1   # OBJ indices start at 1
    check(faces.shape[0] == MESH_FACES, "mesh face count")
    with open(path, "w") as f:
        f.write("# seeded displaced sphere, %d faces\ng mesh\n" % MESH_FACES)
        f.writelines("v %.7f %.7f %.7f\n" % tuple(p) for p in v)
        f.writelines("vt %.7f %.7f\n" % tuple(t) for t in uv)
        f.writelines("f %d/%d %d/%d %d/%d\n" % (x, x, y, y, z, z) for x, y, z in faces)


def mesh_spec(width, height, textured=False):
    """The mesh scene: the OBJ above, written to the temp directory and
    loaded through the port's OBJ loader and `mesh_scene`."""
    from mafrixraytracing_torch.materials.texture import checker_texture
    from mafrixraytracing_torch.scene.assets import mesh_scene

    path = os.path.join(tempfile.gettempdir(), "mafrix_torch_mesh36996.obj")
    if not os.path.exists(path):
        # written under another name first: a file at `path` is complete
        part = f"{path}.{os.getpid()}.part"
        write_mesh_obj(part)
        os.replace(part, path)
    spec = mesh_scene(path, width, height)
    if textured:
        spec.materials[0].texture_id = 0
        spec.textures.append(checker_texture(tiles=16))
    return spec


def time_library_gather(table, idx):
    """The one PyTorch call that computes the gather-unpack."""
    return time_ms(lambda: table.index_select(0, idx).t().contiguous())


def gather_bound(table, idx):
    out_bytes = 36 * idx.shape[0] * 4
    return dict(bound_ms=1e3 * (nbytes(table, idx) + out_bytes) / HBM_BYTES_PER_S,
                bound_by="bytes")


def wavefront_uv(torch, dev, gen):
    """Film coordinates of one wavefront in the integrator's ray order: the
    pixels in tile order, each carrying G consecutive jittered samples, so a
    128-ray tile is a compact screen block (`integrator.path.render_image`)."""
    from mafrixraytracing_torch.integrator import path as P

    G = P._spp_group(SPP, WIDTH * HEIGHT, WAVEFRONT)
    perm, _ = P.tiled_pixel_order(WIDTH, HEIGHT, *P._spp_tile_shape(G))
    px, py = P.make_pixel_uv(WIDTH, HEIGHT, dev)
    perm = torch.as_tensor(perm, device=dev)
    px, py = px[perm].repeat_interleave(G), py[perm].repeat_interleave(G)
    n = px.shape[0]
    return ((px + torch.rand(n, generator=gen, device=dev)) / WIDTH,
            (py + torch.rand(n, generator=gen, device=dev)) / HEIGHT)


def phase_kernels_mesh(torch, dev, records):
    """Kernels D and E (and the gather at a real table size) on the mesh."""
    import numpy as np

    from mafrixraytracing_torch.core.v3 import V3
    from mafrixraytracing_torch.geometry.intersect import packed_attr_table
    from mafrixraytracing_torch.ops import intersect as oi
    from mafrixraytracing_torch.ops import unpack as ou
    from mafrixraytracing_torch.scene.compiler import compile_scene

    t_min = 1e-3
    t0 = time.perf_counter()
    spec = mesh_spec(WIDTH, HEIGHT)
    t1 = time.perf_counter()
    cs = compile_scene(spec)
    scene = cs.scene
    C, S = scene.cluster_min.shape[0], scene.super_min.shape[0]
    print(f"  mesh: OBJ written and parsed in {t1 - t0:.2f} s, compiled in "
          f"{time.perf_counter() - t1:.2f} s: {int(scene.tri_mask.sum())} triangles, "
          f"{C} clusters, {S} superclusters, {scene.num_mega} mega")
    check(scene.tri_v0.is_cuda, "compile_scene did not default to the card")
    check(int(scene.tri_mask.sum()) == MESH_FACES + 2, "mesh triangle count")
    check((C, S) == (512, 32), "mesh must have 512 clusters, 32 superclusters")

    # --- primary rays: one wavefront in the main path's size and order ---
    gen = torch.Generator(device=dev).manual_seed(11)
    u, v = wavefront_uv(torch, dev, gen)
    B = u.shape[0]
    o, d = cs.camera.get_rays(u, v)
    walk, *_ = oi._prep(scene, o, d, t_min, 1e8, anyhit=False)
    check(oi._is_super(walk), "the mesh must take the two-level path")
    err_c, t_k, _ = compare_closest(walk, t_min, "mesh primary")
    ms_c = time_ms(lambda: oi.closest_super_kernel(*walk, t_min))
    ms_cp = time_ms(lambda: oi.closest_super_reference(*walk, t_min), reps=1)
    bound_c = walk_bound(scene, walk, t_min, t_final=t_k)

    # NEE-like shadow rays: from the primary hits toward points on the light
    t_hit, i_hit = oi.find_closest_soa(scene, o, d, t_min, 1e8)
    hit = i_hit >= 0
    p = o + d * torch.where(hit, t_hit, 0.0)
    lv0, le1, le2 = scene.light_v0[0], scene.light_e1[0], scene.light_e2[0]
    a1 = torch.rand(B, generator=gen, device=dev)
    a2 = torch.rand(B, generator=gen, device=dev)   # the light quad's parallelogram
    lp = V3(*(lv0[k] + a1 * le1[k] + a2 * le2[k] for k in range(3)))
    to_l = lp - p
    dist = torch.sqrt(to_l.x**2 + to_l.y**2 + to_l.z**2)
    sd = V3(to_l.x / dist, to_l.y / dist, to_l.z / dist)
    so = p + sd * 1e-3
    s_tmax = torch.where(hit, dist - 2e-3, 0.0)
    swalk, *_ = oi._prep(scene, so, sd, t_min, s_tmax, anyhit=True)
    err_a, occ_k = compare_anyhit(swalk, t_min, "mesh shadow")
    ms_a = time_ms(lambda: oi.anyhit_super_kernel(*swalk, t_min))
    ms_ap = time_ms(lambda: oi.anyhit_super_reference(*swalk, t_min), reps=1)
    bound_a = walk_bound(scene, swalk, t_min, occ=occ_k)

    # the gather at the mesh's table size
    table = packed_attr_table(scene).contiguous()
    check(table.shape[0] >= 65536, "the mesh's attribute table must be real-sized")
    gidx = i_hit.clamp(0, table.shape[0] - 1)
    gk = ou.unpack_kernel(table, gidx)
    torch.cuda.synchronize()
    gp = ou.fetch_cols_reference(table, gidx)
    print(f"  unpack mesh: B={B} P={table.shape[0]} "
          f"bit-exact={bool(torch.equal(gk, gp))}")
    check(torch.equal(gk, gp), "unpack kernel is not bit-exact on the mesh")
    ms_g = time_ms(lambda: ou.unpack_kernel(table, gidx))
    ms_gp = time_ms(lambda: ou.fetch_cols_reference(table, gidx))

    # --- non-aligned batch around the mesh, ~10% dead rays ---
    rs = np.random.default_rng(77)
    Bs = 65536 - 37
    o_np = rs.normal(0.0, 1.0, (Bs, 3))
    o_np = (2.5 * o_np / np.linalg.norm(o_np, axis=1, keepdims=True)).astype(np.float32)
    d_np = (rs.uniform(-0.9, 0.9, (Bs, 3)) - o_np).astype(np.float32)
    d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
    dead = rs.random(Bs) < 0.1
    tmax_c = np.where(dead, 0.0, 1e8).astype(np.float32)
    tmax_a = np.where(dead, 0.0, rs.uniform(0.5, 4.0, Bs)).astype(np.float32)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    qo, qd = V3.of(to(o_np)), V3.of(to(d_np))
    walk_n, *_ = oi._prep(scene, qo, qd, t_min, to(tmax_c), anyhit=False)
    err_cn, t_n, _ = compare_closest(walk_n, t_min, "mesh non-aligned")
    walk_na, *_ = oi._prep(scene, qo, qd, t_min, to(tmax_a), anyhit=True)
    err_an, occ_n = compare_anyhit(walk_na, t_min, "mesh non-aligned")
    # tiles of unrelated rays: the walks' worst case, beside their bound
    for name, fn, w, b in (
            ("closest_super", oi.closest_super_kernel, walk_n,
             walk_bound(scene, walk_n, t_min, t_final=t_n)),
            ("anyhit_super", oi.anyhit_super_kernel, walk_na,
             walk_bound(scene, walk_na, t_min, occ=occ_n))):
        ms = time_ms(lambda: fn(*w, t_min))  # noqa: B023
        print(f"  {name} on incoherent tiles (B = {w[-1].shape[1]:,}): kernel "
              f"{ms:.4f} ms, bound {b['bound_ms']:.5f} ms by {b['bound_by']}, "
              f"{b['ray_cluster_pairs']} ray-cluster pairs needed")

    records["closest_super"] = dict(max_abs_err=max(err_c, err_cn), ms=ms_c,
                                    plain_ms=ms_cp, library_ms=None, **bound_c)
    records["anyhit_super"] = dict(max_abs_err=max(err_a, err_an), ms=ms_a,
                                   plain_ms=ms_ap, library_ms=None, **bound_a)
    records["unpack"] = dict(max_abs_err=float((gk - gp).abs().max()), ms=ms_g,
                             plain_ms=ms_gp,
                             library_ms=time_library_gather(table, gidx),
                             **gather_bound(table, gidx))
    for k in ("closest_super", "anyhit_super", "unpack"):
        r = records[k]
        print(f"  {k}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}"
              + (f", {r['ray_cluster_pairs']} ray-cluster pairs needed"
                 if "ray_cluster_pairs" in r else "")
              + f" (mesh, B = {B:,})")
    return records


def phase_kernels(torch, dev):
    import numpy as np

    from mafrixraytracing_torch.core.v3 import V3
    from mafrixraytracing_torch.geometry.intersect import packed_attr_table
    from mafrixraytracing_torch.ops import intersect as oi
    from mafrixraytracing_torch.ops import unpack as ou
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    t_min = 1e-3
    records = {}
    # --- Cornell primary rays at the main path's wavefront size ---
    cs = compile_scene(cornell_box(256, 256), device=dev)
    scene = cs.scene
    gen = torch.Generator(device=dev).manual_seed(7)
    B = WAVEFRONT
    u = torch.rand(B, generator=gen, device=dev)
    v = torch.rand(B, generator=gen, device=dev)
    o, d = cs.camera.get_rays(u, v)
    walk, _, _, _, _ = oi._prep(scene, o, d, t_min, 1e8, anyhit=False)
    err_c, t_k, idx = compare_closest(walk, t_min, "cornell primary")
    ms_c = time_ms(lambda: oi.closest_kernel(*walk, t_min))
    ms_cp = time_ms(lambda: oi.closest_reference(*walk, t_min), reps=3)
    bound_c = walk_bound(scene, walk, t_min, t_final=t_k)

    # NEE-like shadow rays: from the primary hits toward points on the light
    t_hit, i_hit = oi.find_closest_soa(scene, o, d, t_min, 1e8)
    hit = i_hit >= 0
    p = o + d * torch.where(hit, t_hit, 0.0)
    lx = (torch.rand(B, generator=gen, device=dev) - 0.5) * 0.47
    lz = (torch.rand(B, generator=gen, device=dev) - 0.5) * 0.47
    to_l = V3(lx - p.x, 1.98 - p.y, lz - p.z)
    dist = torch.sqrt(to_l.x**2 + to_l.y**2 + to_l.z**2)
    sd = V3(to_l.x / dist, to_l.y / dist, to_l.z / dist)
    so = p + sd * 1e-3
    s_tmax = torch.where(hit, dist - 2e-3, 0.0)
    swalk, _, _, _, _ = oi._prep(scene, so, sd, t_min, s_tmax, anyhit=True)
    err_a, occ_k = compare_anyhit(swalk, t_min, "cornell shadow")
    ms_a = time_ms(lambda: oi.anyhit_kernel(*swalk, t_min))
    ms_ap = time_ms(lambda: oi.anyhit_reference(*swalk, t_min), reps=3)
    bound_a = walk_bound(scene, swalk, t_min, occ=occ_k)

    # gather-unpack at the main path's shape
    table = packed_attr_table(scene).contiguous()
    gidx = i_hit.clamp(0, table.shape[0] - 1)
    gk = ou.unpack_kernel(table, gidx)
    torch.cuda.synchronize()
    gp = ou.fetch_cols_reference(table, gidx)
    err_g = float((gk - gp).abs().max())
    print(f"  unpack cornell: B={B} P={table.shape[0]} max|d|={err_g} "
          f"bit-exact={bool(torch.equal(gk, gp))}")
    check(torch.equal(gk, gp), "unpack kernel is not bit-exact")
    ms_g = time_ms(lambda: ou.unpack_kernel(table, gidx))
    ms_gp = time_ms(lambda: ou.fetch_cols_reference(table, gidx))
    print(f"  unpack cornell (P = {table.shape[0]}): kernel {ms_g:.4f} ms, plain "
          f"{ms_gp:.4f} ms, library {time_library_gather(table, gidx):.4f} ms, "
          f"bound {gather_bound(table, gidx)['bound_ms']:.5f} ms by bytes")

    # --- synthetic soup: 64 clusters, non-aligned batch, ~10% dead rays ---
    soup = soup_scene(dev)
    check(soup.cluster_min.shape[0] == 64, "soup must have 64 clusters")
    rs = np.random.default_rng(99)
    Bs = 65536 - 37
    so_np = rs.uniform(-1.5, 1.5, (Bs, 3)).astype(np.float32)
    sd_np = rs.normal(size=(Bs, 3)).astype(np.float32)
    sd_np /= np.linalg.norm(sd_np, axis=1, keepdims=True)
    dead = rs.random(Bs) < 0.1
    tmax_c = np.where(dead, 0.0, 1e8).astype(np.float32)
    tmax_a = np.where(dead, 0.0, rs.uniform(0.0, 2.0, Bs)).astype(np.float32)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    qo, qd = V3.of(to(so_np)), V3.of(to(sd_np))
    walk_s, _, _, _, _ = oi._prep(soup, qo, qd, t_min, to(tmax_c), anyhit=False)
    err_cs, _, idx_s = compare_closest(walk_s, t_min, "soup")
    walk_sa, _, _, _, _ = oi._prep(soup, qo, qd, t_min, to(tmax_a), anyhit=True)
    err_as, _ = compare_anyhit(walk_sa, t_min, "soup")
    tab_s = packed_attr_table(soup).contiguous()
    gidx_s = idx_s.long().clamp(0, tab_s.shape[0] - 1)
    check(torch.equal(ou.unpack_kernel(tab_s, gidx_s),
                      ou.fetch_cols_reference(tab_s, gidx_s)),
          "unpack kernel is not bit-exact on the soup")
    ms_cs = time_ms(lambda: oi.closest_kernel(*walk_s, t_min))
    ms_csp = time_ms(lambda: oi.closest_reference(*walk_s, t_min), reps=2)
    ms_as = time_ms(lambda: oi.anyhit_kernel(*walk_sa, t_min))
    ms_asp = time_ms(lambda: oi.anyhit_reference(*walk_sa, t_min), reps=2)
    print(f"  soup times (ms, kernel / plain): closest {ms_cs:.3f} / "
          f"{ms_csp:.3f}, anyhit {ms_as:.3f} / {ms_asp:.3f}")

    records["closest"] = dict(max_abs_err=max(err_c, err_cs), ms=ms_c,
                              plain_ms=ms_cp, library_ms=None, **bound_c)
    records["anyhit"] = dict(max_abs_err=max(err_a, err_as), ms=ms_a,
                             plain_ms=ms_ap, library_ms=None, **bound_a)
    check(err_g == 0.0, "unpack kernel differs on Cornell")
    for k, r in records.items():
        print(f"  {k}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, "
              f"{r['ray_cluster_pairs']} ray-cluster pairs needed (Cornell, "
              f"B = {B:,})")
    return phase_kernels_mesh(torch, dev, records)


def phase_forward(torch, dev, make_spec, label, launched, idle):
    """The forward main path on `make_spec(width, height)`: `launched` names
    the kernels it must go through, `idle` those it must not touch."""
    import numpy as np

    from mafrixraytracing_torch import bench
    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.film.image import write_png
    from mafrixraytracing_torch.film.tonemap import to_bytes, tonemap
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.scene.compiler import compile_scene

    W, H, spp = WIDTH, HEIGHT, SPP
    cs = compile_scene(make_spec(W, H))
    check(cs.scene.tri_v0.is_cuda and cs.camera.position.is_cuda,
          "compile_scene did not default to the card")
    cuda.reset_launches()
    t0 = time.perf_counter()
    config, survival = bench.calibrated_config(cs.scene, cs.camera, W, H,
                                               DEPTH)
    queries = bench.count_queries_per_sample(cs.scene, cs.camera, W, H, config)
    t1 = time.perf_counter()
    calibration = dict(cuda.LAUNCHES)
    # the recorded counts are the frame's own: zeroed just before the render,
    # read just after
    cuda.reset_launches()
    with torch.no_grad():
        img = P.render_image(cs.scene, cs.camera, W, H, spp, rng.root_key(0),
                             config)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    t2 = time.perf_counter()
    mean = float(img.mean())
    print(f"  calibration {t1 - t0:.3f} s (launches {calibration}), queries per "
          f"spp {queries:.0f}, survival {survival}, "
          f"compact {[round(c, 4) for c in config.compact]}")
    print(f"  forward {label} {W}x{H} x {spp} spp: {t2 - t1:.3f} s "
          f"(first call, includes warm-up), mean {mean:.5f}, launches {launches}")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(0.02 < mean < 0.5, f"image mean {mean} outside (0.02, 0.5)")
    for k in launched:
        check(launches[k] > 0, f"kernel {k} was not launched on the {label} path")
    for k in idle:
        check(launches[k] == 0, f"kernel {k} was launched on the {label} path")
    with torch.no_grad():
        t3 = time.perf_counter()
        P.render_image(cs.scene, cs.camera, W, H, spp, rng.root_key(1), config)
        torch.cuda.synchronize()
        print(f"  forward again: {time.perf_counter() - t3:.3f} s/frame")
    png = os.path.join(tempfile.gettempdir(), f"mafrix_torch_{label}.png")
    write_png(png, to_bytes(tonemap(img)).cpu().numpy())
    print(f"  wrote {png}")

    # kernels vs plain versions through the whole integrator, 64x64 x 4 spp
    small = compile_scene(make_spec(SMALL, SMALL))
    cfg = P.PathTracerConfig(max_depth=5, compact=(1.0, 0.7, 0.3, 0.15, 0.05))
    with torch.no_grad():
        a = P.render_image(small.scene, small.camera, SMALL, SMALL, 4,
                           rng.root_key(5), cfg)
        with plain_versions():
            b = P.render_image(small.scene, small.camera, SMALL, SMALL, 4,
                               rng.root_key(5), cfg)
    a, b = a.cpu().numpy(), b.cpu().numpy()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    print(f"  {SMALL}x{SMALL} x 4 spp kernels vs plain: {close:.5f} of pixels close, "
          f"mean rel diff {rel:.3g}, identical={bool(np.array_equal(a, b))}")
    check(close >= 0.995 and rel <= 1e-4, "kernel render disagrees with plain render")
    return launches, a


def phase_textured(torch, untextured):
    """A checker texture on the mesh: the textured branch of the attribute
    recompute runs on the card and changes the picture."""
    import numpy as np

    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.scene.compiler import compile_scene

    cs = compile_scene(mesh_spec(SMALL, SMALL, textured=True))
    check(cs.scene.has_textures, "the textured mesh scene has no texture")
    cfg = P.PathTracerConfig(max_depth=5, compact=(1.0, 0.7, 0.3, 0.15, 0.05))
    with torch.no_grad():
        img = P.render_image(cs.scene, cs.camera, SMALL, SMALL, 4,
                             rng.root_key(5), cfg).cpu().numpy()
    diff = float(np.abs(img - untextured).mean())
    print(f"  textured {SMALL}x{SMALL} x 4 spp: mean {img.mean():.5f}, mean |textured - "
          f"untextured| {diff:.5f}")
    check(np.isfinite(img).all(), "textured image has non-finite values")
    check(diff > 1e-3, "the texture did not change the picture")


def phase_fwd_bwd(torch, spec=None, scene_name=None, iters=3):
    from mafrixraytracing_torch import bench

    torch.cuda.reset_peak_memory_stats()
    record, grads = bench.run(WIDTH, HEIGHT, SPP, DEPTH, iters=iters, spec=spec,
                              scene_name=scene_name)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    names = ("mat_albedo", "light_radiance", "tri_v0")
    for n, g in zip(names, grads):
        check(g is not None and bool(torch.isfinite(g).all()),
              f"gradient of {n} is not finite")
        print(f"  grad {n}: |g|max {float(g.abs().max()):.4g}")
    check(float(grads[0].abs().max()) > 0, "albedo gradient is zero")
    check(float(grads[1].abs().max()) > 0, "radiance gradient is zero")
    print(json.dumps(record))
    return record


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mafrixraytracing_torch import bench
    from mafrixraytracing_torch.ops import cuda

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("[1] device and build")
    info = bench.device_info()
    check(info["nvidia_smi"], "nvidia-smi did not report the card")
    print(f"  {info['nvidia_smi']}  torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = cuda.build(verbose=True)
    cuda.lib()
    print(f"  built {lib_path.name} in {time.perf_counter() - t0:.2f} s")

    print("[2] kernel parity (kernel vs plain PyTorch version)")
    records = phase_kernels(torch, dev)

    from mafrixraytracing_torch.scene.builtin import cornell_box

    print("[3] forward, Cornell")
    flat, two_level = ("closest", "anyhit"), ("closest_super", "anyhit_super")
    launches, _ = phase_forward(torch, dev, cornell_box, "cornell",
                                launched=flat + ("unpack",), idle=two_level)

    print("[4] forward + backward, Cornell")
    phase_fwd_bwd(torch)

    print("[5] forward, mesh of 36,996 faces")
    mesh_launches, small = phase_forward(torch, dev, mesh_spec, "mesh36996",
                                         launched=two_level + ("unpack",),
                                         idle=flat)
    phase_textured(torch, small)
    # each kernel's count is that of the path that runs it (the gather runs
    # on both; the mesh path's count is the one recorded)
    launches.update({k: mesh_launches[k] for k in two_level + ("unpack",)})

    print("[6] forward + backward, mesh of 36,996 faces")
    phase_fwd_bwd(torch, mesh_spec(WIDTH, HEIGHT), "mesh36996", iters=2)

    pallas = "mafrixraytracing_tpu/ops/intersect_pallas.py"
    sources = {"closest": ("mafrixraytracing_torch/csrc/intersect.cu", pallas + ":356"),
               "anyhit": ("mafrixraytracing_torch/csrc/intersect.cu", pallas + ":450"),
               "unpack": ("mafrixraytracing_torch/csrc/unpack.cu",
                          "mafrixraytracing_tpu/ops/unpack_pallas.py:43"),
               "closest_super": ("mafrixraytracing_torch/csrc/intersect_super.cu",
                                 pallas + ":964"),
               "anyhit_super": ("mafrixraytracing_torch/csrc/intersect_super.cu",
                                pallas + ":1028")}
    kernels = [dict(name=k, route="cuda", source=sources[k][0],
                    replaces=sources[k][1], launches=launches[k], **records[k])
               for k in sources]
    print(json.dumps({"kernels": kernels}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
