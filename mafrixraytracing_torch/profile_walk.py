"""Walk profile of the flat closest-hit search: what a tile's list holds, how
much of it the walk reaches, and what the cull and the early exit cost.

    python3 -m mafrixraytracing_torch.profile_walk [--size N] [--cpu]

The counterpart of `experiments/exp6.py` and `experiments/exp_cullkernel.py`
as one script. On a flat scene (at most 128 clusters: the `mesh_scene` around
BENCH_OBJ=<path>, else around a seeded displaced sphere of 15,488 faces that
it writes to the temp directory) it builds two wavefronts:

- the primary wavefront in the render's own ray order: pixels in tile order,
  8 jittered samples a pixel, so B = 8 N^2 (524,288 at the default N = 256)
  and a 128-ray tile is a 4 x 4 pixel block;
- the bounce-1 wavefront: the rays that leave the primary hits by BSDF
  sampling, sorted by the integrator's coherence key (`_coherence_key_soa`),
  dead lanes (a miss) last with tmax 0.

On each it runs the PyTorch cull (`cull_reference`: `_cull` and its
conversions) against kernel K (`cull_lists`, the main path's cull), and
kernel A against the counting walk and the walk without early exit, and
prints: the listed clusters a tile and the walked clusters a tile (mean,
p50, p90, max), the times of the five, and whether K equals the PyTorch cull
and both instrumented walks equal A bit for bit. The last line is one JSON object with all of it. `main()`
returns that record and raises if an equality fails.

The two instrumented walks are A's own walk: the counting walk is A's with a
counter of the listed clusters each tile reaches before the exit, the walk
without early exit is A's with the exit off (the rays still skip, by their
box tests, the clusters they do not enter). So the full walk's time less the
counting walk's is what A's exit saves. (Until the walks took A's walk, they
held a ray a thread and staged every listed cluster for all 128 rays: the
full walk's time was that walk's cost, not the exit's.)

The two instrumented walks launch here and only here: no render path calls
them. Times are device milliseconds (CUDA events) on a card; with `--cpu` the
plain versions run and the times are the host's, recorded as `host_ms`.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from mafrixraytracing_torch.core import rng, v3
from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.core.v3 import V3
from mafrixraytracing_torch.integrator import path as P
from mafrixraytracing_torch.materials.bsdf import sample_bsdf_soa
from mafrixraytracing_torch.ops import dispatch
from mafrixraytracing_torch.ops import intersect as oi
from mafrixraytracing_torch.scene.assets import mesh_scene
from mafrixraytracing_torch.scene.compiler import compile_scene

SPP_GROUP = 8           # samples a pixel in one wavefront, as the render's
T_MIN = P.RAY_EPS
SPHERE_QUADS = 88       # 88 x 88 quads = 15,488 faces: 122 clusters with the ground


def write_sphere_obj(path: str, quads: int = SPHERE_QUADS, seed: int = 2025,
                     cols: int | None = None) -> None:
    """A seeded displaced UV sphere of 2 quads x cols faces (cols: quads by
    default) as an OBJ file."""
    cols = quads if cols is None else cols
    rs = np.random.default_rng(seed)
    th = np.linspace(0.02, np.pi - 0.02, quads + 1)[:, None]
    ph = np.linspace(0.0, 2.0 * np.pi, cols, endpoint=False)[None, :]
    r = 1.0 + 0.04 * rs.normal(size=(quads + 1, cols))
    v = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                  r * np.sin(th) * np.sin(ph)], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(quads), np.arange(cols), indexing="ij")
    a = (i * cols + j).ravel()
    b = (i * cols + (j + 1) % cols).ravel()
    c, d = a + cols, b + cols
    faces = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)]) + 1
    with open(path, "w") as f:
        f.write("# seeded displaced sphere, %d faces\ng mesh\n" % faces.shape[0])
        f.writelines("v %.7f %.7f %.7f\n" % tuple(p) for p in v)
        f.writelines("f %d %d %d\n" % tuple(t) for t in faces)


def flat_spec(size: int, quads: int = SPHERE_QUADS, seed: int = 2025):
    """(SceneSpec, name): the scene around BENCH_OBJ, else around the seeded
    sphere (written anew to the temp directory at every call)."""
    obj = os.environ.get("BENCH_OBJ")
    if obj:
        return mesh_scene(obj, size, size), os.path.basename(obj)
    path = os.path.join(tempfile.gettempdir(),
                        f"mafrix_torch_sphere{quads}_seed{seed}.obj")
    part = f"{path}.{os.getpid()}.part"
    write_sphere_obj(part, quads, seed)
    os.replace(part, path)
    return mesh_scene(path, size, size), f"sphere{2 * quads * quads}"


def time_ms(fn, reps: int, on_card: bool) -> float:
    """Mean milliseconds of fn() over `reps` calls after one warm-up: CUDA
    events on a card, the host's clock on the CPU."""
    fn()
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def primary_wavefront(camera, size: int, key: torch.Tensor):
    """(o, d, sample keys) of the primary wavefront in `render_image`'s ray
    order: tiled pixels, SPP_GROUP consecutive jittered samples a pixel."""
    dev = key.device
    B = size * size
    perm, _ = P.tiled_pixel_order(size, size, *P._spp_tile_shape(SPP_GROUP))
    perm = torch.as_tensor(perm, device=dev)
    px, py = P.make_pixel_uv(size, size, dev)
    pxg = px[perm].repeat_interleave(SPP_GROUP)
    pyg = py[perm].repeat_interleave(SPP_GROUP)
    base = rng.pixel_keys(key, B)
    sidx = torch.arange(SPP_GROUP, device=dev)
    skeys = rng.sample_key(base[:, None, :], sidx[None, :]).reshape(B * SPP_GROUP, 2)
    jit_uv = rng.uniforms(skeys, 1000, (2,))
    o, d = camera.get_rays((pxg + jit_uv[:, 0]) / size, (pyg + jit_uv[:, 1]) / size)
    return o, d, skeys


@torch.no_grad()
def bounce1_wavefront(scene, o: V3, d: V3, skeys: torch.Tensor):
    """(o, d, tmax) of the rays that leave the primary hits, as the
    integrator's bounce makes them, sorted by its coherence key."""
    hit, sh = dispatch.intersect_shade_soa(scene, o, d, T_MIN, 1e8)
    bs = sample_bsdf_soa(sh, hit, -d, rng.bounce_key(skeys, 0),
                         glossy=scene.has_glossy, metal=scene.has_metal,
                         dielectric=scene.has_dielectric)
    flip = torch.where(v3.dot(hit.normal, bs.wi) >= 0.0, P.RAY_EPS, -P.RAY_EPS)
    o1 = hit.point + hit.normal * flip
    alive = hit.valid & bs.valid
    order = torch.argsort(P._coherence_key_soa(scene, o1, bs.wi, alive), stable=True)
    take = lambda c: c.index_select(0, order)  # noqa: E731
    return o1.map(take), bs.wi.map(take), take(torch.where(alive, 1e8, 0.0))


def _spread(x: torch.Tensor) -> dict:
    x = x.to(torch.float32).cpu().numpy()
    return {"mean": float(x.mean()), "p50": float(np.percentile(x, 50)),
            "p90": float(np.percentile(x, 90)), "max": int(x.max())}


def profile_wavefront(scene, o: V3, d: V3, t_max, label: str, reps: int) -> dict:
    """Cull and walk one wavefront every way; -> its record."""
    on_card = o.x.is_cuda
    walk, *_ = oi._prep(scene, o, d, T_MIN, t_max, anyhit=False)
    if oi._is_super(walk):
        raise ValueError(f"profile_walk needs a flat scene: {scene.cluster_min.shape[0]} "
                         f"clusters take the two-level path")
    lists, counts, rays = walk[-4], walk[-3], walk[-1]
    boxes = (scene.cluster_min, scene.cluster_max)
    cull_p = oi.cull_reference(*boxes, rays)
    cull_k = oi.cull_lists(*boxes, rays)
    same_cull = (all(torch.equal(a, b) for a, b in zip(cull_k, cull_p))
                 and torch.equal(cull_k[0], lists) and torch.equal(cull_k[1], counts)
                 and torch.equal(cull_k[3], rays[7]))
    ta, ia = oi.closest_hit(*walk, T_MIN)
    td, id_, walked = oi.closest_dbg_hit(*walk, T_MIN)
    tf, if_ = oi.closest_full_hit(*walk, T_MIN)
    record = {
        "rays": int(rays.shape[1]),
        "live_rays": int((rays[6] > T_MIN).sum()),
        "hit_rate": float((ia >= 0).to(torch.float32).mean()),
        "listed_per_tile": _spread(counts),
        "walked_per_tile": _spread(walked),
        "cull_kernel_equals_cull": bool(same_cull),
        "dbg_equals_closest": bool(torch.equal(td, ta) and torch.equal(id_, ia)),
        "full_equals_closest": bool(torch.equal(tf, ta) and torch.equal(if_, ia)),
        "walked_within_listed": bool((walked <= counts).all()),
        ("ms" if on_card else "host_ms"): {
            "cull": time_ms(lambda: oi.cull_reference(*boxes, rays), reps, on_card),
            "cull_kernel": time_ms(lambda: oi.cull_lists(*boxes, rays), reps, on_card),
            "closest": time_ms(lambda: oi.closest_hit(*walk, T_MIN), reps, on_card),
            "closest_dbg": time_ms(lambda: oi.closest_dbg_hit(*walk, T_MIN), reps, on_card),
            "closest_full": time_ms(lambda: oi.closest_full_hit(*walk, T_MIN), reps, on_card),
        },
    }
    li, wa = record["listed_per_tile"], record["walked_per_tile"]
    ms = record["ms" if on_card else "host_ms"]
    print(f"{label}: B = {record['rays']:,} ({record['live_rays']:,} live), hit rate "
          f"{record['hit_rate']:.4f}")
    for what, s in (("listed", li), ("walked", wa)):
        print(f"  {what} clusters a tile: mean {s['mean']:.2f} p50 {s['p50']:.0f} "
              f"p90 {s['p90']:.0f} max {s['max']}")
    print(f"  {'ms' if on_card else 'host ms'}: cull in PyTorch {ms['cull']:.4f}, cull "
          f"kernel {ms['cull_kernel']:.4f}, closest {ms['closest']:.4f}, counting walk "
          f"{ms['closest_dbg']:.4f}, walk without early exit {ms['closest_full']:.4f}")
    print(f"  cull kernel == PyTorch cull: {record['cull_kernel_equals_cull']}; counting "
          f"walk == closest: {record['dbg_equals_closest']}; full walk == closest: "
          f"{record['full_equals_closest']}")
    for k in ("cull_kernel_equals_cull", "dbg_equals_closest", "full_equals_closest",
              "walked_within_listed"):
        if not record[k]:
            raise RuntimeError(f"profile_walk: {k} is false on the {label} wavefront")
    return record


def main(argv=None, size: int = 256, device=None, reps: int = 10, spec=None,
         scene_name=None) -> dict:
    """Profile both wavefronts of `spec` (default: `flat_spec(size)`) at
    size x size pixels on `device` (None: the CUDA card); prints the report
    and the JSON line, returns the record."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--size" in argv:
        size = int(argv[argv.index("--size") + 1])
    if "--cpu" in argv:
        device = "cpu"
    dev = resolve(device)
    if spec is None:
        spec, scene_name = flat_spec(size)
    cs = compile_scene(spec, device=dev)
    scene = cs.scene
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    print(f"profile_walk: {scene_name or 'custom'}, {int(scene.tri_mask.sum())} triangles, "
          f"{scene.cluster_min.shape[0]} clusters, {size}x{size} x {SPP_GROUP} spp a "
          f"wavefront, on {device_name}")
    o, d, skeys = primary_wavefront(cs.camera, size, rng.root_key(0, dev))
    record = {"scene": scene_name or "custom", "device": device_name,
              "triangles": int(scene.tri_mask.sum()),
              "clusters": int(scene.cluster_min.shape[0]), "size": size,
              "spp_group": SPP_GROUP}
    record["primary"] = profile_wavefront(scene, o, d, 1e8, "primary", reps)
    o1, d1, tmax1 = bounce1_wavefront(scene, o, d, skeys)
    record["bounce1"] = profile_wavefront(scene, o1, d1, tmax1, "bounce 1, sorted", reps)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    if "--cpu" not in sys.argv[1:] and not torch.cuda.is_available():
        print("profile_walk: no CUDA device (--cpu runs the plain versions)",
              file=sys.stderr)
        sys.exit(1)
    main()
