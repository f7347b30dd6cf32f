#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py

Phases, each fatal on failure (a traceback and a non-zero exit; the final
`ok` line is printed only when every phase passed):

1. Device and build: the card's name and power limit (nvidia-smi), the CUDA
   version, and the build of the CUDA kernels from `mafrixraytracing_torch/
   csrc/` with its seconds.
2. Kernel parity: each kernel against its plain PyTorch version on the same
   inputs — Cornell primary rays at B = 524,288 and a seeded soup of 8,192
   small triangles (64 clusters) at a non-aligned B with ~10% dead rays —
   and each one's time beside its plain version's.
3. Forward main path: Cornell 256x256, 64 spp, depth 5, NEE + MIS + Russian
   roulette, compaction calibrated from `trace_stats` as the benchmark does.
   The image must be finite with a sane mean, every kernel's launch count
   must be > 0, a PNG goes to the temp directory, and a 64x64 render through
   the kernels must match the same render through the plain versions.
4. Forward + backward: the benchmark's timed gradient of the mean image with
   respect to albedo, light radiance and vertices; all finite, the albedo
   and radiance gradients non-zero. Prints the benchmark's JSON line.

Then, on lines of their own: the kernels' JSON record, the nvidia-smi line,
and last `{"ok": true, "device": {...}}`. Exits non-zero without a CUDA
device. Imports no JAX.
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
    """Route the three kernels' wrappers to their plain PyTorch versions
    (for the comparison render only)."""
    from mafrixraytracing_torch.ops import intersect as oi
    from mafrixraytracing_torch.ops import unpack as ou

    with mock.patch.object(oi, "closest_hit", oi.closest_reference), \
            mock.patch.object(oi, "any_hit", oi.anyhit_reference), \
            mock.patch.object(ou, "gather_unpack", ou.fetch_cols_reference):
        yield


def compare_closest(walk, t_min, label):
    """Kernel A vs its plain version on one walk input. Returns (max |dt|,
    idx mismatches outside ties)."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    tk, ik = oi.closest_kernel(*walk, t_min)
    torch.cuda.synchronize()
    tp, ip = oi.closest_reference(*walk, t_min)
    torch.cuda.synchronize()
    tie = (tk - tp).abs() <= 1e-5
    bad_idx = int(((ik != ip) & ~tie).sum())
    t_ok = torch.isclose(tk, tp, rtol=1e-4, atol=1e-5).all().item()
    err = float((tk - tp).abs().max())
    n_hit = int((ik >= 0).sum())
    print(f"  closest {label}: B={tk.shape[0]} hits={n_hit} max|dt|={err:.3g} "
          f"idx mismatches (non-tie)={bad_idx} exact_idx={bool((ik == ip).all())}")
    check(bad_idx == 0 and t_ok, f"closest kernel disagrees on {label}")
    return err, ik


def compare_anyhit(walk, t_min, label):
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    ok_ = oi.anyhit_kernel(*walk, t_min)
    torch.cuda.synchronize()
    op = oi.anyhit_reference(*walk, t_min)
    torch.cuda.synchronize()
    diff = int((ok_ != op).sum())
    print(f"  anyhit {label}: B={ok_.shape[0]} occluded={int(ok_.sum())} "
          f"mismatches={diff}")
    check(diff == 0, f"any-hit kernel disagrees on {label}")
    return float(diff > 0)


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
    B = 1 << 19
    u = torch.rand(B, generator=gen, device=dev)
    v = torch.rand(B, generator=gen, device=dev)
    o, d = cs.camera.get_rays(u, v)
    walk, _, _, _, _ = oi._prep(scene, o, d, t_min, 1e8, anyhit=False)
    err_c, idx = compare_closest(walk, t_min, "cornell primary")
    ms_c = time_ms(lambda: oi.closest_kernel(*walk, t_min))
    ms_cp = time_ms(lambda: oi.closest_reference(*walk, t_min), reps=3)

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
    err_a = compare_anyhit(swalk, t_min, "cornell shadow")
    ms_a = time_ms(lambda: oi.anyhit_kernel(*swalk, t_min))
    ms_ap = time_ms(lambda: oi.anyhit_reference(*swalk, t_min), reps=3)

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
    err_cs, idx_s = compare_closest(walk_s, t_min, "soup")
    walk_sa, _, _, _, _ = oi._prep(soup, qo, qd, t_min, to(tmax_a), anyhit=True)
    err_as = compare_anyhit(walk_sa, t_min, "soup")
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

    records["closest"] = dict(max_abs_err=max(err_c, err_cs), ms=ms_c, plain_ms=ms_cp)
    records["anyhit"] = dict(max_abs_err=max(err_a, err_as), ms=ms_a, plain_ms=ms_ap)
    records["unpack"] = dict(max_abs_err=err_g, ms=ms_g, plain_ms=ms_gp)
    for k, r in records.items():
        print(f"  {k}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
              "(Cornell, B = 524,288)")
    return records


def phase_forward(torch, dev):
    import numpy as np

    from mafrixraytracing_torch import bench
    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.film.image import write_png
    from mafrixraytracing_torch.film.tonemap import to_bytes, tonemap
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    W, H, spp = WIDTH, HEIGHT, SPP
    cs = compile_scene(cornell_box(W, H), device=dev)
    cuda.reset_launches()
    t0 = time.perf_counter()
    config, survival = bench.calibrated_config(cs.scene, cs.camera, W, H,
                                               DEPTH)
    t1 = time.perf_counter()
    with torch.no_grad():
        img = P.render_image(cs.scene, cs.camera, W, H, spp,
                             rng.root_key(0, dev), config)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(cuda.LAUNCHES)
    mean = float(img.mean())
    print(f"  calibration {t1 - t0:.3f} s, survival {survival}, "
          f"compact {[round(c, 4) for c in config.compact]}")
    print(f"  forward {W}x{H} x {spp} spp: {t2 - t1:.3f} s "
          f"(first call, includes warm-up), mean {mean:.5f}, launches {launches}")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(0.02 < mean < 0.5, f"image mean {mean} outside (0.02, 0.5)")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    with torch.no_grad():
        t3 = time.perf_counter()
        P.render_image(cs.scene, cs.camera, W, H, spp, rng.root_key(1, dev), config)
        torch.cuda.synchronize()
        print(f"  forward again: {time.perf_counter() - t3:.3f} s/frame")
    png = os.path.join(tempfile.gettempdir(), "mafrix_torch_cornell.png")
    write_png(png, to_bytes(tonemap(img)).cpu().numpy())
    print(f"  wrote {png}")

    # kernels vs plain versions through the whole integrator, 64x64 x 4 spp
    small = compile_scene(cornell_box(64, 64), device=dev)
    cfg = P.PathTracerConfig(max_depth=5, compact=(1.0, 0.7, 0.3, 0.15, 0.05))
    with torch.no_grad():
        a = P.render_image(small.scene, small.camera, 64, 64, 4,
                           rng.root_key(5, dev), cfg)
        with plain_versions():
            b = P.render_image(small.scene, small.camera, 64, 64, 4,
                               rng.root_key(5, dev), cfg)
    a, b = a.cpu().numpy(), b.cpu().numpy()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    print(f"  64x64 x 4 spp kernels vs plain: {close:.5f} of pixels close, "
          f"mean rel diff {rel:.3g}, identical={bool(np.array_equal(a, b))}")
    check(close >= 0.995 and rel <= 1e-4, "kernel render disagrees with plain render")
    return launches


def phase_fwd_bwd(torch):
    from mafrixraytracing_torch import bench

    torch.cuda.reset_peak_memory_stats()
    record, grads = bench.run(WIDTH, HEIGHT, SPP, DEPTH, iters=3)
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

    print("[3] forward main path")
    launches = phase_forward(torch, dev)

    print("[4] forward + backward")
    phase_fwd_bwd(torch)

    sources = {"closest": ("mafrixraytracing_torch/csrc/intersect.cu",
                           "mafrixraytracing_tpu/ops/intersect_pallas.py:356"),
               "anyhit": ("mafrixraytracing_torch/csrc/intersect.cu",
                          "mafrixraytracing_tpu/ops/intersect_pallas.py:450"),
               "unpack": ("mafrixraytracing_torch/csrc/unpack.cu",
                          "mafrixraytracing_tpu/ops/unpack_pallas.py:43")}
    kernels = [dict(name=k, route="cuda", source=sources[k][0],
                    replaces=sources[k][1], launches=launches[k], **records[k])
               for k in ("closest", "anyhit", "unpack")]
    print(json.dumps({"kernels": kernels}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
