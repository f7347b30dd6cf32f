"""Benchmark of the PyTorch port: rays/s forward + backward on one CUDA card.

Prints ONE JSON line with the fields of the JAX package's `bench.py`:
{"metric", "value", "unit", "vs_baseline", "detail"}; `detail` adds the
package, the device's name and its power limit. There is no baseline for
the port yet, so `vs_baseline` is null.

Ray accounting: a "ray" is one traced query, closest-hit or shadow. The
query count is measured, not bounded, by `trace_stats` at 1 spp with the
final compaction schedule, then scaled by spp; the timed run renders and
takes the gradient of the mean image with respect to material albedo, light
radiance and triangle vertices.

With `--fit` (or BENCH_FIT=1) it times whole train steps of `opt.inverse`
instead (render, loss, backward, gradient smoothing, Adam; 8 spp a step
unless BENCH_SPP says otherwise) and prints the same JSON line with the
metric `seconds_per_train_step`; `detail` keeps its keys and gains the
parameters, the losses, `rays_per_s_fwd_bwd` by the same accounting and the
seconds it took to construct the optimizer.

Scenes: Cornell by default; `run(spec=...)` times any `SceneSpec`, and
BENCH_OBJ=<path> builds one around an OBJ file with `scene.assets.mesh_scene`.
Env knobs: BENCH_WIDTH/HEIGHT (256), BENCH_SPP (64), BENCH_DEPTH (5),
BENCH_ITERS (3), BENCH_WAVEFRONT (2^19), BENCH_COMPACT (1), BENCH_HEADROOM
(1.12), BENCH_OBJ (none), BENCH_FIT (0).

Run: python -m mafrixraytracing_torch.bench [--fit]   (needs a CUDA device)
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.integrator import path as P
from mafrixraytracing_torch.scene.builtin import cornell_box
from mafrixraytracing_torch.scene.compiler import compile_scene


def device_info() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {"name": torch.cuda.get_device_name(0),
                "power_limit": "not measured", "nvidia_smi": None}
    line = out.strip().splitlines()[0]
    name, _, limit = line.partition(",")
    return {"name": name.strip(), "power_limit": limit.strip(),
            "nvidia_smi": line}


def count_queries_per_sample(scene, camera, width, height, config,
                             profile=False):
    """Measured closest-hit + shadow queries of one 1-spp pass (and the
    per-bounce live fraction with `profile`)."""
    dev = scene.tri_v0.device
    px, py = P.make_pixel_uv(width, height, dev)
    keys = rng.pixel_keys(rng.root_key(123, dev), px.shape[0])
    o, d = camera.get_rays((px + 0.5) / width, (py + 0.5) / height)
    out = P.trace_stats(scene, o, d, keys, config, return_profile=profile)
    if profile:
        q, prof = out
        return float(q), [float(p) for p in prof]
    return float(out)


def calibrated_config(scene, camera, width, height, depth):
    """Measure the survival profile and size the compaction buckets with
    headroom (x1.12 + 0.01), so the population-control kill stays a rare
    safety valve. BENCH_COMPACT=0 disables compaction."""
    wavefront = int(os.environ.get("BENCH_WAVEFRONT", str(1 << 19)))
    base = P.PathTracerConfig(max_depth=depth, wavefront=wavefront)
    _, prof = count_queries_per_sample(scene, camera, width, height, base,
                                       profile=True)
    if os.environ.get("BENCH_COMPACT", "1") != "1" or depth < 2:
        return base, prof
    headroom = float(os.environ.get("BENCH_HEADROOM", "1.12"))
    sched = [1.0] + [min(1.0, p * headroom + 0.01) for p in prof[1:]]
    return dataclasses.replace(base, compact=tuple(sched)), prof


def fwd_bwd(scene, camera, width, height, spp, seed, config):
    """Render and back-propagate the mean image to (albedo, radiance,
    tri_v0). Returns the image and the three gradients."""
    leaves = [scene.mat_albedo.detach().clone().requires_grad_(),
              scene.light_radiance.detach().clone().requires_grad_(),
              scene.tri_v0.detach().clone().requires_grad_()]
    s = scene.replace(mat_albedo=leaves[0], light_radiance=leaves[1],
                      tri_v0=leaves[2])
    img = P.render_image(s, camera, width, height, spp,
                         rng.root_key(seed, scene.tri_v0.device), config)
    img.mean().backward()
    return img.detach(), [x.grad for x in leaves]


FIT_PARAMS = ("mat_albedo", "light_radiance", "mesh_vertices")


def _setup(width, height, depth, spec, scene_name):
    """Compile, calibrate and count: (scene, camera, config, name, the
    `detail` fields every record shares)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    if spec is None:
        spec, scene_name = cornell_box(width=width, height=height), "cornell"
    cs = compile_scene(spec)
    scene, camera = cs.scene, cs.camera
    config, survival = calibrated_config(scene, camera, width, height, depth)
    queries_per_spp = count_queries_per_sample(scene, camera, width, height,
                                               config)
    info = device_info()
    detail = {
        "package": "mafrixraytracing_torch",
        "scene": scene_name or "custom",
        "triangles": int(scene.tri_mask.sum()),
        "clusters": scene.cluster_min.shape[0],
        "width": width,
        "height": height,
        "depth": depth,
        "queries_per_spp": queries_per_spp,
        "backend": "cuda",
        "device": info["name"],
        "power_limit": info["power_limit"],
        "compact": list(config.compact),
        "survival": [round(s, 4) for s in survival],
    }
    return scene, camera, config, detail


def run(width=256, height=256, spp=64, depth=5, iters=3, spec=None,
        scene_name=None) -> tuple[dict, list]:
    """Calibrate, count, warm up, then time `iters` fwd+bwd iterations of
    `spec` (a `SceneSpec` whose camera has the aspect width / height;
    default: Cornell). Returns (the JSON record, the last iteration's
    gradients)."""
    scene, camera, config, detail = _setup(width, height, depth, spec, scene_name)
    fwd_bwd(scene, camera, width, height, spp, 0, config)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        _, grads = fwd_bwd(scene, camera, width, height, spp, i + 1, config)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    record = {
        "metric": "rays_per_s_per_chip_fwd_bwd",
        "value": detail["queries_per_spp"] * spp / dt,
        "unit": "rays/s",
        "vs_baseline": None,
        "detail": {**detail, "spp": spp, "seconds_per_iter": dt},
    }
    return record, grads


def run_fit(width=256, height=256, spp=8, depth=5, iters=3, spec=None,
            scene_name=None, lr=1e-3, smooth_geometry=4) -> dict:
    """Time `iters` whole train steps of `opt.inverse` on `spec` (after one
    warm-up step): the target is a render of the scene itself, the parameters
    are `FIT_PARAMS`, each step ends with the loss read back as `fit` does.
    The scene starts at its target, so `lr` is small: the steps are timed,
    and the noise they follow should not take the scene apart. Returns the
    JSON record."""
    from mafrixraytracing_torch.opt import inverse

    scene, camera, config, detail = _setup(width, height, depth, spec, scene_name)
    dev = scene.tri_v0.device
    with torch.no_grad():
        target = P.render_image(scene, camera, width, height, spp,
                                rng.root_key(0, dev), config)
    params = {n: getattr(scene, n).detach().clone().requires_grad_()
              for n in FIT_PARAMS}
    t_opt = time.perf_counter()   # the first optimizer of a process is slow
    optimizer = torch.optim.Adam(list(params.values()), lr=lr)
    optimizer_setup = time.perf_counter() - t_opt
    step = inverse.make_train_step(optimizer, spp, config,
                                   smooth_geometry=smooth_geometry)
    key, losses = rng.root_key(1, dev), []
    for i in range(iters + 1):
        if i == 1:      # step 0 was the warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        key, sub = rng.split(key)
        loss, _ = step(params, scene, camera, target, sub)
        losses.append(float(loss))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    return {
        "metric": "seconds_per_train_step",
        "value": dt,
        "unit": "s",
        "vs_baseline": None,
        "detail": {**detail, "spp": spp, "seconds_per_iter": dt,
                   "rays_per_s_fwd_bwd": detail["queries_per_spp"] * spp / dt,
                   "optimizer_setup_seconds": optimizer_setup,
                   "params": list(FIT_PARAMS), "losses": losses},
    }


def spec_from_env(width, height):
    """(SceneSpec, name) for BENCH_OBJ=<path>: `mesh_scene` around that OBJ
    file; (None, None), which means Cornell, when the variable is unset."""
    obj = os.environ.get("BENCH_OBJ")
    if not obj:
        return None, None
    from mafrixraytracing_torch.scene.assets import mesh_scene

    return mesh_scene(obj, width, height), os.path.basename(obj)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    width = int(os.environ.get("BENCH_WIDTH", 256))
    height = int(os.environ.get("BENCH_HEIGHT", 256))
    spec, name = spec_from_env(width, height)
    fit = "--fit" in sys.argv[1:] or os.environ.get("BENCH_FIT") == "1"
    kw = dict(width=width, height=height,
              spp=int(os.environ.get("BENCH_SPP", 8 if fit else 64)),
              depth=int(os.environ.get("BENCH_DEPTH", 5)),
              iters=int(os.environ.get("BENCH_ITERS", 3)),
              spec=spec, scene_name=name)
    record = run_fit(**kw) if fit else run(**kw)[0]
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
