"""Profile the benchmark's configuration on one CUDA card with torch.profiler.

    python -m mafrixraytracing_torch.profile_bench [--fit] [--fused] [TRACE_DIR]

Calibrates and warms up the benchmark's 256x256 x 64 spp, depth 5 cell
(Cornell, or with BENCH_OBJ=<path> the `mesh_scene` around that OBJ file;
`profile_scene(spec)` takes any `SceneSpec`), then profiles one forward
frame (no grad) and one forward + backward, and with `--fit` (or
BENCH_FIT=1) one whole train step of `opt.inverse` at 8 spp as
`bench.run_fit` times it. For each it prints the wall
time, the device-busy time (the sum of kernel durations on the card), the
idle share, the number of kernel launches, the kernels with the most
device time, the scatter-add's (J's) wrapper launches and the device
time of its two passes (its sort is not told apart from the others'), and
the device time and launches of each search kernel that ran (A, B, D-I, K,
by the kernel's function name). With
TRACE_DIR, it also writes Chrome traces there; the port's spans
(`utils.trace`) are on in the profiled region, so the traces show each
launch under its layer (`mfx.render`, `mfx.bounce`, `mfx.rng`,
`mfx.search`, `mfx.refresh`, `mfx.optimizer`). `--fused` (or BENCH_FUSED=1)
profiles the fused-cull searches (`ops.intersect.FUSED_CULL`) in place of the
list walks fed by the cull kernel K.
"""
from __future__ import annotations

import os
import re
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mafrixraytracing_torch import bench
from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.integrator import path as P
from mafrixraytracing_torch.ops import cuda
from mafrixraytracing_torch.scene.builtin import cornell_box
from mafrixraytracing_torch.scene.compiler import compile_scene
from mafrixraytracing_torch.utils import trace

W = H = 256
SPP = 64
DEPTH = 5
# the search kernels by their CUDA function names (ops/intersect.py)
SEARCH_KERNELS = {"closest_kernel": "A", "anyhit_kernel": "B",
                  "closest_super_kernel": "D", "anyhit_super_kernel": "E",
                  "fused_closest_kernel": "F", "fused_anyhit_kernel": "G",
                  "fused_closest_super_kernel": "H", "fused_anyhit_super_kernel": "I",
                  "cull_kernel": "K"}


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total", None)
                 or getattr(evt, "cuda_time_total", 0.0))


def _report(label: str, prof, wall_s: float, top: int = 15) -> None:
    # the spans' own marks on the device's timeline are no work of the card
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(trace.PREFIX)]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"{label}: wall {wall_s:.4f} s, device busy {busy_us / 1e6:.4f} s, "
          f"idle share {1 - busy_us / 1e6 / wall_s:.3f}, "
          f"kernel launches {len(kernels)}")
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    for name, (us, n) in rows:
        print(f"  {us / 1e3:10.3f} ms {100 * us / max(busy_us, 1):5.1f}% "
              f"{n:7d}x  {name[:90]}")
    j_us, j_n = _summed(by_name, r"scatter_chunk|scatter_combine")
    print(f"  J (scatter-add): {cuda.LAUNCHES['scatter']} wrapper launches, "
          f"{j_n} pass kernels, {j_us / 1e3:.3f} ms device time in its passes")
    searches = []
    for fn, letter in SEARCH_KERNELS.items():
        us, n = _summed(by_name, rf"\b{fn}\(")
        if n:
            searches.append(f"{letter} {us / 1e3:.3f} ms in {n}")
    if searches:
        print("  search kernels (device time, launches): " + ", ".join(searches))


def _summed(by_name: dict, pattern: str) -> tuple:
    """(device us, launches) of the kernels whose name matches `pattern`."""
    found = [v for name, v in by_name.items() if re.search(pattern, name)]
    return sum(us for us, _ in found), sum(n for _, n in found)


def profile_scene(spec=None, trace_dir=None, fit=False) -> None:
    """Profile one forward frame and one forward + backward of `spec`
    (default: Cornell) at the benchmark's configuration; with `fit`, also
    one train step at 8 spp."""
    cs = compile_scene(spec if spec is not None else cornell_box(W, H))
    dev = cs.scene.tri_v0.device
    config, _ = bench.calibrated_config(cs.scene, cs.camera, W, H, DEPTH)
    bench.fwd_bwd(cs.scene, cs.camera, W, H, SPP, 0, config)  # warm-up
    torch.cuda.synchronize()

    def forward():
        with torch.no_grad():
            P.render_image(cs.scene, cs.camera, W, H, SPP, rng.root_key(1, dev),
                           config)

    def fwd_bwd():
        bench.fwd_bwd(cs.scene, cs.camera, W, H, SPP, 2, config)

    runs = [("forward", forward), ("fwd+bwd", fwd_bwd)]
    if fit:
        runs.append(("train step", _train_step(cs, config, dev)))
    for label, fn in runs:
        cuda.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trace.enable()
            try:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                trace.disable()
        _report(label, prof, wall)
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(trace_dir, f"{label.replace(' ', '_')}.json"))


def _train_step(cs, config, dev, spp=8):
    """A warmed-up train step of `bench.FIT_PARAMS` as a thunk."""
    from mafrixraytracing_torch.opt import inverse

    with torch.no_grad():
        target = P.render_image(cs.scene, cs.camera, W, H, spp,
                                rng.root_key(0, dev), config)
    params = {n: getattr(cs.scene, n).detach().clone().requires_grad_()
              for n in bench.FIT_PARAMS}
    step = inverse.make_train_step(
        torch.optim.Adam(list(params.values()), lr=1e-3), spp, config,
        smooth_geometry=4)
    keys = rng.split(rng.root_key(1, dev), 2)
    step(params, cs.scene, cs.camera, target, keys[0])  # warm-up
    return lambda: float(step(params, cs.scene, cs.camera, target, keys[1])[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_bench: no CUDA device", file=sys.stderr)
        return 1
    print(bench.device_info()["nvidia_smi"])
    print(f"fused_cull={bench.fused_from_args(sys.argv[1:])}")
    spec, _ = bench.spec_from_env(W, H)
    args = [a for a in sys.argv[1:] if a not in ("--fit", "--fused")]
    fit = "--fit" in sys.argv[1:] or os.environ.get("BENCH_FIT") == "1"
    profile_scene(spec, args[0] if args else None, fit=fit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
