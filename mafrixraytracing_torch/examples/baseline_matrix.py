"""Render the forward-correctness matrix of `BASELINE.md` end to end and keep
each frame as a PNG beside a JSON log of the runs.

Port of `examples/baseline_matrix.py`. The rows: Cornell 256^2 at 16 spp;
Cube 512^2 at 64 spp and Renault 12TL 1024^2 at 256 spp in 16 passes where
the reference's assets are present (`--quick` drops Renault). Where they
are absent, `--obj PATH` takes Renault's place: `mesh_scene(PATH)` at
Renault's configuration, under the name `mesh`. Each row prints one JSON
record (wall seconds, mean radiance, finiteness, the device's name and
power limit); all of them go to `RESULTS.json` in `--out-dir`.

    python -m mafrixraytracing_torch.examples.baseline_matrix [--quick]
        [--obj PATH] [--out-dir DIR] [--cpu]

Runs on the current CUDA card, or on the CPU with `--cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.core.device import device_fields, resolve
from mafrixraytracing_torch.film.image import write_png
from mafrixraytracing_torch.film.tonemap import to_bytes, tonemap
from mafrixraytracing_torch.integrator.path import PathTracerConfig, render_image
from mafrixraytracing_torch.scene import assets
from mafrixraytracing_torch.scene.builtin import cornell_box
from mafrixraytracing_torch.scene.compiler import compile_scene

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "artifacts_torch")
# (width, height, spp, passes) of each row
CORNELL = (256, 256, 16, 1)
CUBE = (512, 512, 64, 1)
RENAULT = (1024, 1024, 256, 16)


def frame(cs, w, h, spp, depth=5, passes=1):
    """The w x h frame of `spp` samples in all on the scene's device: with
    `passes` > 1 the mean of `passes` renders of spp / passes samples, pass p
    under the seed 1 + p (the Film design: each launch stays short)."""
    cfg = PathTracerConfig(max_depth=depth)
    dev = cs.scene.tri_v0.device
    acc = None
    with torch.no_grad():
        for p in range(passes):
            img = render_image(cs.scene, cs.camera, w, h, spp // passes,
                               rng.root_key(1 + p, dev), cfg)
            acc = img if acc is None else acc + img
    return acc / passes


def run(name, cs, w, h, spp, depth=5, passes=1, out_dir=OUT_DIR):
    """Render `frame(...)`, timed to the end of its work on the device;
    write its tonemapped PNG to `out_dir`, print the record and return it."""
    dev = cs.scene.tri_v0.device
    t0 = time.perf_counter()
    img = frame(cs, w, h, spp, depth, passes)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    path = os.path.join(out_dir, f"{name}_{w}x{h}_spp{spp}.png")
    write_png(path, to_bytes(tonemap(img)))
    rec = {"scene": name, "width": w, "height": h, "spp": spp, "depth": depth,
           "seconds": dt, "mean_radiance": float(img.mean()),
           "finite": bool(torch.isfinite(img).all()), "png": os.path.basename(path),
           **device_fields(dev)}
    print(json.dumps(rec))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="drop the Renault-size row")
    ap.add_argument("--obj", help="the mesh that takes Renault's place where the "
                                  "reference's assets are absent")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dev = resolve("cpu" if args.cpu else None)
    os.makedirs(args.out_dir, exist_ok=True)

    def row(name, spec, size):
        w, h, spp, passes = size
        return run(name, compile_scene(spec, device=dev), w, h, spp, passes=passes,
                   out_dir=args.out_dir)

    w, h = CORNELL[:2]
    results = [row("cornell", cornell_box(w, h), CORNELL)]
    if assets.have_reference_assets():
        results.append(row("cube", assets.cube_scene(*CUBE[:2]), CUBE))
        if not args.quick:
            results.append(row("renault", assets.renault_scene(*RENAULT[:2]), RENAULT))
    elif args.obj and not args.quick:
        results.append(row("mesh", assets.mesh_scene(args.obj, *RENAULT[:2]), RENAULT))
    with open(os.path.join(args.out_dir, "RESULTS.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {len(results)} artifacts -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
