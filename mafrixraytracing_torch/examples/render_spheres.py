"""Render the three-sphere hero shot (lambert / metal / dielectric on a ground
sphere, under an area light, against a flat sky) with progressive
accumulation: one sample a pixel a pass into a `FilmState`, the mean written
every `--dump-every` passes.

Port of `examples/render_spheres.py` (the reference's `DoRayTrace` sample,
`RenderTest/Sample/RayTracing.fs:417-474`, whose render loop is dead code
there).

    python -m mafrixraytracing_torch.examples.render_spheres [out.png]
        [--spp N] [--size WxH] [--depth N] [--dump-every N] [--cpu]

Runs on the current CUDA card, or on the CPU with `--cpu`.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.examples.rasterize import parse_size
from mafrixraytracing_torch.examples.render_cornell import positive_int
from mafrixraytracing_torch.film.film import FilmState
from mafrixraytracing_torch.film.image import write_png
from mafrixraytracing_torch.integrator.path import PathTracerConfig, render_sample_batch
from mafrixraytracing_torch.scene.builtin import sphere_triad
from mafrixraytracing_torch.scene.compiler import compile_scene

SKY = (0.5, 0.7, 1.0)   # the sample's gradient miss shader, flat here
DEPTH = 8
SEED = 0


def build(width: int, height: int, device=None):
    """(scene, camera): `sphere_triad` at width x height with the sky as its
    background, on `device` (None: the CUDA card)."""
    cs = compile_scene(sphere_triad(width=width, height=height), device=device)
    scene = cs.scene
    sky = torch.tensor(SKY, dtype=torch.float32, device=scene.background.device)
    return scene.replace(background=sky), cs.camera


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="spheres.png")
    ap.add_argument("--spp", type=positive_int, default=64)
    ap.add_argument("--size", type=parse_size, default=(400, 200), help="WxH")
    ap.add_argument("--depth", type=positive_int, default=DEPTH)
    ap.add_argument("--dump-every", type=positive_int, default=16)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    W, H = args.size
    dev = resolve("cpu" if args.cpu else None)

    scene, camera = build(W, H, dev)
    config = PathTracerConfig(max_depth=args.depth)
    key = rng.root_key(SEED, dev)
    film = FilmState.create(H, W, device=dev)
    t0 = time.perf_counter()
    for s in range(args.spp):
        with torch.no_grad():
            frame = render_sample_batch(scene, camera, W, H, s, key, config)
        film = film.add_frame(frame.reshape(H, W, 3))
        if (s + 1) % args.dump_every == 0 or s + 1 == args.spp:
            write_png(args.out, film.to_bytes())
            rate = W * H * (s + 1) / (time.perf_counter() - t0)
            print(f"spp {s + 1}/{args.spp}  {rate / 1e6:.2f} Mpaths/s  -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
