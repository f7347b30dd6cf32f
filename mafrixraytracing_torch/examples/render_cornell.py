"""Render the Cornell box to PNG with progressive accumulation: one sample a
pixel a pass into a `FilmState`, the mean written every `--dump-every`
passes, or served live with `--preview-port` (0: a port the OS picks).

Port of `examples/render_cornell.py` (the reference's `DoRayTrace4` demo,
`RenderTest/Sample/RayTracing4.fs:7-80`, with an ImGui window, here replaced
by PNG dumps and `film.preview.LivePreview`).

    python -m mafrixraytracing_torch.examples.render_cornell [out.png]
        [--spp N] [--size WxH] [--dump-every N] [--preview-port PORT] [--cpu]

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
from mafrixraytracing_torch.film.film import FilmState
from mafrixraytracing_torch.film.image import write_png
from mafrixraytracing_torch.film.preview import LivePreview
from mafrixraytracing_torch.integrator.path import PathTracerConfig, render_sample_batch
from mafrixraytracing_torch.scene.builtin import cornell_box
from mafrixraytracing_torch.scene.compiler import compile_scene


def positive_int(text: str) -> int:
    """A count of at least 1; an argparse error for anything else."""
    try:
        n = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected an integer, got {text!r}") from None
    if n <= 0:
        raise argparse.ArgumentTypeError(f"must be positive, got {text!r}")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="cornell.png")
    ap.add_argument("--spp", type=positive_int, default=64)
    ap.add_argument("--size", type=parse_size, default=(300, 300), help="WxH")
    ap.add_argument("--dump-every", type=positive_int, default=16)
    ap.add_argument("--preview-port", type=int, default=None,
                    help="serve a live auto-refreshing preview at "
                         "http://127.0.0.1:PORT/ while rendering")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    W, H = args.size
    dev = resolve("cpu" if args.cpu else None)

    cs = compile_scene(cornell_box(width=W, height=H), device=dev)
    config = PathTracerConfig()
    key = rng.root_key(0, dev)
    film = FilmState.create(H, W, device=dev)
    preview = None
    if args.preview_port is not None:
        preview = LivePreview(args.out, http_port=args.preview_port)
        print(f"live preview: http://127.0.0.1:{preview.port}/")
    try:
        t0 = time.perf_counter()
        for s in range(args.spp):
            with torch.no_grad():
                frame = render_sample_batch(cs.scene, cs.camera, W, H, s, key, config)
            film = film.add_frame(frame.reshape(H, W, 3))
            if preview is not None:
                preview.update(film.to_bytes())
            if (s + 1) % args.dump_every == 0 or s + 1 == args.spp:
                if preview is None:
                    write_png(args.out, film.to_bytes())
                rate = W * H * (s + 1) / (time.perf_counter() - t0)
                print(f"spp {s + 1}/{args.spp}  {rate / 1e6:.2f} Mpaths/s  -> {args.out}")
    finally:
        if preview is not None:
            preview.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
