"""Rasterizer demo: a textured OBJ on a turntable through the fixed-function
pipeline (`raster.pipeline`), written as a PNG.

Port of `examples/rasterize_spot.py` (the reference's `DrawCarWithTexture`
sample, `RenderTest/Sample/DrawWithTexture.fs:14-43`). The mesh is `--obj`,
else spot where the reference's assets are present, else a seeded displaced
sphere written to the temp directory; the texture is `--texture`, else
spot's, else a checkerboard. Nothing is fetched.

    python -m mafrixraytracing_torch.examples.rasterize [out.png] [--size WxH]
        [--angle DEG] [--obj PATH] [--texture PATH] [--cpu]

Runs on the current CUDA card, or on the CPU with `--cpu`.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from mafrixraytracing_torch.core import transform as T
from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.film.image import write_png
from mafrixraytracing_torch.io.obj import load_obj
from mafrixraytracing_torch.materials.texture import checker_texture
from mafrixraytracing_torch.raster import pipeline as R
from mafrixraytracing_torch.scene import assets

LIGHTS = (R.RasterLight("ambient", (0.35, 0.35, 0.35)),
          R.RasterLight("directional", (0.9, 0.9, 0.9), (-0.3, -1.0, -0.6)))
BACKGROUND = (0.08, 0.09, 0.12)
SPOT_TEXTURE = os.path.join(assets.REFERENCE_ASSETS, "spot", "spot_texture.png")


def parse_size(text: str) -> tuple[int, int]:
    """'WxH' -> (W, H); an argparse error for anything else."""
    try:
        w, h = (int(x) for x in text.split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected WxH, e.g. 512x512, got {text!r}") from None
    if w <= 0 or h <= 0:
        raise argparse.ArgumentTypeError(f"the size must be positive, got {text!r}")
    return w, h


def mesh_arrays(obj_path: str):
    """(vertices, faces, normals, uvs) of an OBJ as numpy arrays: per-vertex
    normals are the area-weighted sums of the face normals; the per-corner
    uvs are moved onto the vertices, the last corner of a vertex winning."""
    mesh = load_obj(obj_path).mesh()
    v = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int32)

    fv = v[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    normals = np.zeros_like(v)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)

    uvs = np.zeros((v.shape[0], 2), np.float32)
    if mesh.uvs is not None and mesh.face_uvs is not None:
        src = np.asarray(mesh.uvs, np.float32)
        fu = np.asarray(mesh.face_uvs, np.int64)
        for c in range(3):
            uvs[faces[:, c]] = src[fu[:, c]]
    return v, faces, normals, uvs


def default_obj() -> str:
    """Spot's OBJ where present, else the seeded sphere of `profile_walk`,
    written to the temp directory."""
    if os.path.exists(assets.SPOT_OBJ):
        return assets.SPOT_OBJ
    from mafrixraytracing_torch.profile_walk import write_sphere_obj

    path = os.path.join(tempfile.gettempdir(), "mafrix_torch_raster_sphere.obj")
    part = f"{path}.{os.getpid()}.part"
    write_sphere_obj(part)
    os.replace(part, path)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "spot_raster.png"))
    ap.add_argument("--size", type=parse_size, default=(512, 512), help="WxH")
    ap.add_argument("--angle", type=float, default=150.0,
                    help="turntable angle about y, degrees")
    ap.add_argument("--obj", help="the mesh (default: spot, else a seeded sphere)")
    ap.add_argument("--texture", help="the texture (default: spot's, else a checker)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    W, H = args.size
    dev = resolve("cpu" if args.cpu else None)

    tex = assets.load_texture(args.texture or SPOT_TEXTURE)
    if tex is None:
        if args.texture:
            ap.error(f"cannot read the texture {args.texture}")
        tex = checker_texture()

    obj = args.obj or default_obj()
    v, faces, normals, uvs = (torch.as_tensor(a, device=dev) for a in mesh_arrays(obj))
    model = T.compose(T.rotation_y(args.angle, device=dev))
    view = R.look_at((0.0, 0.3, 2.2), (0.0, 0.0, 0.0), device=dev)
    proj = R.perspective(40.0, W / H, near=0.2, far=20.0, device=dev)
    with torch.no_grad():
        img = R.rasterize(v, faces, normals, uvs, model, view, proj,
                          torch.as_tensor(tex, device=dev), W, H, lights=LIGHTS,
                          perspective_correct=True, background=BACKGROUND)
    write_png(args.out, (torch.clamp(img, 0.0, 1.0) * 255.99).to(torch.uint8))
    print(f"wrote {args.out} ({W}x{H}, angle {args.angle}, {os.path.basename(obj)}, "
          f"{faces.shape[0]} faces, on {dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
