"""Inverse-rendering demo: recover scene parameters from target renders by
gradient descent through the path tracer.

Port of `examples/fit_inverse.py`, with its three fits, sizes, steps,
learning rates, sample counts and keys:
  1. material: the model's albedo, perturbed to green, recovered;
  2. geometry: a floor displaced 0.25 upward, pulled back by pixel
     gradients;
  3. mesh vertices: the ground's shared vertices (`scene.mesh_vertices`)
     displaced 0.25 upward and pulled back, with a checkpoint in a fresh
     temporary directory, so that a rerun never resumes an old fit.

Vertex gradients are reparameterized with detached visibility, so
silhouette and shadow-edge terms carry no gradient: displacements that the
shading observes (the ground's height under the light, the floor, albedo)
are recoverable, a rigid translation of the model is not (see the JAX
script's docstring for the finite-difference study).

The model is `--obj PATH`; without it spot where the reference's assets are
present, else a seeded displaced sphere of spot's 5,856 faces written to a
temporary directory, framed by `scene.assets.mesh_scene`. The images are
rendered with `parallel.render.render_image_sharded` and the fits run
`opt.inverse.fit` on the mesh of `parallel.launch`: a world of one in a
plain run, every rank under `torchrun`, where only rank 0 prints and writes
the PNGs.

    python -m mafrixraytracing_torch.examples.fit_inverse [out_prefix]
        [--obj PATH] [--cpu]
    torchrun --nproc-per-node N -m mafrixraytracing_torch.examples.fit_inverse

Writes <prefix>_{albedo,geo,verts}_{target,start,fitted}.png and prints each
fit's losses, its parameter error before and after, and its set-up time
(the optimizer's construction and the checkpoint's load). Runs on the
current CUDA card, or on the CPU with `--cpu`.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.film.image import write_png
from mafrixraytracing_torch.film.tonemap import to_bytes, tonemap
from mafrixraytracing_torch.integrator.path import PathTracerConfig
from mafrixraytracing_torch.opt import inverse
from mafrixraytracing_torch.parallel import launch
from mafrixraytracing_torch.parallel.render import render_image_sharded
from mafrixraytracing_torch.profile_walk import write_sphere_obj
from mafrixraytracing_torch.scene import assets
from mafrixraytracing_torch.scene import spec as S
from mafrixraytracing_torch.scene.compiler import compile_scene

CONFIG = PathTracerConfig(max_depth=2, rr_enable=False)
GROUND = 1                  # `mesh_scene`'s ground material
SPOT_FACES = 5856
STAND_IN = (48, 61)         # rows and columns of quads: 2 * 48 * 61 = spot's faces


def stand_in_obj(directory: str) -> str:
    """A seeded displaced sphere of SPOT_FACES faces, written as an OBJ file
    to `directory`; returns its path."""
    path = os.path.join(directory, f"sphere{SPOT_FACES}.obj")
    write_sphere_obj(path, STAND_IN[0], seed=2026, cols=STAND_IN[1])
    return path


class Fits:
    """What the three fits share: the output prefix (None: no PNGs), the ray
    mesh, the model's OBJ file and the device."""

    def __init__(self, prefix, mesh, obj, device):
        self.prefix, self.mesh, self.obj = prefix, mesh, obj
        self.device = torch.device(device)
        self.lead = mesh.rank == 0

    def say(self, text: str) -> None:
        if self.lead:
            print(text, flush=True)

    def render(self, scene, camera, W, H, spp, seed):
        return render_image_sharded(scene, camera, self.mesh, W, H, spp,
                                    rng.root_key(seed, self.device), CONFIG)

    def save(self, name, img) -> None:
        if self.prefix is not None and self.lead:
            path = f"{self.prefix}_{name}.png"
            write_png(path, to_bytes(tonemap(img)))
            self.say(f"  wrote {path}")

    def fit(self, bad, camera, target, names, **kw):
        """`inverse.fit` on the mesh -> (fitted, losses, set-up seconds)."""
        timings = {}
        fitted, losses = inverse.fit(bad, camera, target, names, config=CONFIG,
                                     mesh=self.mesh, timings=timings, **kw)
        return fitted, losses, timings["setup_s"]

    def report(self, losses, what, before, after, setup, t0) -> dict:
        self.say(f"  loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
        self.say(f"  {what}: {before:.4f} -> {after:.4f}")
        seconds = time.perf_counter() - t0
        self.say(f"  set-up {setup:.2f} s (the optimizer's construction and the "
                 f"checkpoint's load), the fit with its renders {seconds:.2f} s")
        return {"losses": losses, "error": (before, after), "setup_s": setup,
                "seconds": seconds}


def fit_albedo(f: Fits, W=48, H=48, steps=40) -> dict:
    f.say("[1/3] material recovery: the model's albedo")
    t0 = time.perf_counter()
    cs = compile_scene(assets.mesh_scene(f.obj, W, H), device=f.device)
    scene, camera = cs.scene, cs.camera
    target = f.render(scene, camera, W, H, 16, 7)
    f.save("albedo_target", target)

    true0 = scene.mat_albedo[0].clone()
    pert = scene.mat_albedo.clone()
    pert[0] = torch.tensor([0.2, 0.8, 0.2])
    bad = scene.replace(mat_albedo=pert)
    f.save("albedo_start", f.render(bad, camera, W, H, 16, 8))

    fitted, losses, setup = f.fit(bad, camera, target, ("mat_albedo",), steps=steps,
                                  lr=5e-2, spp=8, key=rng.root_key(11, f.device),
                                  log_every=10)
    f.save("albedo_fitted", f.render(fitted, camera, W, H, 16, 9))
    f0 = fitted.mat_albedo[0]
    f.say(f"  albedo: true {true0.cpu().numpy().round(3)}  start "
          f"{pert[0].cpu().numpy().round(3)}  fitted {f0.cpu().numpy().round(3)}")
    return f.report(losses, "albedo error", float(torch.linalg.norm(pert[0] - true0)),
                    float(torch.linalg.norm(f0 - true0)), setup, t0)


def floor_spec(W: int, H: int) -> S.SceneSpec:
    """A 4 x 4 floor under a hidden square light, seen from above at an angle."""
    floor = S.make_rect_mesh((-2, 0, 2), (2, 0, 2), (2, 0, -2), (-2, 0, -2))
    light = S.make_rect_mesh((-0.6, 2.0, -0.6), (0.6, 2.0, -0.6),
                             (0.6, 2.0, 0.6), (-0.6, 2.0, 0.6))
    return S.SceneSpec(
        camera=S.CameraSpec(position=(0.0, 1.2, 3.0), direction=(0.0, -0.3, -1.0),
                            fov=60.0, fov_convention="standard"),
        materials=[S.MaterialSpec(albedo=(0.7, 0.7, 0.7))],
        shapes=[S.ShapeSpec(floor, 0)],
        area_lights=[S.AreaLightSpec(light, radiance=(12.0,) * 3, visible=False)],
        film=S.FilmSpec(width=W, height=H),
    )


def fit_geometry(f: Fits, W=32, H=32, steps=60) -> dict:
    f.say("[2/3] geometry recovery: displaced floor")
    t0 = time.perf_counter()
    cs = compile_scene(floor_spec(W, H), device=f.device)
    scene, camera = cs.scene, cs.camera
    target = f.render(scene, camera, W, H, 32, 7)
    f.save("geo_target", target)

    true_v0 = scene.tri_v0
    mask = scene.tri_mask
    up = torch.tensor([0.0, 0.25, 0.0], device=f.device)
    pert_v0 = true_v0 + torch.where(mask[:, None], up, torch.zeros_like(up))
    # the cluster bounds follow the moved floor (the JAX script keeps the old
    # ones for its start image; the fit refreshes them at every step in both)
    bad = inverse.apply_params(scene, {"tri_v0": pert_v0})
    f.save("geo_start", f.render(bad, camera, W, H, 32, 8))

    fitted, losses, setup = f.fit(bad, camera, target, ("tri_v0",), steps=steps,
                                  lr=3e-2, spp=8, key=rng.root_key(11, f.device),
                                  log_every=15)
    f.save("geo_fitted", f.render(fitted, camera, W, H, 32, 9))
    d_b = torch.linalg.norm(pert_v0 - true_v0, dim=1)[mask].mean()
    d_a = torch.linalg.norm(fitted.tri_v0 - true_v0, dim=1)[mask].mean()
    return f.report(losses, "mean vertex error", float(d_b), float(d_a), setup, t0)


def ground_rows(scene) -> np.ndarray:
    """The JAX script's selection of the ground's shared vertices: the rows
    that a live face uses at the lowest y. Checked against the rows of the
    ground's own faces (material GROUND): `compile_scene` must have put the
    ground's four corners into `mesh_vertices`, and the model must not reach
    down to the ground's height."""
    mv = scene.mesh_vertices.detach().cpu().numpy()
    mask = scene.tri_mask.cpu().numpy()
    face_vi = scene.tri_face_vi.cpu().numpy()
    used = np.unique(face_vi[mask])
    rows = used[np.isin(used, np.nonzero(
        np.abs(mv[:, 1] - mv[used, 1].min()) < 1e-5)[0])]
    ground = np.unique(face_vi[mask & (scene.tri_mat.cpu().numpy() == GROUND)])
    if rows.size != 4 or not np.array_equal(rows, ground):
        raise RuntimeError(f"the lowest used rows {rows.tolist()} are not the ground's "
                           f"four corners {ground.tolist()}")
    return rows


def fresh_checkpoint(mesh) -> str:
    """A checkpoint path in a new temporary directory, the same on every rank."""
    path = [os.path.join(tempfile.mkdtemp(prefix="mafrix_fit_"), "verts_ck")
            if mesh.rank == 0 else None]
    if mesh.group is not None:
        dist.broadcast_object_list(path, src=0, group=mesh.group)
    return path[0]


def fit_vertices(f: Fits, W=48, H=48, steps=80) -> dict:
    f.say("[3/3] vertex recovery: the ground's shared vertices (mesh_vertices)")
    t0 = time.perf_counter()
    cs = compile_scene(assets.mesh_scene(f.obj, W, H), device=f.device)
    scene, camera = cs.scene, cs.camera
    target = f.render(scene, camera, W, H, 32, 7)
    f.save("verts_target", target)

    true_mv = scene.mesh_vertices
    sel = torch.zeros(true_mv.shape[0], dtype=torch.bool, device=f.device)
    sel[torch.as_tensor(ground_rows(scene), device=f.device)] = True
    up = torch.tensor([0.0, 0.25, 0.0], device=f.device)
    pert = true_mv + torch.where(sel[:, None], up, torch.zeros_like(up))
    bad = inverse.apply_params(scene, {"mesh_vertices": pert})
    f.save("verts_start", f.render(bad, camera, W, H, 32, 8))

    ck = fresh_checkpoint(f.mesh)
    try:
        fitted, losses, setup = f.fit(bad, camera, target, ("mesh_vertices",),
                                      steps=steps, lr=8e-3, spp=8,
                                      key=rng.root_key(13, f.device), log_every=20,
                                      checkpoint_path=ck)
    finally:
        f.mesh.barrier()
        if f.lead:
            shutil.rmtree(os.path.dirname(ck), ignore_errors=True)
    f.save("verts_fitted", f.render(fitted, camera, W, H, 32, 9))
    d_b = (pert[:, 1] - true_mv[:, 1]).abs()[sel].mean()
    d_a = (fitted.mesh_vertices[:, 1] - true_mv[:, 1]).abs()[sel].mean()
    return f.report(losses, "ground height error", float(d_b), float(d_a), setup, t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("prefix", nargs="?", default=os.path.join(tempfile.gettempdir(), "fit"))
    ap.add_argument("--obj", help="the model (default: spot, else a seeded sphere of "
                                  "spot's face count)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    joined = not dist.is_initialized() and launch.init(
        device="cpu" if args.cpu else None)
    dev = resolve("cpu" if args.cpu else None)
    mesh = launch.global_mesh()

    tmp = None
    obj = args.obj or (assets.SPOT_OBJ if assets.have_reference_assets() else None)
    if obj is None:
        tmp = tempfile.mkdtemp(prefix="mafrix_fit_model_")
        obj = stand_in_obj(tmp)
    f = Fits(args.prefix, mesh, obj, dev)
    f.say(f"devices: {mesh.world} ({dev.type}), model {os.path.basename(obj)}")
    try:
        t0 = time.perf_counter()
        runs = [fit_albedo(f), fit_geometry(f), fit_vertices(f)]
        setups = [r["setup_s"] for r in runs]
        f.say(f"set-up of the three fits (each builds its optimizer): "
              f"{' + '.join(f'{s:.2f}' for s in setups)} = {sum(setups):.2f} s; "
              f"all three fits {time.perf_counter() - t0:.2f} s")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        if joined:
            launch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
