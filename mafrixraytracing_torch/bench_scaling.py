"""Scaling harness: render rays/s at worlds of 1, 2, 4 and 8 processes, the
efficiency of each world against one, and one train step at the largest.

Port of the root `bench_scaling.py`. There one process drives n devices;
here a world of n is n processes, one a device, started on this machine by
`parallel.launch.spawn_local` with a `file://` rendezvous and a time limit.
Rank 0 of each world prints its JSON lines:

- `scaling_render_rays_per_s`: W * H * SPP * DEPTH rays (an upper bound,
  the same for every world) over the mean seconds of 3 renders of
  `render_image_sharded`, after a warm-up that builds the kernels, with a
  barrier and a synchronisation around each; each render's seconds, and
  the port's kernel launches of the 3 (rank 0's), too.
- a check that the world's image equals world 1's bit for bit, which
  fails the run where `parallel.render.same_image_any_world` promises it;
- `scaling_efficiency` of each world n > 1: rays/s over n times world 1's,
  with `vs_target` = efficiency / 0.85;
- `train_step_seconds` at the largest world: `opt.inverse.make_train_step`
  on `mat_albedo`, Adam at 1e-2, the mean of 3 steps after a warm-up step.

Every record's `detail` holds the device's name and power limit. On the
card the worlds go up to `torch.cuda.device_count()`: NCCL puts one rank on
a card, so a machine with one card runs the world of one only and prints
why there is no efficiency line. With `--cpu` the worlds go up to
`--max-world` over gloo; the ranks then share the host's cores (each with
torch's default pool of threads unless `OMP_NUM_THREADS` splits them), so
the lines carry `"virtual_mesh": true` and are no measure of an
interconnect.

    python -m mafrixraytracing_torch.bench_scaling [--cpu] [--max-world N]

Env knobs: SCALE_WIDTH, SCALE_HEIGHT (64), SCALE_SPP (4), SCALE_DEPTH (3).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.core.device import device_fields, resolve
from mafrixraytracing_torch.examples.render_cornell import positive_int
from mafrixraytracing_torch.integrator import path as P
from mafrixraytracing_torch.ops import cuda
from mafrixraytracing_torch.opt import inverse
from mafrixraytracing_torch.parallel import launch
from mafrixraytracing_torch.parallel.render import render_image_sharded, same_image_any_world
from mafrixraytracing_torch.scene.builtin import cornell_box
from mafrixraytracing_torch.scene.compiler import compile_scene

WORLDS = (1, 2, 4, 8)
ITERS = 3
TIMEOUT_S = 900             # a world's processes are killed after this
TARGET = 0.85
ENV = {"SCALE_WIDTH": 64, "SCALE_HEIGHT": 64, "SCALE_SPP": 4, "SCALE_DEPTH": 3}
VIRTUAL_NOTE = ("virtual devices timeshare one host's cores; not an "
                "interconnect-scaling measurement")


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def _rank(rank: int, world: int, job: dict) -> None:
    """One rank of a world: the timed renders, and on the largest world the
    train steps. Rank 0 prints and leaves its image and rays/s in the job's
    directory for the larger worlds."""
    cpu = job["cpu"]
    out = job["dir"]
    launch.init(f"file://{os.path.join(out, f'store{world}')}", world, rank,
                device="cpu" if cpu else None)
    try:
        _measure(rank, world, job, resolve("cpu" if cpu else None))
    finally:
        launch.shutdown()


def _measure(rank, world, job, dev) -> None:
    W, H, SPP, DEPTH = job["W"], job["H"], job["SPP"], job["DEPTH"]
    mesh = launch.global_mesh()
    lead = rank == 0
    cfg = P.PathTracerConfig(max_depth=DEPTH, rr_enable=False)
    cs = compile_scene(cornell_box(width=W, height=H), device=dev)
    scene, camera = cs.scene, cs.camera
    fields = {"backend": launch.process_info()["backend"], **job["device"]}
    virtual = job["cpu"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mesh.barrier()

    def timed(fn):
        """(the last output, the seconds of each, the kernel launches of all)
        of ITERS calls of fn(i), after a warm-up."""
        out = fn(-1)
        sync()
        cuda.reset_launches()
        times = []
        for i in range(ITERS):
            t0 = time.perf_counter()
            out = fn(i)
            sync()
            times.append(time.perf_counter() - t0)
        return out, times, {k: v for k, v in cuda.LAUNCHES.items() if v}

    img, times, launches = timed(lambda i: render_image_sharded(
        scene, camera, mesh, W, H, SPP, rng.root_key(i + 1, dev), cfg))
    dt = sum(times) / ITERS
    rays = W * H * SPP * DEPTH    # upper-bound accounting, the same for every world
    if lead:
        emit({"metric": "scaling_render_rays_per_s", "devices": world,
              "value": rays / dt, "seconds_per_frame": dt, "iteration_seconds": times,
              "virtual_mesh": virtual, "detail": {**fields, "launches": launches}})
        torch.save({"image": img.cpu(), "rays_per_s": rays / dt},
                   os.path.join(job["dir"], f"world{world}.pt"))
        if world > 1:
            one = torch.load(os.path.join(job["dir"], "world1.pt"))
            equal = torch.equal(img.cpu(), one["image"])
            promised = same_image_any_world(W, H, SPP, world, cfg)
            emit({"check": "image_equal_to_world_1", "devices": world, "equal": equal,
                  "promised": promised})
            if promised and not equal:
                raise RuntimeError(f"the image of a world of {world} differs from "
                                   "the world of one's")
            eff = rays / dt / (one["rays_per_s"] * world)
            emit({"metric": "scaling_efficiency", "devices": world, "value": eff,
                  "vs_target": eff / TARGET, "virtual_mesh": virtual, "detail": fields,
                  **({"note": VIRTUAL_NOTE} if virtual else {})})
    if world != job["largest"]:
        return

    # one train step (render, backward, all-reduce, Adam) at the largest world
    target = render_image_sharded(scene, camera, mesh, W, H, SPP, rng.root_key(9, dev),
                                  cfg)
    params = {"mat_albedo": scene.mat_albedo.detach().clone().requires_grad_()}
    optimizer = torch.optim.Adam(list(params.values()), lr=1e-2)
    step = inverse.make_train_step(optimizer, SPP, cfg, mesh=mesh)
    _, times, launches = timed(lambda i: step(params, scene, camera, target,
                                              rng.root_key(i + 2, dev)))
    if lead:
        emit({"metric": "train_step_seconds", "devices": world,
              "value": sum(times) / ITERS, "iteration_seconds": times,
              "virtual_mesh": virtual, "detail": {**fields, "launches": launches}})


def env_size(name: str, ap: argparse.ArgumentParser) -> int:
    text = os.environ.get(name, str(ENV[name]))
    try:
        return positive_int(text)
    except argparse.ArgumentTypeError as e:
        ap.error(f"{name}: {e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="worlds of CPU processes over gloo (a virtual mesh)")
    ap.add_argument("--max-world", type=positive_int, default=max(WORLDS),
                    help="the largest world with --cpu")
    args = ap.parse_args(argv)
    W, H, SPP, DEPTH = (env_size(k, ap) for k in ENV)
    dev = resolve("cpu" if args.cpu else None)
    limit = args.max_world if args.cpu else torch.cuda.device_count()
    worlds = [n for n in WORLDS if n <= limit]
    if not args.cpu and len(worlds) == 1:
        emit({"note": f"no scaling_efficiency line: this machine has "
                      f"{torch.cuda.device_count()} CUDA device(s) and NCCL puts one "
                      "rank on a card, so only the world of one runs here; --cpu "
                      "runs larger worlds over gloo"})
    job = {"W": W, "H": H, "SPP": SPP, "DEPTH": DEPTH, "cpu": args.cpu,
           "largest": worlds[-1], "device": device_fields(dev),
           "dir": tempfile.mkdtemp(prefix="mafrix_scaling_")}
    from mafrixraytracing_torch import bench_scaling   # importable by the children

    try:
        for n in worlds:
            launch.spawn_local(bench_scaling._rank, n, (n, job), timeout_s=TIMEOUT_S)
    finally:
        shutil.rmtree(job["dir"], ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
