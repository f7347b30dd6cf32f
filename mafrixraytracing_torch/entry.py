"""Two entry points to try the port: a forward step and a multi-process dry
run.

Port of the JAX package's `__graft_entry__.py`.

- `entry()` -> (fn, example_args): a forward render step on the flagship
  scene (Cornell box, 64x64, 1 spp), on the card unless `device` says
  otherwise.
- `dryrun_multiprocess(n, device)`: starts n processes of this machine,
  joins them through a file store, and runs one full sharded
  inverse-rendering train step (sharded pixels, per-microbatch gradient
  all-reduce, Adam) at 16x16 on every rank; the ranks' parameters must come
  out equal. `device="cpu"` runs it on the CPU over gloo; a CUDA device runs
  one rank a card over NCCL, so n may not exceed the number of cards.

    python3 -m mafrixraytracing_torch.entry                  # entry() on the card
    python3 -m mafrixraytracing_torch.entry --dryrun 2 --cpu
    python3 -m mafrixraytracing_torch.entry --dryrun 4       # four cards
"""
from __future__ import annotations

import math
import os
import sys
import tempfile

import torch


def entry(device=None):
    """Forward step: render a 64x64 Cornell frame at 1 spp."""
    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.integrator.path import (
        PathTracerConfig,
        render_sample_batch,
    )
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    W = H = 64
    cs = compile_scene(cornell_box(width=W, height=H), device=device)
    config = PathTracerConfig(max_depth=4, rr_enable=False)

    @torch.no_grad()
    def forward(scene, camera, key):
        return render_sample_batch(scene, camera, W, H, 0, key, config).reshape(
            H, W, 3)

    return forward, (cs.scene, cs.camera, rng.root_key(0, cs.scene.tri_v0.device))


def sharded_train_step(mesh, device=None):
    """One sharded train step on Cornell at 16x16, 2 spp, depth 2 -> (loss,
    gradient norm, the updated parameters), on the card unless `device` says
    otherwise."""
    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.integrator.path import PathTracerConfig
    from mafrixraytracing_torch.opt import inverse
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    size = 16
    cs = compile_scene(cornell_box(width=size, height=size), device=device)
    config = PathTracerConfig(max_depth=2, rr_enable=False)
    params = inverse._leaves(inverse.extract_params(
        cs.scene, ["mat_albedo", "light_radiance", "tri_v0"]))
    step = inverse.make_train_step(inverse._adam(params, 1e-2), 2, config, mesh=mesh)
    target = torch.full((size, size, 3), 0.25, device=cs.scene.tri_v0.device)
    loss, gnorm = step(params, cs.scene, cs.camera, target,
                       rng.root_key(0, cs.scene.tri_v0.device))
    return float(loss), float(gnorm), params


def _dryrun_worker(rank: int, n: int, store: str, device: str | None) -> None:
    from mafrixraytracing_torch.parallel import launch

    launch.init(f"file://{store}", n, rank, device=device)
    mesh = launch.global_mesh()
    if (mesh.rank, mesh.world) != (rank, n):
        raise RuntimeError(f"rank {rank} of {n} joined as {mesh}")
    loss, gnorm, params = sharded_train_step(mesh, device)
    if not math.isfinite(loss):
        raise RuntimeError(f"the sharded step's loss is {loss}")
    for name, p in params.items():
        everyone = mesh.all_gather(p.detach()[None])
        if not all(torch.equal(everyone[0], q) for q in everyone):
            raise RuntimeError(f"the ranks' {name} differ after one step")
    if rank == 0:
        print(f"dryrun_multiprocess({n}) ok: loss={loss:.6f} |grad|={gnorm:.4g}")
    launch.shutdown()


def dryrun_multiprocess(n: int, device=None, timeout_s: float = 300.0) -> None:
    """One sharded inverse-rendering train step on n processes: one rank a
    card over NCCL by default, on the CPU over gloo with `device="cpu"`."""
    from mafrixraytracing_torch.core.device import resolve
    from mafrixraytracing_torch.parallel import launch

    device = resolve(device)
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(
            f"{n} ranks on {torch.cuda.device_count()} card(s): NCCL takes one "
            "rank a card; pass device='cpu' for a dry run on the CPU")
    with tempfile.TemporaryDirectory(prefix="mafrix_torch_dryrun_") as tmp:
        # a rank on the card resolves None to its own card once `init` has
        # made it current
        launch.spawn_local(_dryrun_worker, n,
                           (n, os.path.join(tmp, "store"),
                            "cpu" if device.type == "cpu" else None), timeout_s)


if __name__ == "__main__":
    if "--dryrun" in sys.argv[1:]:
        dryrun_multiprocess(int(sys.argv[sys.argv.index("--dryrun") + 1]),
                            "cpu" if "--cpu" in sys.argv[1:] else None)
    else:
        fn, args = entry()
        out = fn(*args)
        print("entry ok:", tuple(out.shape), float(out.mean()))
