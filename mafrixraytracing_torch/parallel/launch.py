"""Multi-process launch: one process per device on `torch.distributed`.

Port of `mafrixraytracing_tpu/parallel/launch.py`. The JAX package
initialises `jax.distributed` once per host and builds its mesh over all
devices; here every process drives one device and `init()` joins them in the
default process group: NCCL for the card, gloo for the CPU. Nothing here
discovers a cluster: the rendezvous comes from the arguments or from the
environment a launcher such as `torchrun` sets.

    torchrun --nproc-per-node 4 your_script.py

    # your_script.py
    from mafrixraytracing_torch.parallel import launch
    launch.init()                       # False, and a no-op, in a plain run
    mesh = launch.global_mesh()
    ...render_image_sharded(scene, camera, mesh, ...)
    ...opt.inverse.fit(scene, camera, target, names, mesh=mesh, ...)

`init(device="cpu")` joins over gloo on the CPU; without it a run with no card
raises. Without a launcher pass `init_method` (`tcp://host:port`, or `file://path` on
a file system the processes share), `world_size` and `rank`, or set
MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK. `spawn_local` starts n
processes of one function on this machine with a time limit, for dry runs and
tests.
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.parallel.mesh import RayMesh, make_mesh


def init(init_method: str | None = None, world_size: int | None = None,
         rank: int | None = None, device=None) -> bool:
    """Join the default process group of a multi-process run. Returns True if
    the group is up, False when nothing is configured (no `init_method` and no
    MASTER_ADDR: the single-process case). Idempotent. `device` is resolved
    as everywhere in the port: the card by default, and an error when there
    is none; the CPU only when asked for (`device="cpu"`). The backend is
    NCCL for a CUDA device, on which LOCAL_RANK (else the rank) picks this
    process's card, and gloo for the CPU."""
    if dist.is_initialized():
        return True
    if init_method is None and not os.environ.get("MASTER_ADDR"):
        return False
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    on_card = resolve(device).type == "cuda"
    if on_card:
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if on_card else "gloo",
        init_method=init_method or "env://", world_size=world_size, rank=rank)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op when `init` set none up). On NCCL the
    teardown waits for every rank of the group: every rank calls it, and no
    rank waits for another's process to end before calling it."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh() -> RayMesh:
    """The ray mesh over every process of the run (after `init()`); a world
    of one in a single-process run."""
    return make_mesh()


def process_info() -> dict:
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else None,
        "local_devices": torch.cuda.device_count(),
    }


def spawn_local(fn, n: int, args=(), timeout_s: float = 120.0) -> None:
    """Run `fn(rank, *args)` in n fresh processes of this machine and wait for
    them. `fn` must live in an importable module. A process that fails raises
    here; when the time limit passes, every process is killed and
    `TimeoutError` is raised, so a hung rank cannot hold the caller."""
    ctx = mp.spawn(fn, args=tuple(args), nprocs=n, join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{n} processes of {getattr(fn, '__name__', fn)} did not "
                    f"finish in {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5.0)
