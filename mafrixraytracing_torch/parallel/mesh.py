"""The ray mesh: which part of a wavefront this process renders.

Port of `mafrixraytracing_tpu/parallel/mesh.py`. There a 1-D
`jax.sharding.Mesh` over the devices of one program shards the pixel batch
along its ray axis and `shard_map` runs the shards. Here there is one process
per device (`torch.distributed`), so the mesh is a small record: this
process's `rank`, the `world` size and the process group the collectives run
on. A world of one needs no process group and does no communication, as a
JAX mesh of one device does; a mesh with `world` > 1 and no group describes
one shard of a larger run (the tests render every shard in one process), and
its collectives raise.

The scene is replicated: every rank compiles or loads the same scene, and
only pixel ids and target pixels are sharded.

Every collective runs inside the `collective` span (`utils/trace.py`) and
is counted in `collective_calls`; `sum_start` adds the bytes it all-reduces
to `allreduce_bytes`. A world of one without a group counts nothing.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from mafrixraytracing_torch.utils import trace

RAY_AXIS = "rays"


@dataclass(frozen=True)
class RayMesh:
    """`rank` of `world` processes on `group` (None: no communication)."""

    rank: int = 0
    world: int = 1
    group: object = None

    @property
    def shape(self) -> dict:
        return {RAY_AXIS: self.world}

    def shard(self, n: int) -> slice:
        """This rank's contiguous slice of a batch of n = k * world rows."""
        if n % self.world:
            raise ValueError(f"{n} rows do not divide over {self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def _need_group(self):
        if self.group is None:
            raise RuntimeError(
                f"a mesh of {self.world} ranks without a process group cannot "
                "communicate: call parallel.launch.init() first")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-shaped `x`, concatenated along dim 0 in rank order."""
        if self.world == 1 and self.group is None:
            return x
        self._need_group()
        trace.count("collective_calls", 1)
        with trace.span("collective"):
            parts = [torch.empty_like(x) for _ in range(self.world)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            return torch.cat(parts)

    def sum_start(self, tensors) -> list:
        """Start an in-place sum over the ranks of every tensor; returns the
        handles for `finish`. Asynchronous: the collective runs while the
        caller goes on (on the card, on NCCL's own stream)."""
        if self.world == 1 and self.group is None:
            return []
        self._need_group()
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("an in-place sum over the ranks needs contiguous tensors")
        trace.count("collective_calls", len(tensors))
        trace.count("allreduce_bytes", sum(t.numel() * t.element_size() for t in tensors))
        with trace.span("collective"):
            return [dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group,
                                    async_op=True) for t in tensors]

    @staticmethod
    def finish(handles) -> None:
        with trace.span("collective"):
            for h in handles:
                h.wait()

    def all_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of `x` over the ranks (a new tensor)."""
        y = x.clone()
        self.finish(self.sum_start([y]))
        return y / self.world

    def barrier(self) -> None:
        """Wait for every rank. On NCCL the barrier runs on this process's
        card (the current device, as `launch.init` sets it), named, not left
        for NCCL to guess from the rank."""
        if self.group is None:
            return
        trace.count("collective_calls", 1)
        with trace.span("collective"):
            if dist.get_backend(self.group) == dist.Backend.NCCL:
                dist.barrier(group=self.group, device_ids=[torch.cuda.current_device()])
            else:
                dist.barrier(group=self.group)


def make_mesh(world: int | None = None, rank: int | None = None,
              group=None) -> RayMesh:
    """The mesh of this process. With no arguments: the default process group
    when `torch.distributed` is initialised (`parallel.launch.init`), else a
    world of one. `make_mesh(1)` is always the world of one without a group.
    `make_mesh(n, r)` with no group describes shard r of n for a caller that
    joins the shards itself."""
    if world is None and rank is None and group is None:
        if dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        else:
            return RayMesh()
    if group is not None:
        return RayMesh(dist.get_rank(group), dist.get_world_size(group), group)
    world = 1 if world is None else int(world)
    rank = 0 if rank is None else int(rank)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is outside a world of {world}")
    return RayMesh(rank, world, None)
