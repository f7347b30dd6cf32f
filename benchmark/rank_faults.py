"""Faults of the exchange between ranks, planted in the measured program to
show that the comparison of the data-parallel fit (`kinds/fit_ranks.py`)
rejects them. Each rank's process plants the fault itself; the fault acts
on rank 1 alone.

- left_out: rank 1's gradients enter the all-reduce as zeros, so the sum
  leaves that rank's gradient out (its loss still counts).
- same_shard: rank 1 renders rank 0's shard of the pixels in the train step,
  so one shard counts twice and another not at all.
"""
from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

FAULTS = ("left_out", "same_shard")


@contextlib.contextmanager
def planted(fault: str):
    from mafrixraytracing_torch.opt import inverse
    from mafrixraytracing_torch.parallel import mesh as pmesh

    if fault == "left_out":
        orig = pmesh.RayMesh.sum_start

        def left_out(self, tensors):
            if self.rank == 1:
                for g in tensors[1:]:
                    g.zero_()
            return orig(self, tensors)
        patch = mock.patch.object(pmesh.RayMesh, "sum_start", left_out)
    elif fault == "same_shard":
        orig = inverse.loss_and_grads

        def same_shard(params, scene, camera, target, key, spp, config, micro, mesh):
            if mesh is not None and mesh.rank == 1:
                mesh = dataclasses.replace(mesh, rank=0)
            return orig(params, scene, camera, target, key, spp, config, micro, mesh)
        patch = mock.patch.object(inverse, "loss_and_grads", same_shard)
    else:
        raise ValueError(f"no fault {fault!r}; the faults are {FAULTS}")
    with patch:
        yield
