"""The reference's data-parallel train steps: `fit.py`'s steps with the
pixels cut into contiguous shards, one a rank, as the measured program's
data-parallel fit cuts them. Each step renders every shard as a wavefront of
its own (so a compaction schedule selects over each shard's lanes alone),
takes each shard's relative-L2 loss against its pixels of the target and
the gradient of that loss, and averages the losses and gradients over the
shards in rank order, in float64; then the smoothing and Adam of `fit.py`
on the mean.

The shards may be computed in one process (`ranks` None: all of them) or
split over processes, each computing its own (`ranks=[r]`) and handing its
losses and gradients to the others through `gather`.
"""
from __future__ import annotations

import torch

from . import rng
from .fit import BETA1, BETA2, EPS, image_loss, overlay, smooth
from .tracer import render_pixels


def shard_ids(n: int, world: int, rank: int, device=None) -> torch.Tensor:
    """Rank `rank`'s contiguous share of the n pixel ids, padded from the
    start up to a multiple of `world`."""
    per = -(-n // world)
    ids = torch.arange(per * world, device=device) % n
    return ids[rank * per:(rank + 1) * per]


def _flat(loss, grads: dict) -> torch.Tensor:
    return torch.cat([loss.detach().reshape(1).double(),
                      *(g.detach().reshape(-1).double() for g in grads.values())])


def _unflat(flat: torch.Tensor, like: dict):
    loss, out, k = float(flat[0]), {}, 1
    for n, v in like.items():
        out[n] = flat[k:k + v.numel()].reshape(v.shape).to(v.dtype)
        k += v.numel()
    return loss, out


def fit_steps(scene, cam, target, start: dict, steps: int, key, spp: int, lr: float,
              smooth_iters: int, width: int, height: int, world: int, depth: int = 5,
              rr_start: int = 3, wavefront: int = 1 << 19, compact=(),
              moments: dict | None = None, count: int = 0, ranks=None, gather=None):
    """`fit.fit_steps` over `world` shards. `ranks`: the shards this call
    renders (all when None); `gather(flats)`: this call's flat (loss,
    gradients) vectors, one a shard of `ranks`, to the `world` vectors of
    every shard in rank order (the identity when this call renders all).
    Returns (losses, the first step's gradients as Adam received them, the
    parameters after the last step)."""
    ranks = list(range(world)) if ranks is None else list(ranks)
    gather = gather or (lambda flats: flats)
    params = {n: v.detach().clone() for n, v in start.items()}
    if moments is None:
        moments = {n: (torch.zeros_like(v), torch.zeros_like(v)) for n, v in params.items()}
    m = {n: moments[n][0].clone() for n in params}
    s = {n: moments[n][1].clone() for n in params}
    tflat = target.reshape(-1, 3)
    losses, first = [], None
    for k in range(count + 1, count + steps + 1):
        key, sub = rng.split(key)
        flats = []
        for r in ranks:
            ids = shard_ids(width * height, world, r, target.device)
            leaves = {n: v.clone().requires_grad_() for n, v in params.items()}
            img = render_pixels(overlay(scene, leaves), cam, ids, width, height, spp, sub,
                                depth, rr_start, wavefront, compact=compact)
            loss = image_loss(img, tflat[ids])
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            flats.append(_flat(loss, grads))
        every = gather(flats)
        if len(every) != world:
            raise ValueError(f"{len(every)} shards gathered for a world of {world}")
        mean = every[0].to(flats[0].device)
        for f in every[1:]:
            mean = mean + f.to(mean.device)
        loss, grads = _unflat(mean / world, params)
        if smooth_iters and "mesh_vertices" in grads:
            grads["mesh_vertices"] = smooth(scene, grads["mesh_vertices"], smooth_iters)
        losses.append(loss)
        if first is None:
            first = {n: g.clone() for n, g in grads.items()}
        bc1, bc2 = 1.0 - BETA1 ** k, 1.0 - BETA2 ** k
        for n, g in grads.items():
            m[n] = m[n] * BETA1 + g * (1.0 - BETA1)
            s[n] = s[n] * BETA2 + g * g * (1.0 - BETA2)
            denom = s[n].sqrt() / (bc2 ** 0.5) + EPS
            params[n] = params[n] - (lr / bc1) * m[n] / denom
    return losses, first, params
