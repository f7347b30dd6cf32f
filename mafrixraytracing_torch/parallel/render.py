"""Sharded rendering: pixel wavefronts over the ranks of a ray mesh.

Port of `mafrixraytracing_tpu/parallel/render.py`. Each rank traces its
contiguous shard of the pixel ids against its own copy of the scene, so the
forward render needs one collective: the `all_gather` of the shards (JAX's
`shard_map` output). Gradient reduction for inverse rendering lives in
`opt.inverse` (an all-reduce over the same mesh); the gathered image is not
differentiable across ranks.

RNG keys derive from the global pixel id, so a pixel's samples are the same
whichever rank traces them. The image is therefore **bit-identical for any
world size** as long as nothing in `render_flat_pixels` depends on the
shard's size: without a compaction schedule (`config.compact == ()`), and
with every shard's sample group equal to the whole image's (`_spp_group`
picks G from the batch size: equal when pixels * spp fits one wavefront, as
at 256x256 x 8 spp, or when spp <= 2, where the sum over a pixel's samples
has one rounding whatever its order). With a compaction schedule the
population control selects over each rank's own wavefront, and with differing
G the samples are summed in another order: the images then agree only in the
mean, as two seeds do.
"""
from __future__ import annotations

import torch

from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.integrator import path as P
from mafrixraytracing_torch.integrator.path import PathTracerConfig, render_flat_pixels
from mafrixraytracing_torch.parallel.mesh import RAY_AXIS, RayMesh

# the JAX package's name for it
_render_flat_pixels = render_flat_pixels

__all__ = ["RAY_AXIS", "padded_pixel_ids", "same_image_any_world", "render_shard",
           "assemble_image", "render_image_sharded", "render_spp_sharded",
           "_render_flat_pixels"]


def same_image_any_world(width: int, height: int, spp: int, world: int,
                         config: PathTracerConfig = PathTracerConfig()) -> bool:
    """Whether `render_image_sharded` gives a world of `world` ranks the
    image of one bit for bit (the module docstring): no compaction schedule,
    and every shard groups a pixel's samples as the whole image does."""
    B = width * height
    per = -(-B // world)
    return config.compact == () and (
        spp <= 2 or P._spp_group(spp, per, config.wavefront)
        == P._spp_group(spp, B, config.wavefront))


def padded_pixel_ids(width: int, height: int, world: int, device=None) -> torch.Tensor:
    """The frame's pixel ids in tile order (compact screen blocks of TILE
    pixels, for the cull), repeated from the start up to a multiple of
    `world`: `perm[arange(B_pad) % B]`."""
    B = width * height
    B_pad = -(-B // world) * world
    perm, _ = P.tiled_pixel_order(width, height, *P._spp_tile_shape(1))
    perm = torch.as_tensor(perm, device=device)
    return perm[torch.arange(B_pad, device=device) % B]


def render_shard(scene, camera, mesh: RayMesh, width: int, height: int, spp: int,
                 key: torch.Tensor,
                 config: PathTracerConfig = PathTracerConfig()) -> torch.Tensor:
    """This rank's shard of the frame: (B_pad / world, 3), no communication."""
    ids = padded_pixel_ids(width, height, mesh.world, scene.tri_v0.device)
    return render_flat_pixels(scene, camera, ids[mesh.shard(ids.shape[0])], width,
                              height, spp, key, config)


def assemble_image(shards: torch.Tensor, width: int, height: int,
                   world: int) -> torch.Tensor:
    """The ranks' shards, concatenated in rank order -> (height, width, 3)."""
    B = width * height
    ids = padded_pixel_ids(width, height, world, shards.device)
    img = torch.zeros((B, 3), dtype=shards.dtype, device=shards.device)
    img[ids[:B]] = shards[:B]
    return img.reshape(height, width, 3)


@torch.no_grad()
def render_image_sharded(scene, camera, mesh: RayMesh, width: int, height: int,
                         spp: int, key: torch.Tensor,
                         config: PathTracerConfig = PathTracerConfig()) -> torch.Tensor:
    """Full-frame render with the pixels sharded over `mesh`. Returns the
    whole (height, width, 3) image on every rank. The pixel count is padded
    up to a multiple of the world size with repeated pixels. See the module
    docstring for when the image is bit-identical for any world size."""
    out = render_shard(scene, camera, mesh, width, height, spp, key, config)
    return assemble_image(mesh.all_gather(out), width, height, mesh.world)


@torch.no_grad()
def render_spp_sharded(scene, camera, mesh: RayMesh, width: int, height: int,
                       spp_per_rank: int, key: torch.Tensor,
                       config: PathTracerConfig = PathTracerConfig()) -> torch.Tensor:
    """The other decomposition: every rank renders all pixels at
    `spp_per_rank` samples under the key `fold_in(key, rank)` and the images
    are averaged (total spp = spp_per_rank * world). For small images at huge
    sample counts."""
    ids = torch.arange(width * height, device=scene.tri_v0.device)
    img = render_flat_pixels(scene, camera, ids, width, height, spp_per_rank,
                             rng.fold_in(key, mesh.rank), config)
    return mesh.all_mean(img).reshape(height, width, 3)
