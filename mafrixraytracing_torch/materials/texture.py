"""Texture atlas: host build and device sampling.

`build_atlas`, `checker_texture` and `perlin_texture` are copies of the NumPy
functions of `mafrixraytracing_tpu/materials/texture.py` (importing any
module of that package imports JAX, and the port runs where JAX is absent).
All scene textures live in one (K, R, R, 3) atlas so the material table
stays flat. `sample_atlas` is the port of the JAX sampler: wrap addressing,
the vertical flip at sample time (OBJ `vt` has v pointing up, image row 0 is
the top), nearest or bilinear, white for an untextured material.
"""
from __future__ import annotations

import numpy as np
import torch

ATLAS_RES = 256


def build_atlas(textures: list, res: int = ATLAS_RES) -> np.ndarray:
    """Resize (H, W, 3) float images to a common (K, res, res, 3) atlas.
    Bilinear resize via PIL when available, else nearest."""
    if not textures:
        return np.ones((1, res, res, 3), np.float32)
    out = np.zeros((len(textures), res, res, 3), np.float32)
    for k, img in enumerate(textures):
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        try:
            from PIL import Image
        except ImportError:
            ys = (np.arange(res) * img.shape[0] // res).clip(0, img.shape[0] - 1)
            xs = (np.arange(res) * img.shape[1] // res).clip(0, img.shape[1] - 1)
            out[k] = img[np.ix_(ys, xs)]
            continue
        im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        im = im.resize((res, res), Image.BILINEAR)
        out[k] = np.asarray(im, np.float32) / 255.0
    return out


def checker_texture(
    c1=(1.0, 1.0, 1.0), c2=(0.2, 0.3, 0.1), tiles: int = 8, res: int = ATLAS_RES
) -> np.ndarray:
    """Checkerboard (reference `CheckerTexture`,
    `RenderTest/Sample/RayTracing.fs:52-62`), baked to an atlas page."""
    y, x = np.mgrid[0:res, 0:res]
    mask = ((x * tiles // res) + (y * tiles // res)) % 2
    img = np.where(mask[..., None] == 0, np.asarray(c1, np.float32), np.asarray(c2, np.float32))
    return img.astype(np.float32)


def perlin_texture(seed: int = 0, scale: float = 4.0, res: int = ATLAS_RES) -> np.ndarray:
    """Value-noise turbulence texture (capability parity with the
    reference's `Perlin`/`NoiseTexture`,
    `RenderTest/Sample/RayTracing.fs:64-99`), baked to an atlas page."""
    rng = np.random.default_rng(seed)
    img = np.zeros((res, res), np.float32)
    amp, freq = 1.0, scale
    for _ in range(5):
        g = int(max(2, freq))
        grid = rng.random((g + 1, g + 1)).astype(np.float32)
        ys = np.linspace(0, g, res, endpoint=False)
        xs = np.linspace(0, g, res, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        fy = fy * fy * (3 - 2 * fy)
        fx = fx * fx * (3 - 2 * fx)
        c00 = grid[np.ix_(y0, x0)]
        c01 = grid[np.ix_(y0, x0 + 1)]
        c10 = grid[np.ix_(y0 + 1, x0)]
        c11 = grid[np.ix_(y0 + 1, x0 + 1)]
        img += amp * ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
                      + (c10 * (1 - fx) + c11 * fx) * fy)
        amp *= 0.5
        freq *= 2.0
    img = img / img.max()
    return np.stack([img] * 3, axis=-1)


def sample_atlas(atlas: torch.Tensor, tex_id: torch.Tensor, uv: torch.Tensor,
                 mode: str = "bilinear") -> torch.Tensor:
    """Sample the atlas. atlas: (K, R, R, 3); tex_id: (...,) integer (values
    < 0 return white); uv: (..., 2) in the OBJ convention (v up). Returns
    (..., 3). mode="nearest" matches the reference's `Texture2D` sampler
    (`Core/Texture.fs:11-28`) with one gather, "bilinear" takes four. Plain
    tensor indexing: gradients reach the atlas and, in bilinear mode, uv."""
    K, R = atlas.shape[0], atlas.shape[1]
    tid = tex_id.long().clamp(0, K - 1)
    u = torch.remainder(uv[..., 0], 1.0) * (R - 1)
    v = torch.remainder(1.0 - uv[..., 1], 1.0) * (R - 1)  # flip: v-up -> row-down
    textured = (tex_id >= 0)[..., None]
    if mode == "nearest":
        # round half to even, as jnp.round does
        x = torch.round(u).long()
        y = torch.round(v).long()
        return torch.where(textured, atlas[tid, y, x], 1.0)
    x0 = torch.floor(u).long()
    y0 = torch.floor(v).long()
    x1 = torch.clamp(x0 + 1, max=R - 1)
    y1 = torch.clamp(y0 + 1, max=R - 1)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    top = atlas[tid, y0, x0] * (1 - fx) + atlas[tid, y0, x1] * fx
    bot = atlas[tid, y1, x0] * (1 - fx) + atlas[tid, y1, x1] * fx
    return torch.where(textured, top * (1 - fy) + bot * fy, 1.0)
