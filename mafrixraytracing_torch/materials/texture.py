"""Texture atlas build (host).

A copy of `build_atlas` from `mafrixraytracing_tpu/materials/texture.py`:
importing any module of that package imports JAX, and the port runs where
JAX is absent. All scene textures live in one (K, R, R, 3) atlas so the
material table stays flat. Sampling the atlas during a render is not ported
yet (ROADMAP): the integrator raises for textured scenes.
"""
from __future__ import annotations

import numpy as np

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
