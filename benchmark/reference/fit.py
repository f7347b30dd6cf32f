"""The reference's inverse-rendering steps: render the flat pixel batch
with the parameters overlaid, the relative-L2 loss against the target, its
gradient, the Laplacian smoothing of the vertex gradient over the faces, and
Adam (lr, betas 0.9 / 0.999, eps 1e-8, bias-corrected) on every parameter.
"""
from __future__ import annotations

import torch

from . import rng
from .tracer import render_pixels

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def overlay(scene, params: dict):
    """The scene with `params` in place: albedo clipped to [0, 1] (half the
    gradient passes at a bound), the vertex buffer gathered to the faces'
    corners."""
    kw = {}
    if "mat_albedo" in params:
        a = params["mat_albedo"]
        kw["mat_albedo"] = torch.minimum(torch.maximum(a, torch.zeros_like(a)),
                                         torch.ones_like(a))
    if "light_radiance" in params:
        kw["light_radiance"] = params["light_radiance"]
    if "mesh_vertices" in params:
        f = scene.face_vi
        T = f.shape[0]
        c = params["mesh_vertices"].index_select(0, f.t().reshape(-1)).reshape(3, T, 3)
        kw.update(tri_v0=c[0], tri_e1=c[1] - c[0], tri_e2=c[2] - c[0])
    return scene.replace(**kw)


def image_loss(img, target):
    d = img - target
    return torch.mean(d * d / (target * target + 1e-2))


@torch.no_grad()
def smooth(scene, g, iters: int, alpha: float = 0.7):
    f = scene.face_vi
    w = scene.tri_mask.to(g.dtype)[:, None]
    V = g.shape[0]
    idx = f.t().reshape(-1)
    deg = torch.zeros((V, 1), dtype=g.dtype, device=g.device).index_add_(
        0, idx, (2.0 * w).repeat(3, 1))
    deg = torch.clamp(deg, min=1.0)
    for _ in range(iters):
        ga, gb, gc = g[f[:, 0]], g[f[:, 1]], g[f[:, 2]]
        nb = torch.cat([(gb + gc) * w, (ga + gc) * w, (ga + gb) * w])
        g = (1.0 - alpha) * g + alpha * (torch.zeros_like(g).index_add_(0, idx, nb) / deg)
    return g


def fit_steps(scene, cam, target, start: dict, steps: int, key, spp: int, lr: float,
              smooth_iters: int, width: int, height: int, depth: int = 5,
              rr_start: int = 3, wavefront: int = 1 << 19, compact=(),
              moments: dict | None = None, count: int = 0):
    """`steps` train steps from the parameters `start` with the fit's key
    schedule (each step splits the key and renders with the second half),
    from Adam's moments `moments` ({name: (first, second)}) after `count`
    steps, or from a fresh Adam. Returns (losses, the first step's
    gradients as Adam received them, the parameters after the last step)."""
    params = {n: v.detach().clone() for n, v in start.items()}
    if moments is None:
        moments = {n: (torch.zeros_like(v), torch.zeros_like(v)) for n, v in params.items()}
    m = {n: moments[n][0].clone() for n in params}
    s = {n: moments[n][1].clone() for n in params}
    ids = torch.arange(width * height, device=target.device)
    tflat = target.reshape(-1, 3)
    losses, first = [], None
    for k in range(count + 1, count + steps + 1):
        key, sub = rng.split(key)
        leaves = {n: v.clone().requires_grad_() for n, v in params.items()}
        img = render_pixels(overlay(scene, leaves), cam, ids, width, height, spp, sub,
                            depth, rr_start, wavefront, compact=compact)
        loss = image_loss(img, tflat)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        if smooth_iters and "mesh_vertices" in grads:
            grads["mesh_vertices"] = smooth(scene, grads["mesh_vertices"], smooth_iters)
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: g.clone() for n, g in grads.items()}
        bc1, bc2 = 1.0 - BETA1 ** k, 1.0 - BETA2 ** k
        for n, g in grads.items():
            m[n] = m[n] * BETA1 + g * (1.0 - BETA1)
            s[n] = s[n] * BETA2 + g * g * (1.0 - BETA2)
            denom = s[n].sqrt() / (bc2 ** 0.5) + EPS
            params[n] = params[n] - (lr / bc1) * m[n] / denom
    return losses, first, params
