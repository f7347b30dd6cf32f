"""Inverse rendering: fit scene parameters to a target image by gradient
descent through the differentiable renderer.

Port of `mafrixraytracing_tpu/opt/inverse.py` for one device. The reference
renderer is forward-only; this is the capability the system exists for: pixel
gradients flow to material albedo and emission, light radiance and vertex
positions. A train step renders the flat pixel batch, takes the relative-L2
loss against the target, back-propagates, optionally smooths the vertex
gradient, and applies Adam. The JAX package's `mesh` argument, its
`shard_map` over the ray axis and the gradient all-reduce belong to the
parallel modules and are not here.

On the card every colliding gather of the step (the attribute fetch, the
light rows, the vertex gather) sums its backward with the deterministic
scatter-add kernel (`ops.unpack.scatter_rows`), so the same state gives the
same gradients bit for bit, and a fit resumed from a checkpoint repeats the
uninterrupted run exactly.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from mafrixraytracing_torch.accel.clusters import refresh_clusters
from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.integrator.path import (
    PathTracerConfig,
    render_flat_pixels,
)
from mafrixraytracing_torch.ops.unpack import gather_rows, scatter_rows
from mafrixraytracing_torch.utils import checkpoint as ckpt

# Scene leaves that move geometry: optimizing any of these invalidates the
# cluster AABBs the cull relies on, so `apply_params` rebuilds them (a stale
# cull silently loses hits once vertices leave their original boxes).
GEOMETRY_PARAMS = ("tri_v0", "tri_e1", "tri_e2", "mesh_vertices")


def apply_params(scene, params: dict):
    """Overlay a dict of optimizable leaves onto the scene. Keys are
    `TorchScene` field names ('mat_albedo', 'light_radiance', 'tri_v0',
    'mesh_vertices', ...). Albedo is clipped to [0, 1]. `mesh_vertices` (the
    shared vertex buffer) re-derives the per-face tri_v0/e1/e2 by gather, so
    a vertex's gradient accumulates from every face that references it.
    Geometry updates refresh the cluster AABBs on the device."""
    updates = dict(params)
    if "mat_albedo" in updates:
        # minimum(maximum(.)) and not clamp: at a bound it passes half the
        # gradient, as `jnp.clip` does (clamp passes all of it)
        a = updates["mat_albedo"]
        updates["mat_albedo"] = torch.minimum(
            torch.maximum(a, torch.zeros_like(a)), torch.ones_like(a))
    if "mesh_vertices" in updates:
        f = scene.tri_face_vi.long()
        T = f.shape[0]
        # one gather for the three corners: (3 T, 3) rows, corner-major
        corners = gather_rows(updates["mesh_vertices"],
                              f.t().reshape(-1)).reshape(3, T, 3)
        updates["tri_v0"] = corners[0]
        updates["tri_e1"] = corners[1] - corners[0]
        updates["tri_e2"] = corners[2] - corners[0]
    scene = scene.replace(**updates)
    if any(k in updates for k in GEOMETRY_PARAMS):
        scene = refresh_clusters(scene)
    return scene


def extract_params(scene, names) -> dict:
    return {n: getattr(scene, n) for n in names}


@torch.no_grad()
def smooth_vertex_grads(scene, g: torch.Tensor, iters: int = 8,
                        alpha: float = 0.7) -> torch.Tensor:
    """Laplacian-smooth a mesh-vertex gradient over the face adjacency (a
    light version of the "Large Steps in Inverse Rendering" preconditioner).
    Per-vertex Monte-Carlo gradients at practical sample counts are
    noise-dominated; Adam then normalizes that noise into a constant-size
    random walk that roughens the mesh. `iters` Jacobi steps of
    g <- (1 - alpha) g + alpha * neighbor-mean(g) over the 1-ring keep the
    coherent, low-frequency part, which is what the shading signal can
    constrain, and average the per-vertex noise away."""
    f = scene.tri_face_vi.long()
    w = scene.tri_mask.to(torch.float32)[:, None]
    V = g.shape[0]
    idx = f.t().reshape(-1)   # corner-major, as the three adds of the JAX version
    deg = scatter_rows((2.0 * w).repeat(3, 1).t(), idx, V)
    deg = torch.clamp(deg, min=1.0)
    for _ in range(iters):
        ga, gb, gc = g[f[:, 0]], g[f[:, 1]], g[f[:, 2]]
        nb = torch.cat([(gb + gc) * w, (ga + gc) * w, (ga + gb) * w])
        g = (1.0 - alpha) * g + alpha * (scatter_rows(nb.t(), idx, V) / deg)
    return g


def image_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Relative-L2 loss (standard for HDR renders: divides out brightness so
    bright pixels do not dominate). Normalized by the target, a constant:
    normalizing by the noisy render amplifies Monte-Carlo noise in dark
    pixels and correlates the weight with the estimator, which makes the fit
    diverge."""
    d = img - target
    return torch.mean(d * d / (target * target + 1e-2))


def loss_and_grads(params: dict, scene, camera, target: torch.Tensor,
                   key: torch.Tensor, spp: int,
                   config: PathTracerConfig = PathTracerConfig(),
                   overlap_microbatches: int = 1):
    """The loss of the render of `scene` overlaid with `params` against the
    (H, W, 3) `target`, and its gradient with respect to every parameter ->
    (loss, {name: gradient}), both detached. With M = `overlap_microbatches`
    > 1 the loss is the mean of M relative-L2 losses of sub-images of
    spp / M samples each (sample offsets m * spp / M: the sub-sample sets
    partition the sample indices, so no RNG stream is reused), and the
    gradients are averaged: the same target, a slightly higher-variance
    gradient."""
    M = overlap_microbatches
    if M < 1 or spp % M:
        raise ValueError(f"overlap_microbatches={M} must divide spp={spp}")
    height, width = target.shape[:2]
    ids = torch.arange(width * height, device=target.device)
    tflat = target.reshape(width * height, 3)
    names, leaves = list(params), list(params.values())
    sub = spp // M
    loss, grads = None, None
    for m in range(M):
        s = apply_params(scene, params)
        img = render_flat_pixels(s, camera, ids, width, height, sub, key, config,
                                 sample_offset=m * sub)
        l_m = image_loss(img, tflat)
        g_m = torch.autograd.grad(l_m, leaves)
        loss = l_m.detach() if loss is None else loss + l_m.detach()
        grads = list(g_m) if grads is None else [a + b for a, b in zip(grads, g_m)]
    if M > 1:
        loss = loss * (1.0 / M)
        grads = [g * (1.0 / M) for g in grads]
    return loss, dict(zip(names, grads))


def make_train_step(optimizer: torch.optim.Optimizer, spp: int,
                    config: PathTracerConfig = PathTracerConfig(),
                    smooth_geometry: int = 0, overlap_microbatches: int = 1):
    """Build the train step
        (params, scene, camera, target, key) -> (loss, grad_norm)
    which updates `params` (a dict of leaf tensors that `optimizer` holds) in
    place. `target` is the (H, W, 3) linear-radiance target; `grad_norm` is
    the global L2 norm of the gradients after smoothing (the in-run training
    scalar next to the loss). See `loss_and_grads` for
    `overlap_microbatches`."""

    def train_step(params, scene, camera, target, key):
        loss, grads = loss_and_grads(params, scene, camera, target, key, spp,
                                     config, overlap_microbatches)
        if smooth_geometry and "mesh_vertices" in grads:
            grads["mesh_vertices"] = smooth_vertex_grads(
                scene, grads["mesh_vertices"], iters=smooth_geometry)
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        for name, p in params.items():
            p.grad = grads[name]
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss, gnorm

    return train_step


def _leaves(values: dict) -> dict:
    return {n: v.detach().clone().requires_grad_() for n, v in values.items()}


def _adam(params: dict, lr: float) -> torch.optim.Adam:
    """`optax.adam(lr)`'s update."""
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def fit(
    scene,
    camera,
    target: torch.Tensor,
    param_names,
    steps: int = 100,
    lr: float = 5e-2,
    spp: int = 4,
    key: torch.Tensor | None = None,
    config: PathTracerConfig = PathTracerConfig(),
    callback=None,
    log_every: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 25,
    smooth_geometry: int = 0,
    overlap_microbatches: int = 1,
):
    """Optimize `param_names` of `scene` so its render matches `target`, on
    the scene's device. Returns (fitted_scene, losses).

    - `log_every=N` prints a line every N steps: step, loss, global gradient
      norm, steps/s, and rays/s (pixels * spp * ~2 queries per bounce).
    - `smooth_geometry=N` Laplacian-smooths the `mesh_vertices` gradient with
      N Jacobi iterations before the optimizer (`smooth_vertex_grads`):
      essential for stable vertex fits at practical sample counts.
    - `checkpoint_path` enables restart: the fit state (parameters, optimizer
      state, step index, RNG key) is saved every `checkpoint_every` steps and
      on completion; calling `fit` again with the same path resumes from the
      last checkpoint and reproduces the uninterrupted run bit-exactly
      (counter-based key schedule, deterministic gradient sums).
    - `callback(i, loss, params)` runs after every step.
    """
    if key is None:
        key = rng.root_key(0, scene.tri_v0.device)
    h, w = target.shape[:2]
    params = _leaves(extract_params(scene, param_names))
    optimizer = _adam(params, lr)
    step_fn = make_train_step(optimizer, spp, config,
                              smooth_geometry=smooth_geometry,
                              overlap_microbatches=overlap_microbatches)
    start = 0
    if checkpoint_path is not None:
        resumed = ckpt.load_fit_state(checkpoint_path, params, optimizer)
        if resumed is not None:
            start, key = resumed

    losses = []
    t_prev = time.perf_counter()
    for i in range(start, steps):
        key, sub = rng.split(key)
        loss, gnorm = step_fn(params, scene, camera, target, sub)
        losses.append(float(loss))
        if log_every and ((i - start) % log_every == 0 or i == steps - 1):
            now = time.perf_counter()
            dt = max(now - t_prev, 1e-9) / max(log_every, 1)
            t_prev = now
            rays = w * h * spp * 2 * config.max_depth / dt
            print(f"[fit] step {i:4d}  loss {losses[-1]:.5f}  "
                  f"|grad| {float(gnorm):.4g}  {1.0 / dt:6.2f} steps/s  "
                  f"~{rays / 1e6:.2f}M rays/s")
        if checkpoint_path is not None and (
                (i + 1) % checkpoint_every == 0 or i + 1 == steps):
            ckpt.save_fit_state(checkpoint_path, params, optimizer, i + 1, key)
        if callback is not None:
            callback(i, losses[-1], params)
    with torch.no_grad():
        fitted = apply_params(scene, {n: p.detach() for n, p in params.items()})
    return fitted, losses


def state_from_jax(params: dict, mu: dict, nu: dict, count: int, step: int,
                   key_data, lr: float, device=None):
    """The JAX package's fit state, as numpy arrays, in the port's form:
    `params`, `mu` and `nu` are dicts by parameter name (the parameters and
    `optax.adam`'s first and second moments), `count` its step count, `step`
    the fit's step index and `key_data` the (2,) uint32 `jax.random.key_data`
    of the next key. Returns (params, optimizer, step, key): leaf tensors on
    `device` (None: the CUDA card) with an Adam that continues where optax's
    stood."""
    device = resolve(device)
    leaves = _leaves({n: torch.as_tensor(np.array(v, np.float32)).to(device)
                      for n, v in params.items()})
    optimizer = _adam(leaves, lr)
    arrays = {}
    if count > 0:
        for i, n in enumerate(leaves):
            arrays[f"o{i}_step"] = np.asarray(count, np.float32)
            arrays[f"o{i}_exp_avg"] = np.asarray(mu[n], np.float32)
            arrays[f"o{i}_exp_avg_sq"] = np.asarray(nu[n], np.float32)
    ckpt.load_adam_state(optimizer, leaves, arrays)
    key = torch.as_tensor(np.asarray(key_data).astype(np.int64)).to(device)
    return leaves, optimizer, int(step), key
