"""Checkpoint and resume for progressive renders and inverse-rendering fits.

Port of `mafrixraytracing_tpu/utils/checkpoint.py`, on `np.savez`. The
progressive film is resumable state (the reference's `Film.texture` +
`frameCount`, `Core/Film.fs:17-23`): radiance sum, frame count, seed and next
sample index. A fit's state is its parameters, the Adam moments and step
counts, the step index and the next RNG key; every array is stored as it is,
so a resumed run continues from the same bits.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.film.film import FilmState
from mafrixraytracing_torch.scene.compiler import (
    STATIC_FLAGS,
    TENSOR_FIELDS,
    TorchScene,
    from_jax_arrays,
)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_render_state(path: str, film: FilmState, next_sample: int, seed: int) -> None:
    np.savez(path, radiance_sum=_np(film.radiance_sum),
             frame_count=_np(film.frame_count),
             next_sample=np.asarray(next_sample), seed=np.asarray(seed))


def load_render_state(path: str, device=None):
    """Returns (FilmState, next_sample, seed) on `device` (None: the CUDA
    card). Resuming with the same scene and the returned seed and sample
    index reproduces the uninterrupted render bit-exactly (counter-based
    RNG: keys depend only on logical indices)."""
    device = resolve(device)
    with np.load(_npz(path)) as z:
        film = FilmState(torch.as_tensor(z["radiance_sum"]).to(device),
                         torch.as_tensor(z["frame_count"]).to(device))
        return film, int(z["next_sample"]), int(z["seed"])


def save_scene(path: str, scene: TorchScene) -> None:
    """Persist a `TorchScene` (for example a fitted result), tensors by
    field name and the static flags beside them."""
    flat = {k: _np(getattr(scene, k)) for k in TENSOR_FIELDS}
    flat.update({f"flag_{k}": np.asarray(getattr(scene, k)) for k in STATIC_FLAGS})
    np.savez(path, **flat)


def load_scene(path: str, device=None) -> TorchScene:
    with np.load(_npz(path)) as z:
        arrays = {k: z[k] for k in TENSOR_FIELDS}
        flags = {k: z[f"flag_{k}"].item() for k in STATIC_FLAGS}
    return from_jax_arrays(arrays, flags, device=device)


def adam_state_arrays(optimizer: torch.optim.Adam, params: dict) -> dict:
    """The optimizer's state flattened to numpy arrays: for parameter i (in
    the dict's order) `o{i}_step`, `o{i}_exp_avg`, `o{i}_exp_avg_sq`.
    Parameters that have taken no step yet have no entry."""
    flat = {}
    for i, p in enumerate(params.values()):
        st = optimizer.state.get(p)
        if st:
            flat[f"o{i}_step"] = _np(torch.as_tensor(st["step"]))
            flat[f"o{i}_exp_avg"] = _np(st["exp_avg"])
            flat[f"o{i}_exp_avg_sq"] = _np(st["exp_avg_sq"])
    return flat


def load_adam_state(optimizer: torch.optim.Adam, params: dict, arrays) -> None:
    """Restore what `adam_state_arrays` flattened, exactly."""
    state = {}
    for i, p in enumerate(params.values()):
        if f"o{i}_step" in arrays:
            state[i] = {
                k: torch.as_tensor(np.array(arrays[f"o{i}_{k}"])).to(
                    "cpu" if k == "step" else p.device)
                for k in ("step", "exp_avg", "exp_avg_sq")
            }
    optimizer.load_state_dict(
        {"state": state, "param_groups": optimizer.state_dict()["param_groups"]})


def save_fit_state(path: str, params: dict, optimizer: torch.optim.Adam,
                   step: int, key: torch.Tensor) -> None:
    """Persist an inverse-rendering fit's full state (parameters, optimizer
    state, step index, the next key of the split chain) for a restart
    (`opt.inverse.fit(checkpoint_path=...)`). Written under another name and
    moved into place, so a crash leaves the previous checkpoint whole."""
    flat = {f"p{i}": _np(p) for i, p in enumerate(params.values())}
    flat.update(adam_state_arrays(optimizer, params))
    flat["step"] = np.asarray(step)
    flat["key"] = _np(key).astype(np.uint32)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, _npz(path))


def load_fit_state(path: str, params: dict, optimizer: torch.optim.Adam):
    """Restore a fit's state in place into `params` and `optimizer`.
    Returns (step, key) or None if no checkpoint exists. Resuming reproduces
    the uninterrupted fit bit-exactly: the key saved is the next one in the
    split chain."""
    if not os.path.exists(_npz(path)):
        return None
    with np.load(_npz(path)) as z:
        with torch.no_grad():
            for i, p in enumerate(params.values()):
                p.copy_(torch.as_tensor(z[f"p{i}"]))
        load_adam_state(optimizer, params, z)
        step = int(z["step"])
        device = next(iter(params.values())).device
        key = torch.as_tensor(z["key"].astype(np.int64)).to(device)
    return step, key
