"""Faults planted in the measured program, to show that the comparison
rejects them: each is a context manager that patches one of the program's
functions for the run made under it. Used by `calibrate.py` (readings on
the card) and by the benchmark's tests (on the CPU). The exchange between
cards has no fault here: every cell runs on one card and exchanges nothing.

- unchanged: a step returns its state unchanged (the fit's optimizer step
  does nothing; the preview's film does not take the pass).
- unchanged_late: the fit's optimizer steps do nothing after the first
  three, the set-up's: a fault that only the step after the window shows.
- half: half of the batch left out, the mean taken over the rest (the
  frame's samples, the pass's pixels, the loss's pixels).
- altered: an answer altered where it is produced: one pixel in a hundred
  doubled as the renderer returns it.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import torch


def _double_some(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1, 3)
    scale = torch.ones(flat.shape[0], 1, dtype=flat.dtype, device=flat.device)
    scale[::100] = 2.0
    return (flat * scale).reshape(x.shape)


@contextlib.contextmanager
def planted(kind: str, fault: str):
    from mafrixraytracing_torch.film import film as film_mod
    from mafrixraytracing_torch.integrator import path
    from mafrixraytracing_torch.opt import inverse

    patches = []
    if kind == "grad" and fault == "half":
        orig = path.render_image

        def half(scene, camera, w, h, spp, key, config):
            return orig(scene, camera, w, h, max(1, spp // 2), key, config)
        patches.append(mock.patch.object(path, "render_image", half))
    elif kind == "grad" and fault == "altered":
        orig = path.render_image
        patches.append(mock.patch.object(
            path, "render_image", lambda *a, **k: _double_some(orig(*a, **k))))
    elif kind == "preview" and fault == "unchanged":
        patches.append(mock.patch.object(film_mod.FilmState, "add_frame",
                                         lambda self, frame: self))
    elif kind == "preview" and fault == "half":
        orig = path.render_sample_batch

        def half(*a, **k):
            out = orig(*a, **k).clone()
            out[1::2] = out[0::2][: out[1::2].shape[0]]
            return out
        patches.append(mock.patch.object(path, "render_sample_batch", half))
    elif kind == "preview" and fault == "altered":
        orig = path.render_sample_batch
        patches.append(mock.patch.object(
            path, "render_sample_batch", lambda *a, **k: _double_some(orig(*a, **k))))
    elif kind == "fit" and fault == "unchanged":
        patches.append(mock.patch.object(torch.optim.Adam, "step",
                                         lambda self, closure=None: None))
    elif kind == "fit" and fault == "unchanged_late":
        orig, calls = torch.optim.Adam.step, [0]

        def late_noop(self, closure=None):
            calls[0] += 1
            return orig(self, closure) if calls[0] <= 3 else None
        patches.append(mock.patch.object(torch.optim.Adam, "step", late_noop))
    elif kind == "fit" and fault == "half":
        def half_loss(img, target):
            n = img.shape[0] // 2
            d = img[:n] - target[:n]
            return torch.mean(d * d / (target[:n] * target[:n] + 1e-2))
        patches.append(mock.patch.object(inverse, "image_loss", half_loss))
    elif kind == "fit" and fault == "altered":
        orig = inverse.render_flat_pixels
        patches.append(mock.patch.object(
            inverse, "render_flat_pixels", lambda *a, **k: _double_some(orig(*a, **k))))
    else:
        raise ValueError(f"no fault {fault!r} for {kind!r}")
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield


FAULTS = {"grad": ("half", "altered"), "preview": ("unchanged", "half", "altered"),
          "fit": ("unchanged", "unchanged_late", "half", "altered")}
