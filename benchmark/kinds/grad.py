"""Gradient renders: a frame is `render_image` and `.backward()` of the
mean image to the traffic's leaves; the window ends at a frame's end."""
from __future__ import annotations

import numpy as np
import torch

from .. import loops, scenes
from ..reference import compare
from ..reference import tracer as ref_tracer


class GradRun(loops.Run):
    def setup(self):
        from mafrixraytracing_torch.integrator.path import render_image

        self.render_image = render_image
        self.cs = scenes.program_scene(self.config, self.dev)
        self.cfg = loops.program_config(self.c)
        self.names = self.traffic["grad_leaves"]
        for w in range(self.traffic["warmup_units"]):
            self.frame(loops.seed_key(self.seed, 2**31 + w, self.dev))
        loops.sync(self.dev)

    def frame(self, key):
        sc = self.cs.scene
        leaves = {n: getattr(sc, n).detach().clone().requires_grad_() for n in self.names}
        with self.tr.span("forward"):
            img = self.render_image(sc.replace(**leaves), self.cs.camera, self.W, self.H,
                                    self.traffic["spp"], key, self.cfg)
        with self.tr.span("backward"):
            img.mean().backward()
        loops.sync(self.dev)
        return img.detach(), {n: v.grad for n, v in leaves.items()}

    def window(self, trace_units=None):
        self.kept = []

        def unit(i):
            with self.tr.peak_memory("peak_frame_bytes"):
                self.kept.append(self.frame(loops.seed_key(self.seed, i, self.dev)))
        units, self.window_s = self.loop(unit, trace_units)
        return units

    def outcome(self):
        n = len(self.kept)
        bad = sum(1 for img, g in self.kept
                  if not (torch.isfinite(img).all()
                          and all(torch.isfinite(x).all() for x in g.values())))
        samples = n * self.W * self.H * self.traffic["spp"]
        return n, bad, {"grad_samples_per_s": samples / self.window_s}

    def program_outputs(self):
        self.j = int(np.random.default_rng(self.seed).integers(len(self.kept)))
        img, grads = self.kept[self.j]
        out = {"image": img.cpu(), "grads": {k: v.cpu() for k, v in grads.items()}}
        self.kept = self.cs = None
        loops.free(self.dev)
        return out

    def reference_outputs(self, dtype):
        sc, cam = scenes.reference_scene(self.config, self.dev, dtype)
        leaves = {n: getattr(sc, n).detach().clone().requires_grad_() for n in self.names}
        img = ref_tracer.render_image(
            sc.replace(**leaves), cam, self.W, self.H, self.traffic["spp"],
            loops.seed_key(self.seed, self.j, self.dev), compact=self.compact,
            **self.follow)
        img.float().mean().backward()
        return {"image": img.detach().float().cpu(),
                "grads": {n: v.grad.float().cpu() for n, v in leaves.items()}}

    @staticmethod
    def numbers(p, r):
        nums = {"image_rel_l1": compare.rel_l1(p["image"], r["image"])}
        for n in r["grads"]:
            nums[f"grad_{n}_rel_l2"] = compare.rel_l2(p["grads"][n], r["grads"][n])
        return nums


RUN = GradRun
