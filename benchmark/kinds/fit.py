"""The inverse-rendering fit: `opt.inverse.fit`, its steps timed from its
`callback`. Its first `reference_steps` steps are set-up, and the
reference follows them from the start; once the window has closed, one
more step runs untimed, and the reference takes that step too, from the
program's parameters and Adam moments as the window left them."""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch
from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                   register_optimizer_step_pre_hook)

from .. import loops, scenes
from ..reference import compare, fit as ref_fit, rng as ref_rng
from ..reference import tracer as ref_tracer


class StopWindow(Exception):
    """Raised from the fit's callback after the step that follows the window."""


def perturbed_start(mv, albedo, radiance, phases, scale):
    """The fit's start: the vertices displaced along y by a smooth field
    with the seed's phases, the ground's albedo at 0.1, the light at 0.9."""
    mv = mv.clone()
    mv[:, 1] += 0.03 * scale * (torch.sin(3.0 * mv[:, 0] / scale + phases[0])
                                * torch.cos(2.0 * mv[:, 2] / scale + phases[1]))
    albedo = albedo.clone()
    albedo[1] = torch.tensor([0.1, 0.1, 0.1], dtype=albedo.dtype, device=albedo.device)
    return {"mat_albedo": albedo, "light_radiance": radiance * 0.9, "mesh_vertices": mv}


class FitRun(loops.Run):
    def setup(self):
        from mafrixraytracing_torch.integrator.path import render_flat_pixels
        from mafrixraytracing_torch.opt import inverse

        self.inverse = inverse
        tf = self.traffic
        self.scale = tf["scene_scale"]
        self.cs = scenes.program_scene(self.config, self.dev, self.scale)
        self.cfg = loops.program_config(self.c)
        sc = self.cs.scene
        self.key_t = loops.seed_key(self.seed, 2, self.dev)
        with torch.no_grad():
            # the target, as a user renders one: every pixel, no compaction
            self.target = render_flat_pixels(
                sc, self.cs.camera, torch.arange(self.W * self.H, device=self.dev),
                self.W, self.H, tf["target_spp"], self.key_t,
                loops.program_config(self.c, compact=())).reshape(self.H, self.W, 3)
            gen = torch.Generator(device=self.dev).manual_seed(self.seed)
            self.phases = torch.rand(2, generator=gen, device=self.dev) * (2.0 * math.pi)
            self.start = perturbed_start(sc.mesh_vertices, sc.mat_albedo, sc.light_radiance,
                                         self.phases, self.scale)
            self.start_scene = inverse.apply_params(sc, self.start)
        self.names = tf["params"]

    def _moments(self, params):
        """Adam's moments of each parameter as the optimizer holds them
        (zeros where it holds none)."""
        out = {}
        for n in self.names:
            st = self.opt.state.get(params[n], {}) if self.opt is not None else {}
            z = torch.zeros_like(params[n])
            out[n] = (st.get("exp_avg", z).detach().clone(),
                      st.get("exp_avg_sq", z).detach().clone())
        return out

    def window(self, trace_units=None):
        tf = self.traffic
        follow = tf["reference_steps"]
        self.losses, self.first_grad, self.after, self.opt = [], None, None, None
        self.late = None
        st = {"t_start": None, "steps": 0, "close": lambda: None, "late_grad": False}

        def pre_hook(opt, args, kwargs):
            if st["late_grad"]:   # the gradient of the late step, as Adam gets it
                self.late["grad"] = {
                    n: (p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p))
                    for n, p in zip(self.names, opt.param_groups[0]["params"])}

        def post_hook(opt, args, kwargs):
            self.opt = opt
            # Adam's first moment after its first step is (1 - beta1) g
            if self.first_grad is None and all("exp_avg" in opt.state[p]
                                               for p in opt.param_groups[0]["params"]):
                b1 = opt.param_groups[0]["betas"][0]
                self.first_grad = {
                    n: (opt.state[p]["exp_avg"] / (1.0 - b1)).detach().clone()
                    for n, p in zip(self.names, opt.param_groups[0]["params"])}

        def callback(i, loss, params):
            now = time.perf_counter()
            st["close"]()
            self.losses.append(loss)
            if self.late is not None:
                self.late.update(loss=loss, after={
                    n: params[n].detach().clone() for n in self.names})
                raise StopWindow
            if i == follow - 1:
                self.after = {n: params[n].detach().clone() for n in self.names}
                self.setup_s = now - self.t0
                st["t_start"] = now
            elif i >= follow:
                st["steps"] += 1
                el = now - st["t_start"]
                if trace_units and st["steps"] == trace_units:
                    self.tr.trace.plain_s = el
                    self.tr.start()
                if (trace_units and st["steps"] == 2 * trace_units) or \
                        (not trace_units and el >= self.seconds):
                    # the window has closed: keep the state for the late step
                    st["el"] = el
                    self.tr.stop(trace_units)
                    self.late = {"index": i + 1, "grad": None,
                                 "before": {n: params[n].detach().clone() for n in self.names},
                                 "moments": self._moments(params)}
                    st["late_grad"] = True
                    return
            st["close"] = self.tr.open_span("fit_step")

        handles = [register_optimizer_step_pre_hook(pre_hook),
                   register_optimizer_step_post_hook(post_hook)]
        ckdir = tempfile.mkdtemp(prefix="bench_fit_")
        try:
            self.inverse.fit(
                self.start_scene, self.cs.camera, self.target, self.names, steps=2**31,
                lr=tf["lr"], spp=tf["spp"], key=loops.seed_key(self.seed, 1, self.dev),
                config=self.cfg, callback=callback,
                checkpoint_path=os.path.join(ckdir, "fit"),
                checkpoint_every=tf["checkpoint_every"],
                smooth_geometry=tf["smooth_geometry"])
        except StopWindow:
            pass
        finally:
            for h in handles:
                h.remove()
            shutil.rmtree(ckdir, ignore_errors=True)
        self.window_s = st["el"]
        self.steps = st["steps"]
        return trace_units or self.steps

    def outcome(self):
        bad = sum(1 for x in self.losses if not math.isfinite(x))
        return self.steps, bad, {"fit_step_s": self.window_s / self.steps}

    def program_outputs(self):
        n_pix = min(self.traffic["check_pixels"], self.W * self.H)
        self.ids = torch.as_tensor(np.sort(np.random.default_rng(self.seed).choice(
            self.W * self.H, n_pix, replace=False)), device=self.dev)
        follow = self.traffic["reference_steps"]
        late = self.late
        zeros = {n: torch.zeros_like(self.start[n]).cpu() for n in self.names}
        out = {"start_mv": self.start["mesh_vertices"].cpu(),
               "target": self.target.reshape(-1, 3)[self.ids].cpu(),
               "losses": self.losses[:follow],
               # no optimizer step ran (a fault): no gradient reached it
               "first": ({n: g.cpu() for n, g in self.first_grad.items()} if self.first_grad
                         else zeros),
               "change": {n: (self.after[n] - self.start[n]).cpu() for n in self.names},
               "late_loss": late["loss"],
               "late_grad": ({n: g.cpu() for n, g in late["grad"].items()} if late["grad"]
                             else zeros),
               "late_change": {n: (late["after"][n] - late["before"][n]).cpu()
                               for n in self.names}}
        # what the reference's late step starts from: the program's state
        self.late_from = {"index": late["index"], "before": late["before"],
                          "moments": late["moments"]}
        self.cs = self.start_scene = self.start = self.after = self.first_grad = None
        self.late = self.opt = None
        loops.free(self.dev)
        return out

    def reference_outputs(self, dtype):
        """The reference's start, its target at the sampled pixels, its
        first steps from the start against the program's target (the one
        stage it takes from the program, checked on the sample by itself),
        and the step after the window from the program's parameters and
        Adam moments (the state that the window's steps left)."""
        tf = self.traffic
        sc, cam = scenes.reference_scene(self.config, self.dev, dtype, self.scale)
        start = perturbed_start(sc.verts, sc.mat_albedo, sc.light_radiance,
                                self.phases.to(dtype), self.scale)
        target = ref_tracer.render_pixels(
            sc, cam, self.ids, self.W, self.H, tf["target_spp"], self.key_t, **self.follow)
        steps = dict(cam=cam, target=self.target.to(dtype), spp=tf["spp"], lr=tf["lr"],
                     smooth_iters=tf["smooth_geometry"], width=self.W, height=self.H,
                     compact=self.compact, **self.follow)
        key = loops.seed_key(self.seed, 1, self.dev)
        losses, first, params = ref_fit.fit_steps(sc, start=start, steps=tf["reference_steps"],
                                                  key=key, **steps)
        lf = self.late_from
        for _ in range(lf["index"]):
            key = ref_rng.split(key)[0]
        before = {n: v.to(dtype) for n, v in lf["before"].items()}
        moments = {n: (m.to(dtype), s.to(dtype)) for n, (m, s) in lf["moments"].items()}
        l_loss, l_grad, l_params = ref_fit.fit_steps(
            sc, start=before, steps=1, key=key, moments=moments, count=lf["index"], **steps)
        return {"start_mv": start["mesh_vertices"].float().cpu(),
                "target": target.detach().float().cpu(), "losses": losses,
                "first": {n: g.float().cpu() for n, g in first.items()},
                "change": {n: (params[n] - start[n]).float().cpu() for n in self.names},
                "late_loss": l_loss[0],
                "late_grad": {n: g.float().cpu() for n, g in l_grad.items()},
                "late_change": {n: (l_params[n] - before[n]).float().cpu() for n in self.names}}

    @staticmethod
    def numbers(p, r):
        return {
            "start_gap": float((p["start_mv"] - r["start_mv"]).abs().max()),
            "target_rel_l1": compare.rel_l1(p["target"], r["target"]),
            "loss1_gap": compare.loss_gap(p["losses"][:1], r["losses"][:1]),
            "loss_gap": compare.loss_gap(p["losses"], r["losses"]),
            "grad1_gap": compare.norm_gap(p["first"], r["first"]),
            "change3_gap": compare.norm_gap(p["change"], r["change"],
                                            compare.moved_leaves(r["first"])),
            "late_loss_gap": compare.loss_gap([p["late_loss"]], [r["late_loss"]]),
            "late_grad_gap": compare.norm_gap(p["late_grad"], r["late_grad"]),
            "late_change_gap": compare.norm_gap(p["late_change"], r["late_change"],
                                                compare.moved_leaves(r["late_grad"])),
        }


RUN = FitRun
