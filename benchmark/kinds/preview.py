"""The live progressive preview: a pass is `render_sample_batch` under
`no_grad`, `FilmState.add_frame`, `to_bytes()` copied to the host."""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import loops, scenes
from ..reference import compare, film as ref_film
from ..reference import tracer as ref_tracer


class PreviewRun(loops.Run):
    def setup(self):
        if self.compact:
            raise ValueError("the reference's film follows passes without compaction")
        from mafrixraytracing_torch.film.film import FilmState
        from mafrixraytracing_torch.integrator.path import render_sample_batch

        self.FilmState, self.render = FilmState, render_sample_batch
        self.cs = scenes.program_scene(self.config, self.dev)
        self.cfg = loops.program_config(self.c)
        self.key = loops.seed_key(self.seed, 0, self.dev)
        warm = self.FilmState.create(self.H, self.W, device=self.dev)
        wkey = loops.seed_key(self.seed, 2**31, self.dev)
        for s in range(self.traffic["warmup_units"]):
            warm = self.one(warm, s, wkey)[0]
        loops.sync(self.dev)

    def one(self, film, s, key):
        with self.tr.span("forward"):
            with torch.no_grad():
                frame = self.render(self.cs.scene, self.cs.camera, self.W, self.H, s, key,
                                    self.cfg)
        with self.tr.span("film"):
            film = film.add_frame(frame.reshape(self.H, self.W, 3))
            out = film.to_bytes().cpu()
        return film, out

    def window(self, trace_units=None):
        self.film = self.FilmState.create(self.H, self.W, device=self.dev)
        self.times = []

        def unit(s):
            t = time.perf_counter()
            self.film, self.bytes = self.one(self.film, s, self.key)
            self.times.append(time.perf_counter() - t)
        units, self.window_s = self.loop(unit, trace_units)
        self.passes = len(self.times)
        return units

    def outcome(self):
        bad = 0 if bool(torch.isfinite(self.film.radiance_sum).all()) else 1
        return self.passes, bad, {
            "preview_passes_per_s": self.passes / self.window_s,
            "preview_pass_ms_p95": float(np.percentile(np.array(self.times) * 1e3, 95)),
        }

    def program_outputs(self):
        n_pix = min(self.traffic["check_pixels"], self.W * self.H)
        self.ids = np.sort(np.random.default_rng(self.seed).choice(
            self.W * self.H, n_pix, replace=False))
        ids = torch.as_tensor(self.ids)
        out = {"sum": self.film.radiance_sum.reshape(-1, 3).cpu()[ids],
               "bytes": self.bytes.reshape(-1, 3)[ids],
               "count": int(self.film.frame_count)}
        self.film = self.cs = None
        loops.free(self.dev)
        return out

    def reference_outputs(self, dtype):
        sc, cam = scenes.reference_scene(self.config, self.dev, dtype)
        total = ref_tracer.film_sum(sc, cam, torch.as_tensor(self.ids, device=self.dev),
                                    self.W, self.H, self.passes, self.key,
                                    self.follow["depth"], self.follow["rr_start"]).float().cpu()
        return {"sum": total, "bytes": ref_film.to_bytes(total / self.passes),
                "count": self.passes}

    @staticmethod
    def numbers(p, r):
        off = (p["bytes"].to(torch.int32) - r["bytes"].to(torch.int32)).abs() > 1
        return {"film_rel_l1": compare.rel_l1(p["sum"], r["sum"]),
                "bytes_off_share": float(off.float().mean()),
                "frames_gap": float(abs(p["count"] - r["count"]))}


RUN = PreviewRun
