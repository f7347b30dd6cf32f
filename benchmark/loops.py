"""The general generator's shared part. Each kind of traffic is a module of
`benchmark/kinds/`, named by the traffic file's `kind` and found by that
name (`manifest.kind`); its class `RUN` builds the inputs from the seed,
warms up the shapes it uses (set-up), runs its unit of work back to back
for the window, keeps what the window produced, and hands that to the
reference once the window has closed. A new kind is a new module there.
"""
from __future__ import annotations

import gc
import time

import torch

from . import scenes
from .reference import rng as ref_rng
from .reference import tracer as ref_tracer


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def seed_key(seed: int, i: int, dev) -> torch.Tensor:
    """The key of stream `i` of a run of seed `seed`."""
    return ref_rng.fold_in(ref_rng.root_key(seed, dev), i)


def program_config(c: dict, compact=None):
    """The program's `PathTracerConfig`: the configuration's `integrator`
    settings whole, and the cell's frozen compaction schedule (or
    `compact`); a setting the program does not have is refused."""
    from mafrixraytracing_torch.integrator.path import PathTracerConfig

    sched = c["cell"]["compact"] if compact is None else compact
    return PathTracerConfig(**c["config"]["integrator"], compact=tuple(sched))


def free(dev):
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


class Run:
    """One run of one cell: `setup`, `window`, `outcome` (end-to-end
    metrics and attempted / failed), then `check` (the comparison)."""

    def __init__(self, c: dict, seed: int, seconds: float, tracer, dev, t0: float):
        self.c, self.seed, self.seconds, self.tr, self.dev = c, seed, seconds, tracer, dev
        self.t0 = t0
        self.traffic = c["traffic"]
        self.config = c["config"]
        self.W, self.H = scenes.film(self.config)
        # the reference's render settings; a setting it cannot follow is
        # refused here, before anything runs
        self.follow = ref_tracer.follow(self.config["integrator"])
        self.compact = tuple(c["cell"]["compact"])
        self.setup_s = None

    def loop(self, unit, trace_units=None):
        """`unit(i)` back to back from i = 0, each ending synchronised.
        Measured run: for `seconds`, ending at a unit's end; returns (units,
        seconds). Traced run: `trace_units` units without the profiler,
        their seconds kept as the trace's `plain_s`, then as many under it;
        returns (units under the profiler, seconds of all)."""
        t_start = time.perf_counter()
        self.setup_s = t_start - self.t0
        i = 0
        while True:
            if trace_units and i == trace_units:
                self.tr.trace.plain_s = time.perf_counter() - t_start
                self.tr.start()
            unit(i)
            i += 1
            el = time.perf_counter() - t_start
            if (trace_units and i == 2 * trace_units) or (not trace_units and el >= self.seconds):
                return (trace_units or i), el

    def check(self):
        """The numbers that decide `correct`: the program's outputs against
        the reference's, computed once the window has closed and the
        program's state is freed."""
        p = self.program_outputs()
        return self.numbers(p, self.reference_outputs(torch.float32))
