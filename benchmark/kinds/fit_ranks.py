"""The data-parallel fit: `opt.inverse.fit(mesh=launch.global_mesh())` on
every rank of the configuration's `deployment`, one rank a card, over NCCL
(gloo on the CPU), each rank rendering its contiguous shard of the pixels
against the whole scene, the loss and gradients all-reduced every step.

Processes. Rank 0 is the run's own process on `cuda:0`; it starts ranks
1.. as spawned processes (rank r on `cuda:r`), then, while they import, builds
and loads the port's CUDA library and writes the mesh's OBJ file, and only
then lets them on (so no two ranks build at once); they join it through a
file store in the run's temporary directory; the checkpoint is written there
too.
The target is rendered sharded (`parallel.render.render_image_sharded`).
Only rank 0 is timed and traced: its steps are `kinds/fit.py`'s, and in its
traced slice the program's spans are on (`layers.LayerTracer`), so the
trace carries the layers (`trace.layers`) and the counters' change. When
rank 0's window closes it names the late step in the store; every rank
takes that step and stops after it. (The other ranks read the store after
each step: they cannot finish a step before rank 0 has started it, since the
step's all-reduce waits for every rank, so the name is there in time.)

The reference (`reference/fit_ranks.py`) follows the shards: each rank
computes its own shard's losses and gradients on its own card, and the
ranks exchange them through the store, never through the program's NCCL
group. Rank 0 adds `ranks_gap`: the largest difference between any rank's
parameters after the late step and its own (the ranks must stay equal).

CPUs. On the card each rank runs on CPUs of its own (`cpu_plan`): those
the machine lists as local to its card, split among the ranks that share
them by whole cores (by CPUs where the machine lists no cores), so that no
two ranks' dispatch threads share a CPU or migrate onto another rank's;
torch's CPU threads a rank are as many as its CPUs.
Every step waits for the slowest rank, and each rank's step is bound by its
host thread, so a rank that shares a core sets the pace of all four.

Faults. A rank that exits with an error ends the run within a second or
two; if rank 0 makes no progress for `STALL_S` seconds (a rank hung), every
rank is killed and the run ends with exit code 1. A rank whose parent has
gone ends itself.
"""
from __future__ import annotations

import io
import math
import os
import shutil
import sys
import tempfile
import threading
import time
import types
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import layers, loops, scenes, tracing
from ..reference import fit_ranks as ref_ranks, rng as ref_rng
from ..reference import tracer as ref_tracer
from .fit import FitRun, StopWindow, perturbed_start

STALL_S = 90.0     # seconds without progress on rank 0 before the run ends with an error
JOIN_S = 60.0      # seconds the other ranks have to end once rank 0's part is done


class Exchange:
    """Tensors between the ranks through a file store: every rank calls
    `gather` and `share` in the same order."""

    def __init__(self, path: str, world: int, rank: int):
        self.store = dist.FileStore(path, world)
        self.store.set_timeout(timedelta(seconds=STALL_S))
        self.world, self.rank, self.calls = world, rank, 0

    def _tag(self) -> str:
        self.calls += 1
        return f"x{self.calls}"

    def gather(self, flat: torch.Tensor) -> list:
        """This rank's 1-D tensor to every rank's, in rank order, in float64
        on the CPU."""
        tag = self._tag()
        self.store.set(f"{tag}/{self.rank}", flat.detach().double().cpu().numpy().tobytes())
        return [torch.from_numpy(np.frombuffer(self.store.get(f"{tag}/{r}"), np.float64).copy())
                for r in range(self.world)]

    def share(self, obj=None):
        """Rank 0's `obj` (tensors, numbers and dicts of them) on every rank."""
        tag = self._tag()
        if self.rank == 0:
            buf = io.BytesIO()
            torch.save(obj, buf)
            self.store.set(tag, buf.getvalue())
            return obj
        return torch.load(io.BytesIO(self.store.get(tag)), weights_only=True)

    def name_late(self, step: int) -> None:
        self.store.set("late", str(step))

    def is_late(self, step: int) -> bool:
        return self.store.check(["late"]) and int(self.store.get("late")) == step


def _cpu_list(text: str) -> list:
    """A kernel CPU list ("0-3,8,10-11") as CPU numbers."""
    out = []
    for part in text.strip().split(","):
        if part:
            a, _, b = part.partition("-")
            out.extend(range(int(a), int(b or a) + 1))
    return out


def _read_cpus(path: str):
    try:
        with open(path) as f:
            return _cpu_list(f.read())
    except (OSError, ValueError):
        return None


def card_cpus(index: int):
    """The CPUs the machine lists as local to CUDA card `index` (its PCI
    device's `local_cpulist`), or None where it does not say."""
    try:
        p = torch.cuda.get_device_properties(index)
        bus = f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"
    except (AttributeError, RuntimeError):
        return None
    return _read_cpus(f"/sys/bus/pci/devices/{bus}/local_cpulist")


def core_cpus(cpu: int) -> list:
    """The CPUs of `cpu`'s core (itself and its hyperthreads)."""
    return _read_cpus(f"/sys/devices/system/cpu/cpu{cpu}/topology/thread_siblings_list") \
        or [cpu]


def cpu_plan(world: int, allowed, local=lambda r: None, core=core_cpus) -> list:
    """Each rank's CPUs: rank r takes the CPUs of `allowed` that `local(r)`
    lists (all of `allowed` where it lists none of them), and the ranks that
    take the same set split its cores into contiguous runs of whole cores;
    where a set has fewer cores than ranks, they share it."""
    allowed = sorted(allowed)
    sets = [tuple(sorted(set(local(r) or ()) & set(allowed)) or allowed)
            for r in range(world)]
    plan = [None] * world
    for s in dict.fromkeys(sets):
        ranks = [r for r in range(world) if sets[r] == s]
        cores = list(dict.fromkeys(tuple(sorted(set(core(c)) & set(s)) or (c,)) for c in s))
        n, k = len(cores), len(ranks)
        for j, r in enumerate(ranks):
            part = cores[j * n // k:(j + 1) * n // k] if n >= k else cores
            plan[r] = sorted(c for cs in part for c in cs)
    return plan


def pin(cpus) -> None:
    """Every thread of this process, and every thread it starts later, on
    `cpus`; torch's CPU threads as many as `cpus`."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:   # a thread that has ended
            pass
    torch.set_num_threads(len(cpus))


def _cpu(d):
    return {n: (tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu())
            for n, v in d.items()}


def _flat_params(params: dict, names) -> torch.Tensor:
    return torch.cat([params[n].detach().reshape(-1).double() for n in names])


class FitRanksRun(FitRun):
    """One rank of the run; rank 0 without `run_dir` is the run's first
    process: it makes the run's directory and starts the other ranks."""

    def __init__(self, c, seed, seconds, tracer, dev, t0, rank: int = 0,
                 run_dir: str | None = None):
        super().__init__(c, seed, seconds, tracer, dev, t0)
        self.world = self.config["deployment"]["ranks"]
        self.rank, self.run_dir, self.lead = rank, run_dir, run_dir is None
        self.procs, self.beat, self.ready = [], time.monotonic(), None
        if rank == 0 and tracer.active:
            # the program's spans on in the traced slice, on the run's trace
            lt = layers.LayerTracer(True, tracer.trace.kind, tracer.cuda)
            lt.trace = tracer.trace
            self.tr = lt

    # --- processes -----------------------------------------------------------

    def _start_ranks(self):
        ctx = mp.get_context("spawn")
        cuda = torch.device(self.dev).type == "cuda"
        self.plan = [None] * self.world
        if cuda:
            self.plan = cpu_plan(self.world, os.sched_getaffinity(0), card_cpus)
            print(f"fit_ranks: the ranks' CPUs {self.plan}", file=sys.stderr, flush=True)
        self.ready = ctx.Event()
        for r in range(1, self.world):
            p = ctx.Process(target=rank_main, daemon=True,
                            args=(r, self.c, self.seed, self.seconds, self.run_dir,
                                  "cuda" if cuda else "cpu", self.plan[r], self.ready))
            p.start()
            self.procs.append(p)
        self._done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while not self._done.wait(1.0):
            for r, p in enumerate(self.procs, 1):
                if p.exitcode not in (None, 0):
                    self._fail(f"rank {r} exited with code {p.exitcode}")
            if time.monotonic() - self.beat > STALL_S:
                self._fail(f"rank 0 made no progress for {STALL_S:.0f} s: a rank hung")

    def _fail(self, why: str):
        print(f"fit_ranks: {why}; every rank is stopped", file=sys.stderr, flush=True)
        for p in self.procs:
            if p.is_alive():
                p.kill()
        os._exit(1)

    def _join(self):
        from mafrixraytracing_torch.parallel import launch

        cuda = torch.device(self.dev).type == "cuda"
        launch.init(f"file://{os.path.join(self.run_dir, 'store')}", self.world, self.rank,
                    device=None if cuda else "cpu")
        if cuda:
            self.dev = torch.device("cuda", torch.cuda.current_device())
        self.mesh = launch.global_mesh()
        self.ckpt = os.path.join(self.run_dir, "fit")   # rank 0 writes it
        self.exchange = Exchange(os.path.join(self.run_dir, "exchange"), self.world,
                                 self.rank)

    def close(self, failed: bool = False):
        """Every rank: leave the process group; rank 0 then waits for the
        others. (On NCCL the group's teardown waits for every rank, so rank 0
        leaves before it waits.) After a failure of its own, rank 0 stops the
        others and leaves the group as it is: the process is ending."""
        from mafrixraytracing_torch.parallel import launch

        self.beat = time.monotonic()
        if failed:
            for p in self.procs:
                p.kill()
                p.join(5.0)
        else:
            launch.shutdown()
            for r, p in enumerate(self.procs, 1):
                p.join(JOIN_S)
                if p.is_alive() or p.exitcode != 0:
                    self._fail(f"rank {r} did not end cleanly ({p.exitcode})")
        if self.lead:
            self._done.set()
            shutil.rmtree(self.run_dir, ignore_errors=True)

    # --- the run -------------------------------------------------------------

    def setup(self):
        from mafrixraytracing_torch.opt import inverse
        from mafrixraytracing_torch.parallel.render import render_image_sharded

        tf = self.traffic
        self.scale = tf["scene_scale"]
        if self.lead:
            # the other ranks import while this one builds; they touch the
            # library and the OBJ only once `ready` is set
            self.run_dir = tempfile.mkdtemp(prefix="bench_fit_ranks_")
            self._start_ranks()
            if torch.device(self.dev).type == "cuda":
                from mafrixraytracing_torch.ops import cuda as kernels

                kernels.lib()    # built once, by this rank alone
            if self.config["scene"]["builder"] == "seeded_mesh":
                scenes.mesh_obj(self.config["scene"], self.scale)   # written once
            if self.plan[0]:
                pin(self.plan[0])
            self.ready.set()
        elif self.ready is not None and not self.ready.wait(STALL_S):
            raise RuntimeError(f"rank 0 built nothing in {STALL_S:.0f} s")
        self._join()
        self.fit_module = inverse
        # FitRun.window calls `self.inverse.fit`: here, the fit on the mesh
        self.inverse = types.SimpleNamespace(fit=self._fit)
        self.cs = scenes.program_scene(self.config, self.dev, self.scale)
        self.cfg = loops.program_config(self.c)
        sc = self.cs.scene
        self.key_t = loops.seed_key(self.seed, 2, self.dev)
        with torch.no_grad():
            # the target as the deployment renders one: sharded, no compaction
            self.target = render_image_sharded(
                sc, self.cs.camera, self.mesh, self.W, self.H, tf["target_spp"], self.key_t,
                loops.program_config(self.c, compact=()))
            gen = torch.Generator(device=self.dev).manual_seed(self.seed)
            self.phases = torch.rand(2, generator=gen, device=self.dev) * (2.0 * math.pi)
            self.start = perturbed_start(sc.mesh_vertices, sc.mat_albedo, sc.light_radiance,
                                         self.phases, self.scale)
            self.start_scene = self.fit_module.apply_params(sc, self.start)
        self.names = tf["params"]
        self.beat = time.monotonic()

    def _fit(self, *args, callback, checkpoint_path, **kw):
        """Rank 0: `fit` on the mesh with FitRun's timing callback, which
        also names the late step to the other ranks once the window closes."""
        def lead(i, loss, params):
            self.beat = time.monotonic()
            open_window = self.late is None
            try:
                callback(i, loss, params)
            finally:
                if open_window and self.late is not None:
                    self.exchange.name_late(self.late["index"])
                if self.late is not None and "after" in self.late:
                    self.after_late = _flat_params(self.late["after"], self.names)
        return self.fit_module.fit(*args, callback=lead, checkpoint_path=self.ckpt,
                                   mesh=self.mesh, **kw)

    def window(self, trace_units=None):
        if self.rank == 0:
            units = super().window(trace_units)
            if isinstance(self.tr, layers.LayerTracer):
                self.tr.trace.layers = self.tr.layers
            return units
        # ranks 1..: the same fit until the step rank 0 names the late one
        tf = self.traffic
        self.losses = []

        def follow(i, loss, params):
            self.losses.append(loss)
            if self.exchange.is_late(i):
                self.after_late = _flat_params(params, self.names)
                raise StopWindow
        try:
            self.fit_module.fit(
                self.start_scene, self.cs.camera, self.target, self.names, steps=2**31,
                lr=tf["lr"], spp=tf["spp"], key=loops.seed_key(self.seed, 1, self.dev),
                config=self.cfg, callback=follow, checkpoint_path=self.ckpt,
                checkpoint_every=tf["checkpoint_every"],
                smooth_geometry=tf["smooth_geometry"], mesh=self.mesh)
        except StopWindow:
            pass
        self.steps = len(self.losses)
        return self.steps

    def check(self):
        try:
            p = self.program_outputs()
            r = self.reference_outputs(torch.float32)
            out = self.numbers(p, r) if self.rank == 0 else None
        except BaseException:
            self.close(failed=True)
            raise
        self.close()
        return out

    def program_outputs(self):
        every = self.exchange.gather(self.after_late)
        gap = max(float((f - every[0]).abs().max()) for f in every)
        if self.rank == 0:
            out = super().program_outputs()
            out["ranks_gap"] = gap
            return out
        self.cs = self.start_scene = self.start = None
        loops.free(self.dev)
        return None

    def reference_outputs(self, dtype):
        """Every rank: its shard of the reference's first steps from the
        start and of the step after the window from the program's state
        (rank 0's, shared), the shards' means exchanged. Rank 0 also renders
        the target at the sampled pixels, and returns the outputs."""
        tf = self.traffic
        sc, cam = scenes.reference_scene(self.config, self.dev, dtype, self.scale)
        start = perturbed_start(sc.verts, sc.mat_albedo, sc.light_radiance,
                                self.phases.to(dtype), self.scale)
        lf = self.exchange.share(_cpu_state(self.late_from) if self.rank == 0 else None)

        def gather(flats):
            self.beat = time.monotonic()
            return self.exchange.gather(flats[0])
        steps = dict(cam=cam, target=self.target.to(dtype), spp=tf["spp"], lr=tf["lr"],
                     smooth_iters=tf["smooth_geometry"], width=self.W, height=self.H,
                     world=self.world, ranks=[self.rank], gather=gather,
                     compact=self.compact, **self.follow)
        key = loops.seed_key(self.seed, 1, self.dev)
        losses, first, params = ref_ranks.fit_steps(sc, start=start, key=key,
                                                    steps=tf["reference_steps"], **steps)
        for _ in range(lf["index"]):
            key = ref_rng.split(key)[0]
        before = {n: v.to(self.dev, dtype) for n, v in lf["before"].items()}
        moments = {n: (m.to(self.dev, dtype), s.to(self.dev, dtype))
                   for n, (m, s) in lf["moments"].items()}
        l_loss, l_grad, l_params = ref_ranks.fit_steps(
            sc, start=before, steps=1, key=key, moments=moments, count=lf["index"], **steps)
        if self.rank != 0:
            return None
        target = ref_tracer.render_pixels(
            sc, cam, self.ids, self.W, self.H, tf["target_spp"], self.key_t, **self.follow)
        return {"start_mv": start["mesh_vertices"].float().cpu(),
                "target": target.detach().float().cpu(), "losses": losses,
                "first": {n: g.float().cpu() for n, g in first.items()},
                "change": {n: (params[n] - start[n]).float().cpu() for n in self.names},
                "late_loss": l_loss[0],
                "late_grad": {n: g.float().cpu() for n, g in l_grad.items()},
                "late_change": {n: (l_params[n] - before[n]).float().cpu() for n in self.names},
                # the reference's shards are averaged in one sum: its ranks are equal
                "ranks_gap": 0.0}

    @staticmethod
    def numbers(p, r):
        return {**FitRun.numbers(p, r), "ranks_gap": p["ranks_gap"]}


def _cpu_state(lf):
    return {"index": lf["index"], "before": _cpu(lf["before"]), "moments": _cpu(lf["moments"])}


def _end_with_parent(parent: int):
    """Ends this process when the process that started it has gone."""
    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def rank_main(rank, c, seed, seconds, run_dir, dev_type, cpus=None, ready=None):
    """Rank `rank` (1..) of a run whose rank 0 started it: the fit on its
    card until rank 0 names the late step, then its shard of the reference.
    It waits for `ready` (rank 0 has built the library and the OBJ) before
    its set-up, runs on `cpus` (all it may use where None), its standard output goes
    to standard error (the result line is rank 0's), it ends when rank 0's
    process has gone, and float32 products stay float32, as in run.py."""
    if cpus:
        pin(cpus)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    _end_with_parent(os.getppid())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = FitRanksRun(c, seed, seconds, tracing.Tracer(False, c["traffic"]["kind"],
                                                       dev_type == "cuda"),
                      torch.device(dev_type), time.perf_counter(), rank=rank, run_dir=run_dir)
    run.ready = ready
    run.setup()
    run.window()
    run.check()


RUN = FitRanksRun
