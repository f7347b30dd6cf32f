"""The traced run: `torch.profiler` over a fixed slice of units, run after
as many units without it, and the benchmark's own spans around its calls
into each layer, synchronised in the traced slice only. The reduction
takes the device's busy time as the union of the intervals in which a
kernel, copy or fill ran, the idle gaps as the rest of the window, each
named by the innermost benchmark span it fell in, and the kernels by
name."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

PREFIX = "bench."


@dataclass
class Trace:
    """What the per-layer readers read (`metrics/<name>.py`)."""
    kind: str
    units: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    plain_s: float = 0.0    # the seconds of as many units just before, unprofiled
    kernels: list = field(default_factory=list)     # (name, device seconds)
    spans: dict = field(default_factory=dict)       # name -> [seconds]
    counters: dict = field(default_factory=dict)    # name -> number
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


class Tracer:
    """Spans and the profiler of one run. Outside the profiled slice (and
    in the measured runs) a span is a bare `yield`: no synchronisation, no
    record."""

    def __init__(self, active: bool, kind: str, cuda: bool):
        self.active, self.cuda = active, cuda
        self.trace = Trace(kind)
        self._prof = None
        self.peak_bytes = 0

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        if self._prof is None:
            yield
            return
        self._sync()
        t = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            yield
            self._sync()
        self.trace.spans.setdefault(name, []).append(time.perf_counter() - t)

    @contextlib.contextmanager
    def peak_memory(self, counter: str):
        """In the profiled slice on a card: the device memory's peak over
        the block, its statistics reset at the block's start, as the
        largest reading of `counter`. The run's own peak is kept in
        `peak_bytes`, since the reset clears it."""
        if self._prof is None or not self.cuda:
            yield
            return
        self.peak_bytes = max(self.peak_bytes, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        yield
        p = torch.cuda.max_memory_allocated()
        self.peak_bytes = max(self.peak_bytes, p)
        self.trace.counters[counter] = max(self.trace.counters.get(counter, 0), p)

    def open_span(self, name: str):
        """A span opened now and closed by the returned function (for
        spans between two callbacks of the program)."""
        if self._prof is None:
            return lambda: None
        self._sync()
        t = time.perf_counter()
        rf = torch.profiler.record_function(PREFIX + name)
        rf.__enter__()

        def close():
            self._sync()
            rf.__exit__(None, None, None)
            self.trace.spans.setdefault(name, []).append(time.perf_counter() - t)
        return close

    def start(self):
        if not self.active:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(PREFIX + "window")
        self._window.__enter__()

    def stop(self, units: int):
        if self._prof is None:
            return
        self._sync()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.trace.units = units
        reduce(self._prof, self.trace)
        self._prof = None


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged (start, end) intervals of an (n, 2) array."""
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.r_[np.nonzero(new)[0][1:] - 1, len(iv) - 1]
    return np.stack([starts, ends[last]], 1)


def reduce(prof, trace: Trace) -> None:
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PREFIX) and e.device_type() == torch.autograd.DeviceType.CUDA:
            continue   # the spans' own marks on the device's timeline
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name().startswith(PREFIX):
            host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    win = [h for h in host if h[0] == PREFIX + "window"]
    w0, w1 = (win[0][1], win[0][2]) if win else (0, 0)
    trace.window_s = (w1 - w0) / 1e9
    iv = np.array([[max(s, w0), min(e, w1)] for _, s, e in device if e > w0 and s < w1],
                  dtype=np.int64).reshape(-1, 2)
    busy = _union(iv)
    trace.busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
    trace.kernels = [(n, (e - s) / 1e9) for n, s, e in device
                     if not n.startswith(("Memcpy", "Memset")) and s < w1 and e > w0]
    by = {}
    for n, s in trace.kernels:
        by[n] = by.get(n, 0.0) + s
    trace.device_ops = [[n[:120], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:10]]
    # idle gaps inside the window, each named by the innermost span around it
    edges = np.r_[w0, busy.reshape(-1), w1].reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    spans = sorted((h for h in host if h[0] != PREFIX + "window"), key=lambda h: h[1])
    starts = np.array([s for _, s, _ in spans], dtype=np.int64)
    named = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        k = int(np.searchsorted(starts, mid, side="right")) - 1
        # the benchmark's spans do not nest: the last to start before the
        # gap holds it, or the gap fell between two units
        name = spans[k][0][len(PREFIX):] if k >= 0 and spans[k][2] >= mid else "between units"
        acc = named.setdefault(name, [0.0, 0])
        acc[0] += (g1 - g0) / 1e9
        acc[1] += 1
    trace.idle_gaps = [[f"idle in {n} ({v[1]} gaps)", v[0]]
                       for n, v in sorted(named.items(), key=lambda kv: -kv[1][0])][:10]


# the port's search kernels by CUDA function name (a frozen copy of the
# map in mafrixraytracing_torch/profile_bench.py): A, B, D-I and the cull K
SEARCH_KERNELS = ("closest_kernel", "anyhit_kernel", "closest_super_kernel",
                  "anyhit_super_kernel", "fused_closest_kernel", "fused_anyhit_kernel",
                  "fused_closest_super_kernel", "fused_anyhit_super_kernel", "cull_kernel")
# every hand-written kernel of the port (mafrixraytracing_torch/csrc/*.cu)
PORT_KERNELS = SEARCH_KERNELS + ("closest_stats_kernel", "unpack_kernel",
                                 "scatter_chunk_kernel", "scatter_combine_kernel")
SCATTER_KERNELS = ("scatter_chunk_kernel", "scatter_combine_kernel")


def named(name: str, functions) -> bool:
    """Whether a kernel's (demangled) name is one of `functions`."""
    import re

    return any(re.search(rf"\b{f}\b", name) for f in functions)


def device_ms(trace: Trace, functions=None, exclude=None) -> float:
    """Device milliseconds of the traced kernels named by `functions` (all
    when None), less those named by `exclude`; None if no kernel counts."""
    total, found = 0.0, False
    for n, s in trace.kernels:
        if functions is not None and not named(n, functions):
            continue
        if exclude is not None and named(n, exclude):
            continue
        total, found = total + s, True
    return total * 1e3 if found else None


def per_unit(trace: Trace, kind: str, value):
    """`value` / the traced units, for a trace of `kind`; None otherwise."""
    if trace.kind != kind or trace.units <= 0:
        return None
    v = value()
    return None if v is None else v / trace.units


def idle_share(trace: Trace, kind: str):
    """1 - the device's busy seconds in the traced units over the seconds
    that as many units took just before without the profiler (the
    profiler's host cost would count as idle otherwise)."""
    if trace.kind != kind or trace.plain_s <= 0 or trace.busy_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.plain_s


def span_mean(trace: Trace, kind: str, name: str, scale: float = 1.0):
    xs = trace.spans.get(name) if trace.kind == kind else None
    return sum(xs) / len(xs) * scale if xs else None
