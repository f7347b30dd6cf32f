"""The port's own spans joined to the device trace: a cell's traced run with
the program's spans on, every launch and idle gap put down to a layer.

    python3 benchmark/layers.py --workload <name> --seed <n> --seconds <s>

runs the cell as `run.py --trace 1` does and prints its result line, then,
as the last line of standard output, `{"layers": ..., "counters": ...}`:
each layer's launches, device ms, idle share and spans a traced unit, and
the change of the port's counters a unit.

The port's spans (`mafrixraytracing_torch/utils/trace.py`) are
`record_function("mfx.<layer>")` ranges that never synchronise: `render`
(`render_image`, `render_flat_pixels`), `bounce` (each bounce: shading),
`rng` (the draws of `core/rng.py`), `search` (`find_closest_soa`,
`occluded_soa`), `refresh` (`refresh_clusters`), `optimizer` (smoothing,
gradient norm, Adam) and `film` (`add_frame`, `to_bytes`). They are on in
the traced slice only (`LayerTracer`), as are the counters' readings:
`search_lanes` (the lanes, padded to the 128-ray tile, that enter each
search) and `scatter_rows` (the rows `ops/unpack.py::scatter_rows` sums).

The rule (`layers`): a **launch** (kernel, copy or fill) follows its
correlation id to the runtime call that launched it and goes to the
innermost `mfx.` span or autograd `evaluate_function` event (layer
**backward**) that holds that call on its thread, so a program span inside
the backward wins; with neither it goes to **outside** (mostly the
benchmark's own code). An **idle gap** goes to the layer of the launch that
ends it, the window's last gap to outside. A layer's idle share is
`idle_share` times its share of the window's gap seconds, so the layers'
shares sum to `idle_share`, and the layers' kernels to `launches_per_*`.
The `mfx.` marks that `record_function` leaves on the device's timeline are
skipped before `tracing.reduce` reads the trace, so every `run.py` metric
reads what it reads with the spans off.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import tracing  # noqa: E402
from mafrixraytracing_torch.utils import trace as program  # noqa: E402

PROGRAM = "mfx."        # the program's own spans
BACKWARD = "autograd::engine::evaluate_function"
OUTSIDE = "outside"


def _mark(e) -> bool:
    """A span's mark on the device's timeline (not a kernel, copy or fill)."""
    return (e.device_type() == torch.autograd.DeviceType.CUDA
            and e.name().startswith((tracing.PREFIX, PROGRAM)))


class Unmarked:
    """A profiler's result as `tracing.reduce` reads it, less the program's
    span marks on the device's timeline (it skips its own `bench.` ones)."""

    def __init__(self, events):
        kept = [e for e in events
                if not (_mark(e) and e.name().startswith(PROGRAM))]
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda _: kept})()


def _innermost(spans: list, queries: list) -> list:
    """For each (time, index) of `queries`, the layer of the innermost of the
    nested (start, end, layer) `spans` of one thread that holds it, or
    OUTSIDE. Returns (index, layer) pairs."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    out, stack, j = [], [], 0
    for t, i in sorted(queries):
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append((i, stack[-1][2] if stack else OUTSIDE))
    return out


def layers(events) -> dict:
    """Each device event of the benchmark's window (kernels, copies, fills;
    not the spans' marks) and each idle gap there put down to a layer by the
    rule above. Returns layer -> {"launches": kernels, "device_s": device
    seconds of its events, "idle_s": gap seconds, "spans": its spans opened
    in the window}; the launches are the kernels `tracing.Trace.kernels`
    counts."""
    events = list(events)
    win = [e for e in events if e.name() == tracing.PREFIX + "window" and not _mark(e)]
    w0 = win[0].start_ns() if win else 0
    w1 = w0 + win[0].duration_ns() if win else 0
    device, spans, calls, out = [], {}, {}, {}

    def acc(layer):
        return out.setdefault(layer, {"launches": 0, "device_s": 0.0, "idle_s": 0.0,
                                      "spans": 0})
    for e in events:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not _mark(e) and end > w0 and s < w1:
                device.append((s, end, e.correlation_id(),
                               not name.startswith(("Memcpy", "Memset"))))
            continue
        if name.startswith(PROGRAM):
            layer = name[len(PROGRAM):]
        elif name.startswith(BACKWARD):
            layer = "backward"
        else:
            if name.startswith("cu"):   # a CUDA API call (cuda*, cu*), not an operator
                calls[e.correlation_id()] = (e.start_thread_id(), s)
            continue
        spans.setdefault(e.start_thread_id(), []).append((s, end, layer))
        if w0 <= s < w1:
            acc(layer)["spans"] += 1
    of = [OUTSIDE] * len(device)
    queries = {}
    for i, (_, _, corr, _) in enumerate(device):
        if corr in calls:
            tid, t = calls[corr]
            queries.setdefault(tid, []).append((t, i))
    for tid, q in queries.items():
        for i, layer in _innermost(spans.get(tid, []), q):
            of[i] = layer
    for (s, end, _, kernel), layer in zip(device, of):
        a = acc(layer)
        a["launches"] += int(kernel)
        a["device_s"] += (end - s) / 1e9
    if not device:
        return out
    iv = np.array([[max(s, w0), min(end, w1)] for s, end, _, _ in device], dtype=np.int64)
    order = np.argsort(iv[:, 0], kind="stable")
    busy = tracing._union(iv)
    # the event that opens each busy interval ends the gap before it
    opener = order[np.searchsorted(iv[order, 0], busy[:, 0], side="left")]
    edges = np.r_[w0, busy.reshape(-1), w1].reshape(-1, 2)
    for k, (g0, g1) in enumerate(edges):
        if g1 > g0:
            acc(of[opener[k]] if k < len(busy) else OUTSIDE)["idle_s"] += (g1 - g0) / 1e9
    return out


def layer_idle_share(trace: tracing.Trace, by_layer: dict, layer: str):
    """`idle_share` times `layer`'s share of the window's gap seconds: the
    layers' shares, OUTSIDE included, sum to `idle_share`."""
    share = tracing.idle_share(trace, trace.kind)
    total = sum(v["idle_s"] for v in by_layer.values())
    if share is None or total <= 0:
        return None
    return share * by_layer.get(layer, {}).get("idle_s", 0.0) / total


def table(trace: tracing.Trace, by_layer: dict) -> dict:
    """Every layer's launches, device ms and spans a traced unit and its
    idle share."""
    units = max(trace.units, 1)
    return {layer: {"launches": v["launches"] / units,
                    "device_ms": v["device_s"] * 1e3 / units,
                    "idle_share": layer_idle_share(trace, by_layer, layer),
                    "spans": v["spans"] / units}
            for layer, v in sorted(by_layer.items())}


class LayerTracer(tracing.Tracer):
    """`tracing.Tracer` with the program's spans on in the traced slice: its
    counters' change over the slice goes to `trace.counters` as
    `mfx.<name>`, its layers to `self.layers`."""

    last = None     # the last instance stopped

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.layers = {}

    def start(self):
        super().start()
        if self._prof is None:
            return
        self._counts = dict(program.COUNTERS)
        program.enable()

    def stop(self, units: int):
        if self._prof is None:
            return
        self._sync()
        program.disable()
        for k, v in program.COUNTERS.items():
            self.trace.counters[PROGRAM + k] = v - self._counts[k]
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.trace.units = units
        events = list(self._prof.profiler.kineto_results.events())
        tracing.reduce(Unmarked(events), self.trace)
        self._prof = None
        self.layers = layers(events)
        LayerTracer.last = self


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from benchmark import run

    tracing.Tracer = LayerTracer    # this process's traced run takes the layers
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    tr = LayerTracer.last
    if rc == 0 and tr is not None:
        t = tr.trace
        counters = {k[len(PROGRAM):]: v / max(t.units, 1)
                    for k, v in t.counters.items() if k.startswith(PROGRAM)}
        print(json.dumps({"layers": table(t, tr.layers), "counters": counters}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
