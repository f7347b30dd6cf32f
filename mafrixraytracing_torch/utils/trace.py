"""The port's spans and counters: which layer launched the work below them.

A span names one layer of the port (`LAYERS`). Off, as by default, `span`
returns one shared no-op context: no torch call, no allocation, no
synchronisation. On (`enable()`), a span is
`torch.profiler.record_function("mfx." + layer)`, so under an active
`torch.profiler` it sits on the host timeline of the trace, where the
profiler's correlation ids tie every kernel, copy and fill to the host call
that launched it. A span never synchronises: the device's idle time it
helps explain is the one a run without it would have.

| Layer | Where |
| --- | --- |
| `render` | `integrator/path.py::render_image`, `render_flat_pixels` |
| `bounce` | each call of `_bounce` / `_bounce_mafrix` (shading) |
| `rng` | the public draws of `core/rng.py` |
| `search` | `ops/intersect.py::find_closest_soa`, `occluded_soa` |
| `refresh` | `accel/clusters.py::refresh_clusters` |
| `optimizer` | the tail of `opt/inverse.py::make_train_step`'s step |
| `film` | `film/film.py::FilmState.add_frame`, `to_bytes` |
| `collective` | `parallel/mesh.py::RayMesh.sum_start`, `finish`, `all_gather`, `barrier` |

`COUNTERS` holds Python ints added at a layer boundary from tensors'
shapes (no `.item()`, no tensor op), always on like `ops.cuda.LAUNCHES`:

- `search_lanes`: the lanes, padded to the ray tile, that enter each
  closest-hit and any-hit search;
- `scatter_rows`: the gathered rows whose cotangents `ops.unpack.scatter_rows`
  sums;
- `rng_calls`: the public draws of `core/rng.py` (`LAUNCHES["rng_fold"]` and
  `LAUNCHES["rng_uniform"]` count those that took the threefry kernels);
- `allreduce_bytes`: the bytes of the tensors entering an all-reduce of
  `parallel/mesh.py::RayMesh.sum_start`;
- `collective_calls`: the collectives a `RayMesh` issues (one a tensor of
  `sum_start`, one an `all_gather`, one a `barrier`);
- `graph_captures`: the passes `ops.graph.PassGraphs` captured as a CUDA
  graph (the live preview's `render_sample_batch`);
- `graph_replays`: the passes it answered by replaying a captured graph.
  A replayed pass adds to every other counter, and to `ops.cuda.LAUNCHES`,
  what its captured pass added, so a pass counts once whichever way it ran.

A reader takes the counters' change over a stretch of work.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

PREFIX = "mfx."
LAYERS = ("render", "bounce", "rng", "search", "refresh", "optimizer", "film",
          "collective")

COUNTERS: dict[str, int] = {"search_lanes": 0, "scatter_rows": 0, "rng_calls": 0,
                            "allreduce_bytes": 0, "collective_calls": 0,
                            "graph_captures": 0, "graph_replays": 0}

_OFF = contextlib.nullcontext()
_on = False
_lock = threading.Lock()   # counted from the autograd engine's threads too


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(layer: str):
    """The context of `layer`'s span: the shared no-op one while tracing is
    off."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + layer)


def spanned(layer: str):
    """Decorator: every call of the function runs inside `layer`'s span."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(PREFIX + layer):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int) -> None:
    """Add the Python int `n` to counter `name`."""
    with _lock:
        COUNTERS[name] += n


def reset_counters() -> None:
    with _lock:
        for k in COUNTERS:
            COUNTERS[k] = 0
