"""Replay a pass without autograd as one CUDA graph.

A pass that launches the same kernels on the same addresses every time
(the live preview's `integrator.path.render_sample_batch`) costs the host
a dispatch a launch, ~15-20 us against the kernels' ~2 us. `PassGraphs`
records such a pass once and replays it:

- the first call with a key runs eager, which is also the warm-up that a
  capture needs;
- the second captures the pass with `torch.cuda.graph`: on a side stream,
  into a memory pool of the graph's own;
- every later call replays it.

Only the inputs the caller hands over change between calls. Each replay
first copies them into the static buffers that the graph reads: `copy_`
for a tensor, `fill_` for a Python int, which the pass sees as a 0-d int64
tensor on the card. Everything else is baked in: the addresses, shapes and
strides of the tensors the pass reads, and every Python value it branches
on. So the key names them all (`signature`). An in-place edit of a tensor
is seen, since the graph reads its address again; a tensor replaced by
another is a new key. The cache holds `CAPACITY` keys and frees the
oldest, so a caller who swaps tensors every pass runs eager, captures
nothing and holds no more memory.

`ops.cuda.LAUNCHES` and `utils.trace.COUNTERS` count host calls, which run
once, at the capture. Each replay adds their change over the captured pass,
so every pass counts once whichever way it ran. The counters
`graph_captures` and `graph_replays` count the captures and the replays.
The frame a call returns is a copy of the graph's output, which the next
replay overwrites.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from mafrixraytracing_torch.ops import cuda
from mafrixraytracing_torch.utils import trace

CAPACITY = 4
_SEEN = object()   # a key run once, eager


def signature(*parts) -> tuple:
    """A hashable key for what a graph bakes in: a tensor by its address,
    shape, stride, dtype and device; a dataclass field by field; anything
    else as it is."""
    def part(p):
        if isinstance(p, torch.Tensor):
            return ("tensor", p.data_ptr(), tuple(p.shape), p.stride(), p.dtype,
                    p.device)
        if dataclasses.is_dataclass(p):
            return (type(p).__name__, *((f.name, part(getattr(p, f.name)))
                                        for f in dataclasses.fields(p)))
        return p
    return tuple(part(p) for p in parts)


def _record(fn, inputs):
    """(graph, output) of `fn(*inputs)` captured by `torch.cuda.graph`: on
    its side stream, into a memory pool of the graph's own. Nothing runs
    until the graph is replayed."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn(*inputs)
    return g, out


class _Captured:
    """A captured pass: the graph, its static inputs and output, and what
    the captured pass added to `LAUNCHES` and `COUNTERS`."""

    def __init__(self, fn, inputs, device):
        self.inputs = tuple(
            torch.empty_like(x, device=device) if isinstance(x, torch.Tensor)
            else torch.empty((), dtype=torch.int64, device=device) for x in inputs)
        launches, counters = dict(cuda.LAUNCHES), dict(trace.COUNTERS)
        self.graph, self.out = _record(fn, self.inputs)
        self.launches = {k: v - launches.get(k, 0) for k, v in cuda.LAUNCHES.items()}
        self.counters = {k: v - counters.get(k, 0) for k, v in trace.COUNTERS.items()}

    def replay(self, inputs) -> torch.Tensor:
        for buf, x in zip(self.inputs, inputs):
            if isinstance(x, torch.Tensor):
                buf.copy_(x)
            else:
                buf.fill_(x)
        self.graph.replay()
        return self.out.clone()

    def count(self) -> None:
        for k, n in self.launches.items():
            cuda.LAUNCHES[k] += n
        for k, n in self.counters.items():
            if n:
                trace.count(k, n)


class PassGraphs:
    """`run(key, fn, inputs, device)` -> `fn(*inputs)`: eager the first time
    `key` is seen, captured the second, replayed after that. `key` must
    name everything `fn` bakes in apart from `inputs` (tensors and ints)."""

    def __init__(self):
        self.entries: collections.OrderedDict = collections.OrderedDict()

    def run(self, key, fn, inputs: tuple, device) -> torch.Tensor:
        entry = self.entries.get(key)
        if entry is None:
            self._keep(key, _SEEN)
            return fn(*inputs)
        self.entries.move_to_end(key)
        if entry is _SEEN:
            entry = _Captured(fn, inputs, device)
            self._keep(key, entry)
            trace.count("graph_captures", 1)
            return entry.replay(inputs)
        out = entry.replay(inputs)
        entry.count()
        trace.count("graph_replays", 1)
        return out

    def _keep(self, key, entry) -> None:
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > CAPACITY:
            self.entries.popitem(last=False)
