"""Memory-bounded gradients: what a checkpointed step keeps from its forward.

Port of the lean remat policy of `mafrixraytracing_tpu/integrator/path.py`
(`SAVE_ISECT`, `:136-153`, applied at `:922-930`). `render_image` runs each
(pixel-chunk, spp-group) step under `torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)` where `needed` says so: the step's graph holds none of
its activations, and the backward runs the step's forward again to rebuild
them. The non-reentrant form builds the same graph as a run without
checkpoints, so gradients are summed in the same order and come out
bit-equal.

The JAX package names the values its policy keeps (`checkpoint_name`); here
a `Tape` keeps them. In the step's forward each kept value is recorded in
order; in the recompute each is handed back from the tape in the same order
instead of computed again (`keep`). Kept: the closest-hit search (t, idx),
the any-hit answers and the texture lookups, so no walk and no cull runs in
the backward. The attribute fetch (kernel C) and the wavefront's gathers
run again. JAX's second policy, which also keeps those (`save_attrs`), is
not ported.

What a kept computation does must not save tensors for the backward: the
recompute skips it, and the checkpoint matches the tensors saved in the
recompute to those of the forward one by one. So the searches and the
texture lookups are computed without grad.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
from torch.utils.checkpoint import checkpoint

# Bytes of autograd graph a lane holds a bounce in a gradient of the
# physical estimator: 0.0904 GiB a spp at 256x256 on the 36,996-face mesh
# with the bench's compaction (2.2255 lane-bounces a pixel), rounded up.
# Cornell's graph takes 664 B a lane-bounce, sphere_triad's (gradients also
# to the spheres) 848 B (H100, chip_smoke.py phase 14): FREE_SHARE leaves
# room for up to GRAPH_BYTES / FREE_SHARE = 1,400 B
GRAPH_BYTES = 700
# Checkpoint when the estimated graph would take more than this share of the
# card's free memory
FREE_SHARE = 0.5

_state = threading.local()


def needed(config, spp: int, pixels: int, device: torch.device) -> bool:
    """Whether `render_image` checkpoints its steps: never without grad;
    as `config.remat` says when it is set. None decides by size: on a card,
    checkpoint when the frame's graph, spp * pixels * lane-bounces a pixel *
    GRAPH_BYTES, would exceed FREE_SHARE of the card's free memory; on the
    CPU, never."""
    if not torch.is_grad_enabled():
        return False
    if config.remat is not None:
        return config.remat
    if device.type != "cuda":
        return False
    lanes = sum(config.compact) if config.compact else config.max_depth
    free, _ = torch.cuda.mem_get_info(device)
    return spp * pixels * lanes * GRAPH_BYTES > FREE_SHARE * free


class Tape:
    """The values one checkpointed step keeps, in the order its forward made
    them."""

    def __init__(self):
        self.values: list = []
        self.recorded = False
        self.pos = 0

    def take(self, kind: str):
        if self.pos >= len(self.values):
            raise RuntimeError(f"remat: the recompute asked for more kept values "
                               f"than the forward recorded (a {kind!r})")
        k, v = self.values[self.pos]
        if k != kind:
            raise RuntimeError(f"remat: the recompute asked for a {kind!r} where "
                               f"the forward recorded a {k!r}")
        self.pos += 1
        return v


def _alias(v):
    """Fresh tensors that share `v`'s storage and carry no autograd
    history."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    return tuple(_alias(x) for x in v)


def _active() -> Tape | None:
    """The tape of the step that is running, if any."""
    return getattr(_state, "tape", None)


@contextmanager
def _using(tape: Tape):
    before = _active()
    _state.tape = tape
    try:
        yield
    finally:
        _state.tape = before


def keep(kind: str, fn):
    """`fn()` (a tensor or a tuple of tensors): computed in a plain run,
    recorded in a checkpointed step's forward, taken from the tape in its
    recompute."""
    tape = _active()
    if tape is None:
        return fn()
    if tape.recorded:
        return _alias(tape.take(kind))
    v = fn()
    tape.values.append((kind, _alias(v)))
    return v


def checkpointed(step):
    """`step(*args)` under a non-reentrant checkpoint with a tape of its own
    for every call: the first run of a call records, every later run (the
    recompute of a backward) replays from the start. Raises if the recompute
    does not ask for what the forward kept."""
    def call(*args):
        tape = Tape()

        def run(*a):
            tape.pos = 0
            with _using(tape):
                out = step(*a)
            tape.recorded = True
            return out

        return checkpoint(run, *args, use_reentrant=False)

    return call
