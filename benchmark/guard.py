"""The import guard: no module whose top-level name is JAX's, jaxlib's,
flax's or the JAX package's may be loaded in a benchmark process. Names are
compared whole, the part before the first dot: the measured package's name
begins with the JAX package's."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mafrixraytracing_tpu"})


def forbidden_loaded(modules=None) -> list:
    """Sorted names of loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check(stage: str) -> None:
    """Raise SystemExit(3) naming what was found, on standard error."""
    found = forbidden_loaded()
    if found:
        print(f"import guard ({stage}): forbidden modules loaded: {found[:20]}",
              file=sys.stderr)
        raise SystemExit(3)
