"""The comparison that decides `correct`: numbers computed from what the
timed path produced and what the reference computed, each held to the limit
of its own in the cell's file (`cells/<workload>.json`). How each limit was
set, from the program's readings on a dozen seeds and the bfloat16
control's, is in PERF.md."""
from __future__ import annotations

import math

import torch


def rel_l1(a: torch.Tensor, b: torch.Tensor) -> float:
    """sum |a - b| / sum |b|, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().sum() / b.abs().sum().clamp(min=1e-300))


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) /
                 torch.linalg.vector_norm(b).clamp(min=1e-300))


def _norms(d: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(v.double())) for n, v in d.items()}


def _median(xs):
    xs = sorted(xs)
    m = len(xs) // 2
    return xs[m] if len(xs) % 2 else 0.5 * (xs[m - 1] + xs[m])


def norm_gap(prog: dict, ref: dict, leaves=None) -> float:
    """The worst leaf's gap between the two norms, | |p| - |r| |, over the
    larger of the reference's norm of that leaf and of the median leaf."""
    pn, rn = _norms(prog), _norms(ref)
    leaves = list(rn) if leaves is None else leaves
    med = _median(list(rn.values()))
    return max(abs(pn[n] - rn[n]) / max(rn[n], med, 1e-300) for n in leaves)


def moved_leaves(ref_grad: dict) -> list:
    """Leaves that count in the parameters' change: those whose reference
    gradient's norm is at least a thousandth of the median leaf's (a leaf
    below that moves under Adam by round-off alone)."""
    rn = _norms(ref_grad)
    med = _median(list(rn.values()))
    return [n for n, v in rn.items() if v >= 1e-3 * med]


def loss_gap(prog: list, ref: list) -> float:
    return max(abs(p - r) / max(abs(r), 1e-300) for p, r in zip(prog, ref))


def judge(numbers: dict, limits: dict):
    """(correct, checks): every number must be finite and at most its
    limit; `checks` maps each name to its number and its limit."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
