"""Post-processing: ACES filmic tone map + gamma.

Port of `mafrixraytracing_tpu/film/tonemap.py` (reference post chain
`Scene/Scene.fs:273-330`): the Narkowicz ACES curve clamped to [0, 1], gamma
via sqrt, then *255.99 to bytes.
"""
from __future__ import annotations

import torch


def aces(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz ACES filmic approximation (reference `Scene.fs:280-289`)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tonemap(linear: torch.Tensor) -> torch.Tensor:
    """Linear HDR -> display [0, 1]: ACES then sqrt gamma."""
    return torch.sqrt(torch.clamp(aces(linear), 0.0, 1.0))


def to_bytes(display: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> uint8 with the reference's 255.99 scale (`Scene.fs:325`)."""
    return torch.clamp(display * 255.99, 0.0, 255.0).to(torch.uint8)
