"""The display chain of the progressive film: the mean radiance, the
Narkowicz ACES curve clamped to [0, 1], a square-root gamma, bytes by the
255.99 scale."""
from __future__ import annotations

import torch


def to_bytes(mean: torch.Tensor) -> torch.Tensor:
    x = mean
    aces = torch.clamp((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)
    display = torch.sqrt(torch.clamp(aces, 0.0, 1.0))
    return torch.clamp(display * 255.99, 0.0, 255.0).to(torch.uint8)
