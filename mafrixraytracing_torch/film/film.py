"""Progressive film accumulation.

Port of `mafrixraytracing_tpu/film/film.py` (the reference's `Film`,
`Core/Film.fs:13-36`): a running radiance sum and a frame count; the display
frame is sum / count. `FilmState`, the root seed and the next sample index
are all a render needs to resume bit-exactly (`utils.checkpoint`).
"""
from __future__ import annotations

import dataclasses

import torch

from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.film import tonemap as tm


@dataclasses.dataclass(frozen=True)
class FilmState:
    radiance_sum: torch.Tensor   # (H, W, 3) running sum of per-frame radiance
    frame_count: torch.Tensor    # () int32

    @classmethod
    def create(cls, height: int, width: int, device=None) -> "FilmState":
        device = resolve(device)
        return cls(
            radiance_sum=torch.zeros((height, width, 3), dtype=torch.float32,
                                     device=device),
            frame_count=torch.zeros((), dtype=torch.int32, device=device))

    def add_frame(self, frame: torch.Tensor) -> "FilmState":
        """Accumulate one frame of per-pixel radiance (reference
        `Film.AddSample`, `Film.fs:18-23`). Returns a new state."""
        return FilmState(self.radiance_sum + frame, self.frame_count + 1)

    def reset(self) -> "FilmState":
        """(reference `Film.Reset`, `Film.fs:26-30`)"""
        return FilmState(torch.zeros_like(self.radiance_sum),
                         torch.zeros_like(self.frame_count))

    @property
    def mean(self) -> torch.Tensor:
        return self.radiance_sum / torch.clamp(self.frame_count, min=1)

    def display(self) -> torch.Tensor:
        """Tonemapped [0, 1] image (ACES + gamma, reference
        `Scene.fs:315-330`)."""
        return tm.tonemap(self.mean)

    def to_bytes(self) -> torch.Tensor:
        return tm.to_bytes(self.display())
