"""Where the port's tensors are made.

The port's entry points run on the CUDA card unless the caller names another
device: `resolve(None)` is the current CUDA device (`torch.cuda.set_device`
picks it; `parallel.launch.init` sets each rank's), and raises when there is
no CUDA device rather than quietly giving the CPU. The CPU is used only when
asked for (`device="cpu"`, as the CPU parity tests do).
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device to build on: `device` when given, else the current CUDA
    card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
