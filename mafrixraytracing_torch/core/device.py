"""Where the port's tensors are made.

The port's entry points run on the CUDA card unless the caller names another
device: `resolve(None)` is the current CUDA device (`torch.cuda.set_device`
picks it; `parallel.launch.init` sets each rank's), and raises when there is
no CUDA device rather than quietly giving the CPU. The CPU is used only when
asked for (`device="cpu"`, as the CPU parity tests do).

`device_info` and `device_fields` name the card and its power limit for the
records of the harnesses and examples.
"""
from __future__ import annotations

import subprocess

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


def device_info() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {"name": torch.cuda.get_device_name(0),
                "power_limit": "not measured", "nvidia_smi": None}
    line = out.strip().splitlines()[0]
    name, _, limit = line.partition(",")
    return {"name": name.strip(), "power_limit": limit.strip(),
            "nvidia_smi": line}


def device_fields(device) -> dict:
    """The `device` and `power_limit` fields of a record: the card's as
    nvidia-smi reports them, or "cpu" and "not measured" on the CPU."""
    if torch.device(device).type != "cuda":
        return {"device": "cpu", "power_limit": "not measured"}
    info = device_info()
    return {"device": info["name"], "power_limit": info["power_limit"]}
