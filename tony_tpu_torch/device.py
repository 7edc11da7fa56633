"""Which device the port's entry points run on."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """`name` as a torch.device. Entry points default to "cuda"; asking for
    a card when none is present raises instead of running on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} asked for, but torch sees no CUDA device; "
            f"pass --device cpu (device='cpu') to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {name!r}")
    return device
