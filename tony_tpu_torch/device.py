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


# (substring of the card's name, memory TB/s, dense bf16 TFLOP/s, f32
# non-tensor TFLOP/s), from NVIDIA's data sheets; the first match wins
CARD_PEAKS = (
    ("H100 PCIe", 2.0, 756.0, 51.0),
    ("H100 NVL", 3.9, 835.0, 60.0),
    ("H200", 4.8, 989.0, 67.0),
    ("H100", 3.35, 989.0, 67.0),
)


def card_peaks(name: str) -> tuple[float, float, float] | None:
    """(bytes/s, bf16 FLOP/s, f32 FLOP/s) of the card named `name`, or None
    for a card not in the table."""
    for key, tbs, bf16, f32 in CARD_PEAKS:
        if key in name:
            return tbs * 1e12, bf16 * 1e12, f32 * 1e12
    return None


def peak_flops(device: torch.device) -> float:
    """The card's dense bf16 peak in FLOP/s, for MFU; 0.0 for the CPU or a
    card not in the table (MFU is then not reported)."""
    if device.type != "cuda":
        return 0.0
    peaks = card_peaks(torch.cuda.get_device_name(device))
    return peaks[1] if peaks else 0.0
