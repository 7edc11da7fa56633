"""Rotary position embeddings (RoPE).

Counterpart of `tony_tpu/ops/rope.py`, in plain PyTorch ops: RoPE is
elementwise, and the JAX package has no kernel for it either. The
half-rotation form (pairs (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos),
with x1 and x2 the two halves of the head dim) and f32 tables, built in
f32 as the JAX package builds them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def scale_rope_frequencies(inv_freq: torch.Tensor, factor: float,
                           orig_max_seq: int,
                           low_freq_factor: float = 1.0,
                           high_freq_factor: float = 4.0) -> torch.Tensor:
    """Llama-3.1-style long-context RoPE rescale: components whose
    wavelength exceeds the original context window are slowed by `factor`,
    short wavelengths are left as they are, and the band between
    interpolates smoothly."""
    wavelen = 2.0 * math.pi / inv_freq
    low_bound = orig_max_seq / low_freq_factor
    high_bound = orig_max_seq / high_freq_factor
    smooth = (orig_max_seq / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    smooth = torch.clamp(smooth, 0.0, 1.0)
    interpolated = smooth * inv_freq + (1.0 - smooth) * inv_freq / factor
    return torch.where(wavelen > low_bound, inv_freq / factor,
                       torch.where(wavelen < high_bound, inv_freq,
                                   interpolated))


def rope_frequencies(head_dim: int, max_seq: int,
                     theta: float = 10_000.0,
                     scaling_factor: float = 0.0,
                     orig_max_seq: int = 8192,
                     device: Optional[torch.device] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape (max_seq, head_dim // 2), f32.
    scaling_factor > 1 applies the Llama-3.1 long-context rescale against
    `orig_max_seq` (0 = off)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    if scaling_factor and scaling_factor > 1.0:
        inv_freq = scale_rope_frequencies(inv_freq, scaling_factor,
                                          orig_max_seq)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                 # (S, D/2)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, H, S, D). cos/sin: (max_seq, D/2). positions: None (arange),
    (S,) shared or (B, S) per-row absolute positions."""
    s = x.shape[2]
    if positions is None:
        cos_s, sin_s = cos[:s][None, None], sin[:s][None, None]
    elif positions.ndim == 1:                        # (S,) shared
        cos_s, sin_s = cos[positions][None, None], sin[positions][None, None]
    elif positions.ndim == 2:                        # (B, S) per row
        cos_s, sin_s = cos[positions][:, None], sin[positions][:, None]
    else:
        raise ValueError(f"positions must be (S,) or (B, S); "
                         f"got shape {tuple(positions.shape)}")
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rotated = torch.cat((x1 * cos_s - x2 * sin_s, x1 * sin_s + x2 * cos_s),
                        dim=-1)
    return rotated.to(x.dtype)
