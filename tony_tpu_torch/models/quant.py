"""Weight-only int8 quantization and the int8 KV cache, for inference.

Counterpart of `tony_tpu/models/quant.py`, value for value:

- **Weights**: symmetric per output channel. For W (.., d_in, d_out)
  contracted over d_in, scale_j = max(max_i |W[.., i, j]|, 1e-8) / 127 in
  f32 (kept dims, so stacked (L, d, f) and sliced (d, f) leaves broadcast
  alike) and Q = clip(round(W / scale), -127, 127) in int8, rounding half
  to even as `jnp.round` does.
- **Dequantize** defaults to bf16 whatever the model's dtype, as the JAX
  package's `dequantize` does: bf16(Q) * bf16(scale), rounded to bf16.
  The products of the model do not go through it: inside its compiled
  steps XLA keeps that bf16 product unrounded, so the JAX package's
  decode multiplies by Q * bf16(scale), exact in f32, and so does the port
  (`ops/int8_matmul.py`).
- **KV cache**: per-row (last axis) int8 with f32 scales (.., 1);
  `dequantize_rows` defaults to f32.

Quantized leaves stay plain dicts {"int8", "scale"}, so `convert.py` and
checkpoints carry them as they are. On the card the decode step never
materialises a dequantized weight: `ops/int8_matmul.py` routes its
products to the W8A16 kernel (K5), which reads each int8 weight byte once.
"""

from __future__ import annotations

from typing import Any

import torch

# layer-dict weight names that feed matmuls (contracted over their
# second-to-last axis); norms stay full precision, and so does the MoE
# router (cast to f32 at routing time, and small). we_* are the MoE expert
# banks: (L, E, d_in, d_out) quantizes per (layer, expert, channel), and
# each bank's product goes through ops/int8_matmul.py's int8_bmm
# (models/moe.py).
LAYER_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                    "we_gate", "we_up", "we_down")


def _symmetric_int8(x: torch.Tensor, dim: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with kept-dims f32 scales over `dim`: the one core
    of the weight (-2) and KV-cache (-1) schemes."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=dim, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """W (.., d_in, d_out) -> {"int8", "scale"}, per output channel. A
    stacked (L, ..) weight is quantized one layer slice at a time (the
    reduction is over d_in, so the result is the same), so the f32
    temporaries are one layer's, not the whole stack's."""
    if w.dim() < 3:
        q, scale = _symmetric_int8(w, dim=-2)
        return {"int8": q, "scale": scale}
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*w.shape[:-2], 1, w.shape[-1]),
                        dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        part = quantize(w[i])
        q[i] = part["int8"]
        scale[i] = part["scale"]
    return {"int8": q, "scale": scale}


def is_qtensor(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"int8", "scale"}


def dequantize(t: dict[str, torch.Tensor],
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 -> dtype, times the channel scale in dtype."""
    return t["int8"].to(dtype) * t["scale"].to(dtype)


def maybe_dequantize(leaf: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    return dequantize(leaf, dtype) if is_qtensor(leaf) else leaf


def dequantize_layer(layer: dict,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """Shallow map over one layer's dict (a stacked leaf's slice (d, f)
    with its (1, f) scale broadcasts as the stack does)."""
    return {k: maybe_dequantize(v, dtype) for k, v in layer.items()}


def quantize_params(params: dict, include_output: bool = True) -> dict:
    """Quantize a Llama parameter tree's matmul weights for inference.
    The embedding table and the norms stay as they are; the LM head
    ("output", (d, V)) is quantized unless include_output is False."""
    out = dict(params)
    out["layers"] = {
        k: (quantize(v) if k in LAYER_QUANT_KEYS else v)
        for k, v in params["layers"].items()}
    if include_output and "output" in params:
        out["output"] = quantize(params["output"])
    return out


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis) symmetric int8, the KV-cache scheme: (int8
    (.., d), scale f32 (.., 1))."""
    return _symmetric_int8(x, dim=-1)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def _leaves(tree):
    if is_qtensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def quantized_bytes(params: dict) -> tuple[int, int]:
    """(bytes now, bytes if bf16) over the quantized leaves."""
    now = full = 0
    for leaf in _leaves(params):
        if is_qtensor(leaf):
            now += leaf["int8"].numel() + leaf["scale"].numel() * 4
            full += leaf["int8"].numel() * 2
    return now, full
