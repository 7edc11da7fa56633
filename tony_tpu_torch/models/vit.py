"""Vision Transformer family: attention on images, in PyTorch.

Counterpart of `tony_tpu/models/vit.py`, with its tree (stacked (L, in,
out) layer weights, f32 norms and head) and semantics:

- **Patchify as one product**: images (B, H, W, C) are cut into P x P
  patches by a reshape and transpose and embedded by one (P*P*C, D)
  product; a CLS token in front, learned position embeddings added.
- **Non-causal flash attention** through the port's `flash_attention`
  (K1 forward, K2/K3 backward on the card) and `rms_norm` (K4) in
  pre-norm blocks with a tanh-approximate GELU MLP (`jax.nn.gelu`'s
  default; torch's default is the exact erf). H == Hkv: no GQA group.
- **A Python loop over the stacked layers** in place of `lax.scan`, with
  per-layer gradient routing (`llama.layer_params_for_grad`) and no
  remat, as the JAX forward has none.
- Only the CLS row feeds the head: it is sliced before the final norm,
  and made contiguous, since the RMSNorm kernel reads whole rows.
- **Under a mesh** (a Trainer with `vit_param_axes` placing the
  parameters at rest), each rank runs the whole model on its own rows
  with every weight gathered whole, and the ranks' losses are averaged
  (`parallel/sharding.data_parallel_loss`), as `resnet_loss` does: the
  same loss and gradients on dp, fsdp and tp meshes.

Presets: `vit_tiny` (tests, examples) and `vit_s16_proxy` (ViT-S/16).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F
from tony_tpu_torch.models.llama import (
    cross_entropy, layer_params_for_grad, linear, qkv_proj,
)
from tony_tpu_torch.models.resnet import as_images
from tony_tpu_torch.ops.attention import flash_attention
from tony_tpu_torch.ops.rmsnorm import rms_norm
from tony_tpu_torch.parallel.sharding import data_parallel_loss

Params = dict[str, Any]


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    in_channels: int = 3
    num_classes: int = 10
    dim: int = 64
    n_layers: int = 2
    n_heads: int = 4
    mlp_ratio: int = 4
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def n_kv_heads(self) -> int:
        """Every head its own K/V (`llama.qkv_proj` reads it)."""
        return self.n_heads

    @property
    def seq(self) -> int:
        return self.n_patches + 1        # + CLS


PRESETS = {
    "vit_tiny": ViTConfig(),
    "vit_s16_proxy": ViTConfig(image_size=224, patch_size=16,
                               num_classes=1000, dim=384, n_layers=12,
                               n_heads=6, dtype=torch.bfloat16),
}


def get_config(name: str, **overrides) -> ViTConfig:
    return replace(PRESETS[name], **overrides)


def vit_init(config: ViTConfig, generator: torch.Generator) -> Params:
    """Scaled-normal weights drawn in f32 and cast to config.dtype, a zero
    CLS token, unit f32 norms, a zero f32 head, on the generator's device.
    Another generator than the JAX package's: weights move through
    `models/convert.py`."""
    d = config.dim
    patch_in = config.patch_size ** 2 * config.in_channels
    device = generator.device

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device)
        return (x * scale).to(config.dtype)

    def ones(shape):
        return torch.ones(shape, device=device)

    L, h = config.n_layers, config.mlp_ratio * d
    return {
        "patch_embed": normal((patch_in, d), patch_in ** -0.5),
        "pos_embed": normal((config.seq, d), 0.02),
        "cls_token": torch.zeros((d,), dtype=config.dtype, device=device),
        "layers": {
            "wq": normal((L, d, d), d ** -0.5),
            "wk": normal((L, d, d), d ** -0.5),
            "wv": normal((L, d, d), d ** -0.5),
            "wo": normal((L, d, d), d ** -0.5),
            "w_up": normal((L, d, h), d ** -0.5),
            "w_down": normal((L, h, d), h ** -0.5),
            "attn_norm": ones((L, d)),
            "mlp_norm": ones((L, d)),
        },
        "final_norm": ones((d,)),
        "head_w": torch.zeros((d, config.num_classes), device=device),
        "head_b": torch.zeros((config.num_classes,), device=device),
    }


def vit_param_axes(config: ViTConfig) -> Params:
    return {
        "patch_embed": (None, "embed"),
        "pos_embed": (None, None),
        "cls_token": (None,),
        "layers": {
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "heads"),
            "wv": ("layers", "embed", "heads"),
            "wo": ("layers", "heads", "embed"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
            "attn_norm": ("layers", "norm"),
            "mlp_norm": ("layers", "norm"),
        },
        "final_norm": ("norm",),
        "head_w": ("embed", None),
        "head_b": (None,),
    }


def _patchify(images: torch.Tensor, config: ViTConfig) -> torch.Tensor:
    """(B, H, W, C) -> (B, n_patches, P*P*C) by reshape and transpose."""
    b, hgt, wdt, c = images.shape
    p = config.patch_size
    gh, gw = hgt // p, wdt // p
    x = images.reshape(b, gh, p, gw, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)               # (B, gh, gw, p, p, C)
    return x.reshape(b, gh * gw, p * p * c)


def _embed(params: Params, images: torch.Tensor,
           config: ViTConfig) -> torch.Tensor:
    """Images (B, H, W, C) -> the blocks' input (B, seq, D): patch
    embedding, CLS in front, position embeddings."""
    x = _patchify(images.to(config.dtype), config) @ params["patch_embed"]
    cls = params["cls_token"].expand(x.shape[0], 1, config.dim)
    x = torch.cat([cls, x], dim=1)
    return x + params["pos_embed"].to(config.dtype)


def _block(config: ViTConfig, x: torch.Tensor, layer: Params
           ) -> torch.Tensor:
    b, s, d = x.shape
    h = rms_norm(x, layer["attn_norm"], config.norm_eps)
    q, k, v = qkv_proj(h, layer, config)
    attn = flash_attention(q, k, v, causal=False)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    x = x + linear(attn, layer["wo"])
    h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    up = F.gelu(linear(h, layer["w_up"]), approximate="tanh")
    return x + linear(up, layer["w_down"])


def _blocks(params: Params, x: torch.Tensor, config: ViTConfig
            ) -> torch.Tensor:
    for layer in layer_params_for_grad(params):
        x = _block(config, x, layer)
    return x


def vit_forward(params: Params, images: torch.Tensor,
                config: ViTConfig) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, num_classes) f32 from the CLS
    row, sliced (and made contiguous) before the final norm."""
    x = _blocks(params, _embed(params, images, config), config)
    cls_out = rms_norm(x[:, 0].contiguous(), params["final_norm"],
                       config.norm_eps)
    return cls_out.float() @ params["head_w"] + params["head_b"]


def _local_loss(params: Params, batch: dict, config: ViTConfig
                ) -> torch.Tensor:
    logits = vit_forward(params, as_images(batch["images"]), config)
    return cross_entropy(logits, batch["labels"])


def vit_loss(params: Params, batch: dict[str, torch.Tensor],
             config: ViTConfig) -> torch.Tensor:
    """Mean softmax cross-entropy. batch: {'images': (B,H,W,C) or
    (B, side*side) mnist-flat, 'labels': (B,)}; DTensor batches (a
    Trainer under a mesh) through `data_parallel_loss`."""
    return data_parallel_loss(partial(_local_loss, config=config), params,
                              batch)
