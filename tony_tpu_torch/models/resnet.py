"""Conv/ResNet family: the framework's convolutional workload, in PyTorch.

Counterpart of `tony_tpu/models/resnet.py`, with its tree and semantics:

- **Layouts**: activations are NHWC and conv weights HWIO, as the JAX
  package keeps them at rest, so trees and checkpoints are exchangeable.
  Each conv permutes at the call: the NHWC activation viewed as NCHW with
  channels-last strides and the weight as OIHW, which cuDNN runs as an
  NHWC convolution; its output is viewed back as NHWC.
- **`padding="SAME"`** is XLA's rule, padded explicitly: the output side
  is ceil(in / stride), and the total padding (out - 1) * stride + k - in
  is split with the smaller half BEFORE. A 3x3 stride-2 conv on an even
  side pads 0 before and 1 after, where `padding=1` would pad 1 on both
  sides and shift every window by a pixel.
- **IEEE f32**: cuDNN runs f32 convolutions in TF32 by default
  (`torch.backends.cudnn.allow_tf32`); an f32 conv here turns it off for
  its own forward and backward (`_Conv`), and leaves the process's setting
  as it found it. bf16 convs are cuDNN's bf16 with f32 accumulation.
- **GroupNorm** per sample, the group count lowered to the largest
  divisor of C at most `groups`, statistics in f32, cast back.
- **Head**: the global average pool keeps the activation dtype; the head
  product takes f32 operands (the JAX bf16 x bf16 product with an f32
  result, `preferred_element_type`, is exact in f32) and adds the f32 bias.

Convolution and GroupNorm are XLA ops in the reference, not Pallas
kernels, so they stay cuDNN's and torch's. Under a mesh the loss runs on
each rank's rows (`parallel/sharding.data_parallel_loss`).

Presets: `resnet_tiny` (tests, examples) and `resnet50_proxy`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.nn.functional as F

from tony_tpu_torch.models.llama import cross_entropy
from tony_tpu_torch.parallel.sharding import data_parallel_loss

Params = dict[str, Any]


@dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 10
    in_channels: int = 1
    # (blocks, channels, first-block stride) per stage
    stages: tuple = ((2, 16, 1), (2, 32, 2), (2, 64, 2))
    stem_channels: int = 16
    groups: int = 8              # GroupNorm groups
    dtype: torch.dtype = torch.float32


PRESETS = {
    "resnet_tiny": ResNetConfig(),
    "resnet50_proxy": ResNetConfig(
        in_channels=3, num_classes=1000, stem_channels=64,
        stages=((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)),
        groups=32, dtype=torch.bfloat16),
}


def get_resnet_config(name: str, **overrides) -> ResNetConfig:
    return replace(PRESETS[name], **overrides)


def _conv_init(generator, kh, kw, cin, cout, dtype):
    fan_in = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=generator,
                    device=generator.device)
    return (w * (2.0 / fan_in) ** 0.5).to(dtype)


def resnet_init(config: ResNetConfig, generator: torch.Generator) -> Params:
    """He-normal convs (HWIO), GroupNorm scale 1 and bias 0 (f32), the
    JAX tree: "stages" a list of stages, each a list of block dicts, a
    block's "proj" only where its width changes. Another generator than
    the JAX package's: weights move through `models/convert.py`."""
    device = generator.device

    def ones(n):
        return torch.ones((n,), device=device)

    def zeros(n):
        return torch.zeros((n,), device=device)

    p: Params = {
        "stem": _conv_init(generator, 3, 3, config.in_channels,
                           config.stem_channels, config.dtype),
        "stem_scale": ones(config.stem_channels),
        "stem_bias": zeros(config.stem_channels),
        "stages": [],
    }
    cin = config.stem_channels
    for n_blocks, cout, _stride in config.stages:
        blocks = []
        for b in range(n_blocks):
            blk = {
                "conv1": _conv_init(generator, 3, 3,
                                    cin if b == 0 else cout, cout,
                                    config.dtype),
                "scale1": ones(cout), "bias1": zeros(cout),
                "conv2": _conv_init(generator, 3, 3, cout, cout,
                                    config.dtype),
                "scale2": ones(cout), "bias2": zeros(cout),
            }
            if b == 0 and cin != cout:
                blk["proj"] = _conv_init(generator, 1, 1, cin, cout,
                                         config.dtype)
            blocks.append(blk)
        p["stages"].append(blocks)
        cin = cout
    head = torch.randn((cin, config.num_classes), generator=generator,
                       device=device)
    p["head_w"] = (head * cin ** -0.5).to(config.dtype)
    p["head_b"] = zeros(config.num_classes)
    return p


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                groups: int, eps: float = 1e-5) -> torch.Tensor:
    """x: (B, H, W, C), per sample: statistics in f32 over (H, W, C/g)
    for each of g groups, g the largest divisor of C at most `groups`."""
    b, h, w, c = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xf = x.float().reshape(b, h, w, g, c // g)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    xf = xf.reshape(b, h, w, c)
    return (xf * scale + bias).to(x.dtype)


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial side: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def _ieee_f32_conv(dtype: torch.dtype):
    """cuDNN in IEEE f32 for an f32 conv (TF32 off inside, the process's
    setting restored after); nothing for another dtype (or on the CPU,
    which has no TF32)."""
    cudnn = torch.backends.cudnn
    if dtype != torch.float32 or not cudnn.allow_tf32:
        yield
        return
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = True


class _Conv(torch.autograd.Function):
    """F.conv2d (NCHW views, no padding), forward and backward under
    `_ieee_f32_conv`: the backward runs after the forward's context has
    closed, so it sets the flag again for itself."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _ieee_f32_conv(x.dtype):
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s = ctx.stride
        with _ieee_f32_conv(x.dtype):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.contiguous(memory_format=torch.channels_last), x, w,
                None, [s, s], [0, 0], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1
              ) -> torch.Tensor:
    """`lax.conv_general_dilated(x, w, (stride, stride), "SAME",
    ("NHWC", "HWIO", "NHWC"))`: x (B, H, W, Cin), w (kh, kw, Cin, Cout)
    -> (B, H', W', Cout), H' = ceil(H / stride)."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = same_padding(x.shape[1], kh, stride)
    left, right = same_padding(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)                       # NCHW view, NHWC memory
    if top or bottom or left or right:
        xc = F.pad(xc, (left, right, top, bottom))
    xc = xc.contiguous(memory_format=torch.channels_last)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return _Conv.apply(xc, wc, stride).permute(0, 2, 3, 1)


def resnet_forward(params: Params, images: torch.Tensor,
                   config: ResNetConfig) -> torch.Tensor:
    """images: (B, H, W, C_in) -> logits (B, num_classes) f32."""
    x = images.to(config.dtype)
    x = conv_same(x, params["stem"])
    x = F.relu(_group_norm(x, params["stem_scale"], params["stem_bias"],
                           config.groups))
    for (_n_blocks, _cout, stride), blocks in zip(config.stages,
                                                  params["stages"]):
        for b, blk in enumerate(blocks):
            s = stride if b == 0 else 1
            h = conv_same(x, blk["conv1"], stride=s)
            h = F.relu(_group_norm(h, blk["scale1"], blk["bias1"],
                                   config.groups))
            h = conv_same(h, blk["conv2"])
            h = _group_norm(h, blk["scale2"], blk["bias2"], config.groups)
            shortcut = x
            if "proj" in blk:
                shortcut = conv_same(x, blk["proj"], stride=s)
            elif s != 1:
                shortcut = x[:, ::s, ::s]
            x = F.relu(h + shortcut)
    x = x.mean(dim=(1, 2))                        # global average pool
    return x.float() @ params["head_w"].float() + params["head_b"]


def as_images(images: torch.Tensor) -> torch.Tensor:
    """(B, N*N) mnist-flat -> (B, N, N, 1); NHWC passes through. The zoo's
    image models (resnet loss and accuracy, vit loss) share it."""
    if images.ndim == 2:
        side = int(images.shape[1] ** 0.5)
        images = images.reshape(-1, side, side, 1)
    return images


def _resnet_loss(params: Params, batch: dict, config: ResNetConfig
                 ) -> torch.Tensor:
    logits = resnet_forward(params, as_images(batch["images"]), config)
    return cross_entropy(logits, batch["labels"])


def resnet_loss(params: Params, batch: dict[str, torch.Tensor],
                config: ResNetConfig) -> torch.Tensor:
    """Mean softmax cross-entropy. batch: {'images': (B,H,W,C) or
    (B, N*N) mnist-flat, 'labels': (B,)}."""
    return data_parallel_loss(
        lambda p, b: _resnet_loss(p, b, config), params, batch)


def resnet_accuracy(params: Params, batch: dict[str, torch.Tensor],
                    config: ResNetConfig) -> torch.Tensor:
    with torch.no_grad():
        logits = resnet_forward(params, as_images(batch["images"]), config)
        return torch.mean((torch.argmax(logits, dim=-1)
                           == batch["labels"].long()).float())
