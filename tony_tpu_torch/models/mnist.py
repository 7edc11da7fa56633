"""MNIST MLP: the parity model for the reference's flagship example.

Counterpart of `tony_tpu/models/mnist.py`: a 784-300-100-10 MLP, the tree
{"w0", "b0", "w1", "b1", "w2", "b2"} with (in, out) weights, applied as
`x @ w + b`. Under a mesh the loss runs on each rank's rows
(`parallel/sharding.data_parallel_loss`).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from tony_tpu_torch.models.llama import cross_entropy
from tony_tpu_torch.parallel.sharding import data_parallel_loss

LAYER_SIZES = (784, 300, 100, 10)


def mnist_init(generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> dict[str, Any]:
    """He-normal weights, zero biases, on the generator's device (another
    generator than the JAX package's; weights move between the packages
    through `models/convert.py`)."""
    device = generator.device
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(LAYER_SIZES, LAYER_SIZES[1:])):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=device)
        params[f"w{i}"] = (w * (2.0 / fan_in) ** 0.5).to(dtype)
        params[f"b{i}"] = torch.zeros((fan_out,), dtype=dtype, device=device)
    return params


def mnist_forward(params: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x: (B, 784) -> logits (B, 10)."""
    n = len(LAYER_SIZES) - 1
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = F.relu(x)
    return x


def _mnist_loss(params: dict[str, Any], batch: dict) -> torch.Tensor:
    return cross_entropy(mnist_forward(params, batch["images"]),
                         batch["labels"])


def mnist_loss(params: dict[str, Any], batch: dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """Mean softmax cross-entropy. batch: {'images': (B, 784), 'labels':
    (B,)}."""
    return data_parallel_loss(_mnist_loss, params, batch)


def mnist_accuracy(params: dict[str, Any],
                   batch: dict[str, torch.Tensor]) -> torch.Tensor:
    with torch.no_grad():
        logits = mnist_forward(params, batch["images"])
        return torch.mean((torch.argmax(logits, dim=-1)
                           == batch["labels"].long()).float())
