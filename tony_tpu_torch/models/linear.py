"""Linear regression: the parity model for tony-examples'
linearregression-mxnet.

Counterpart of `tony_tpu/models/linear.py`: {"w": (num_features,), "b": ()}
in f32, the JAX tree. Under a mesh (the batch a DTensor over (dp, fsdp))
the loss runs on each rank's rows and averages over the ranks
(`parallel/sharding.data_parallel_loss`).
"""

from __future__ import annotations

import torch

from tony_tpu_torch.parallel.sharding import data_parallel_loss


def linreg_init(generator: torch.Generator, num_features: int = 10) -> dict:
    """w ~ 0.01 N(0, 1), b = 0, on the generator's device. Another
    generator than the JAX package's: weights move between the packages
    through `models/convert.py`."""
    device = generator.device
    return {"w": torch.randn((num_features,), generator=generator,
                             device=device) * 0.01,
            "b": torch.zeros((), device=device)}


def linreg_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def _linreg_loss(params: dict, batch: dict) -> torch.Tensor:
    pred = linreg_forward(params, batch["x"])
    return torch.mean((pred - batch["y"]) ** 2)


def linreg_loss(params: dict, batch: dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """Mean squared error. batch: {'x': (B, F), 'y': (B,)}."""
    return data_parallel_loss(_linreg_loss, params, batch)
