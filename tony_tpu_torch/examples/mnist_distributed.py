"""Distributed MNIST: the port of ``examples/mnist-jax/mnist_distributed.py``.

The 784-300-100-10 MLP (`models/mnist.py`) trained by the Trainer on
class-conditional Gaussian images (`synthetic_mnist`). As a gang
(framework ``pytorch`` or ``jax``) every rank joins one process group
from the rendezvous env the executor renders and trains on its own rows
of the global batch. The chief then scores 1024 held-out images and the
script fails when the accuracy is below 0.9.

    python -m tony_tpu_torch.examples.mnist_distributed --device cpu
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.environ.get(
        "TONY_REPO_ROOT",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")))

MIN_ACCURACY = 0.9


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tony_tpu_torch.examples."
                                          "mnist_distributed")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda or cpu)")
    return parser


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    from tony_tpu_torch.models.mnist import (
        mnist_accuracy, mnist_init, mnist_loss,
    )
    from tony_tpu_torch.parallel.distributed import gang
    from tony_tpu_torch.parallel.sharding import tree_paths
    from tony_tpu_torch.train.data import synthetic_mnist
    from tony_tpu_torch.train.trainer import Trainer, TrainerConfig

    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    _, process_index = gang()
    trainer = Trainer(
        loss_fn=mnist_loss, init_fn=mnist_init,
        data_iter=synthetic_mnist(args.batch_size,
                                  process_index=process_index),
        config=TrainerConfig(num_steps=args.steps, log_every=50,
                             learning_rate=args.learning_rate),
        device=args.device)
    try:
        final_loss = trainer.run()
        # whole parameters (replicated on a mesh) for the chief's score
        params = {"/".join(path): (p.full_tensor() if hasattr(
            p, "full_tensor") else p).detach()
            for path, p in tree_paths(trainer.params)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if os.environ.get("IS_CHIEF", "true") == "true":
        batch = next(iter(synthetic_mnist(1024, seed=99)))
        batch = {k: torch.from_numpy(v).to(trainer.device)
                 for k, v in batch.items()}
        acc = float(mnist_accuracy(params, batch))
        print(f"final loss {final_loss:.4f} accuracy {acc:.3f}")
        if acc < MIN_ACCURACY:
            print(f"accuracy below {MIN_ACCURACY} — failing",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
