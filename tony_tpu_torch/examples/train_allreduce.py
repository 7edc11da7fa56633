"""All-reduce data-parallel ResNet or ViT: the port of
``examples/allreduce-resnet/train_allreduce.py``.

Submitted with ``tony.application.framework=horovod``, the executor
renders no framework env, and this script plays horovodrun's part: the
rendezvous address is worker 0's registered host:port in the universal
``CLUSTER_SPEC``, the rank is ``TASK_INDEX``. From them it sets the
pytorch runtime's ``INIT_METHOD``, ``RANK`` and ``WORLD``, and the Trainer
joins one torch process group (`parallel/distributed.py`: nccl on the
card, gloo on the CPU), builds its mesh (one fsdp dim over the world
unless ``TPU_MESH_*`` says otherwise), replicates the parameters, and trains on
each rank's own rows of the global batch, the gradients summed over the
ranks. A single worker with no ``TPU_MESH_SHAPE`` forms no group.

    python -m tony_tpu_torch.examples.train_allreduce --model vit \\
        --steps 10 --device cpu

The synthetic stream is MNIST-shaped (1-channel 28 x 28), so the input
geometry follows the data whatever the preset; its depth and width stay.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from functools import partial

if __package__ in (None, ""):
    sys.path.insert(0, os.environ.get(
        "TONY_REPO_ROOT",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")))

LOG = logging.getLogger(__name__)


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tony_tpu_torch.examples."
                                          "train_allreduce")
    parser.add_argument("--model", default="resnet",
                        choices=("resnet", "vit"),
                        help="conv or attention image model; the same "
                             "all-reduce data-parallel harness drives both")
    parser.add_argument("--config", default="",
                        help="preset (default: the model's tiny preset)")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch-size", type=int, default=32,
                        help="per-process batch")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda or cpu)")
    return parser


def horovod_style_rendezvous() -> int:
    """The pytorch runtime's rendezvous env from CLUSTER_SPEC and
    TASK_INDEX alone (none is rendered for framework=horovod): worker 0's
    host:port as the tcp:// init method, the worker count as the world.
    Returns this process's rank."""
    from tony_tpu_torch import constants as C

    spec = json.loads(os.environ.get(C.CLUSTER_SPEC, "{}") or "{}")
    workers = spec.get(C.WORKER_JOB_NAME, [])
    rank = int(os.environ.get(C.TASK_INDEX, "0"))
    if workers:
        LOG.info("allreduce rendezvous: %s rank %d/%d", workers[0], rank,
                 len(workers))
        os.environ.update({C.INIT_METHOD: f"tcp://{workers[0]}",
                           C.RANK: str(rank), C.WORLD: str(len(workers))})
    return rank


def build_trainer(args, rank: int):
    """The Trainer this script runs, and the model config."""
    from tony_tpu_torch.models.resnet import (
        get_resnet_config, resnet_init, resnet_loss,
    )
    from tony_tpu_torch.models.vit import (
        get_config as get_vit_config, vit_init, vit_loss,
    )
    from tony_tpu_torch.train.data import synthetic_mnist
    from tony_tpu_torch.train.trainer import Trainer, TrainerConfig

    if args.model == "vit":
        config = get_vit_config(args.config or "vit_tiny", image_size=28,
                                patch_size=7, in_channels=1)
        loss, init = vit_loss, vit_init
    else:
        config = get_resnet_config(args.config or "resnet_tiny",
                                   in_channels=1)
        loss, init = resnet_loss, resnet_init
    trainer = Trainer(
        loss_fn=partial(loss, config=config),
        init_fn=partial(init, config),
        data_iter=synthetic_mnist(args.batch_size, process_index=rank),
        config=TrainerConfig(num_steps=args.steps, log_every=10,
                             learning_rate=1e-2, warmup_steps=2),
        device=args.device)
    return trainer, config


def main(argv=None) -> int:
    import torch.distributed as dist

    from tony_tpu_torch.ops import cuda_lib

    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rank = horovod_style_rendezvous()
    trainer, _ = build_trainer(args, rank)
    cuda_lib.reset_launches()
    try:
        final_loss = trainer.run()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # this run's launches of the port's kernels (all 0 on the CPU)
    LOG.info("kernel launches %s", json.dumps(cuda_lib.launches()))
    print(f"final loss {final_loss:.4f} (rank {rank})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
