"""The rendezvous: one torch process group over a TonY gang.

Counterpart of `maybe_initialize_distributed` in
`tony_tpu/train/trainer.py`. The executor renders a rendezvous env per
task, and the port reads either runtime's:

- `tony.application.framework=pytorch`: INIT_METHOD (tcp:// of worker 0's
  reserved port, handed over to the user process), RANK and WORLD;
- `tony.application.framework=jax`: JAX_COORDINATOR_ADDRESS (host:port of
  process 0), JAX_PROCESS_ID and JAX_NUM_PROCESSES.

The backend is nccl on a card and gloo only on the CPU (`--device cpu`);
one never falls back to the other. A world of one skips the rendezvous
unless TPU_MESH_SHAPE asks for a mesh, so a plain single-process run
builds no process group at all.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from tony_tpu_torch import constants as C

LOG = logging.getLogger(__name__)

# how long a rank waits for the others at the rendezvous and in a
# collective before it raises
TIMEOUT = timedelta(minutes=10)


def rendezvous_env(env=None) -> Optional[tuple[str, int, int]]:
    """(init_method, rank, world) from the pytorch runtime's env, else the
    jax runtime's; None when neither is rendered."""
    env = os.environ if env is None else env
    if env.get(C.WORLD):
        # env:// reads the MASTER_ADDR/MASTER_PORT the runtime renders too
        return (env.get(C.INIT_METHOD) or "env://",
                int(env.get(C.RANK, "0")), int(env[C.WORLD]))
    if env.get(C.JAX_NUM_PROCESSES):
        return (f"tcp://{env[C.JAX_COORDINATOR_ADDRESS]}",
                int(env.get(C.JAX_PROCESS_ID, "0")),
                int(env[C.JAX_NUM_PROCESSES]))
    return None


def gang(env=None) -> tuple[int, int]:
    """(world size, this process's rank) from the env the rendezvous
    reads; (1, 0) outside a gang."""
    found = rendezvous_env(env)
    return (found[2], found[1]) if found is not None else (1, 0)


def backend_for(device: torch.device) -> str:
    """nccl for a card, gloo for the CPU."""
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def maybe_initialize_distributed(device: torch.device) -> bool:
    """Join the gang's process group if the env asks for one; returns
    whether a process group is up. Idempotent: a group already up (of the
    same backend) is kept. On a card each rank takes card `rank %
    device_count()` unless the device names one."""
    device = torch.device(device)
    want = backend_for(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(f"a {have} process group is up; this run on "
                               f"{device} needs {want}")
        return True
    found = rendezvous_env()
    if found is None:
        if not os.environ.get(C.TPU_MESH_SHAPE):
            return False
        raise RuntimeError(
            f"{C.TPU_MESH_SHAPE} asks for a mesh but no rendezvous env is "
            f"set ({C.INIT_METHOD}/{C.RANK}/{C.WORLD} or "
            f"{C.JAX_COORDINATOR_ADDRESS}/{C.JAX_PROCESS_ID}/"
            f"{C.JAX_NUM_PROCESSES})")
    init_method, rank, world = found
    if world <= 1 and not os.environ.get(C.TPU_MESH_SHAPE):
        return False
    kwargs = {}
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    LOG.info("init_process_group(%s, %s, rank=%d, world=%d)", want,
             init_method, rank, world)
    dist.init_process_group(want, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT, **kwargs)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """All ranks meet here; a no-op without a process group."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
