"""Parallelism: the rank mesh, sharding rules and sequence parallelism.

Counterpart of `tony_tpu/parallel/`, on `torch.distributed`:

- `mesh.py`: `plan_mesh`/`MeshPlan` factor a world of ranks into the named
  axes dp, fsdp, tp, sp, pp, ep, and `mesh_from_env` builds a
  `DeviceMesh` from the `TPU_MESH_SHAPE`/`TPU_MESH_AXES` the executor
  renders (one rank per card).
- `distributed.py`: the rendezvous, from the env of TonY's pytorch or jax
  runtime, into one process group (nccl on the card, gloo on the CPU).
- `sharding.py`: the logical-axis rules, as DTensor placements.
- `ring.py` and `ulysses.py`: sequence parallelism over the `sp` axis,
  with the flash kernels (K1-K3) on each rank's chunks.

The pipeline (`pp`) and expert (`ep`) axes are planned and kept in the
mesh, but nothing is sharded over them yet.
"""
