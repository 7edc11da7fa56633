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
- `pipeline.py`: pipeline parallelism over the `pp` axis: the layer
  stacks split over pp into stages (v round-robin chunks a rank with the
  interleaved schedule), microbatches sent from stage to stage, the 1F1B
  backward recomputing each stage from its saved input
  (`models/llama.py`'s `llama_loss_pipelined`).

The `ep` axis splits the MoE expert banks (`models/moe.py`'s
`moe_param_axes`; the MLP routes the global batch and gathers the bank
outputs over ep).
"""

from tony_tpu_torch.parallel.mesh import (  # noqa: F401
    MESH_AXES, MeshPlan, axis_index, axis_size, drop_axis,
    make_mesh, mesh_from_env, plan_mesh, pp_neighbours,
)
from tony_tpu_torch.parallel.pipeline import (  # noqa: F401
    LocalStages, interleave_stage_dim, interleaved_ticks, make_pipelined_fn,
    merge_microbatches, pipeline_apply, pipeline_apply_interleaved,
    split_microbatches, stack_stage_params,
)
