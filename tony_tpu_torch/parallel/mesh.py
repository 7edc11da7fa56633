"""The rank mesh: named axes over the ranks of one process group.

Counterpart of `tony_tpu/parallel/mesh.py`. One rank drives one card, so
where the JAX package lays devices onto a `jax.sharding.Mesh`, the port
lays ranks onto a `torch.distributed.device_mesh.DeviceMesh` with
`mesh_dim_names`. The canonical axis order puts the axes that may cross
slices (dp) outermost and the bandwidth-hungry ones (fsdp, tp, sp) inside
a slice. Axes of size 1 are kept, so a placement can name every
canonical axis on any mesh.

A slice is a contiguous block of ceil(WORLD / TPU_NUM_SLICES) ranks, the
ceil-div the executor's jax runtime renders TPU_SLICE_ID with.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tony_tpu_torch import constants as C

# canonical axis order: DCN-crossing axes first (outer), ICI axes inner
MESH_AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")


@dataclass
class MeshPlan:
    """A named mesh shape; axes of size 1 are kept so placements can
    reference every canonical axis unconditionally."""
    shape: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for axis in self.shape:
            if axis not in MESH_AXES:
                raise ValueError(f"unknown mesh axis {axis!r}; "
                                 f"expected subset of {MESH_AXES}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a in MESH_AXES if a in self.shape)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape.values()) if self.shape else 1

    def dims(self) -> tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axis_names)


def plan_mesh(num_devices: int, *, tp: int = 1, sp: int = 1, pp: int = 1,
              ep: int = 1, fsdp: int = 0, dp: int = 0) -> MeshPlan:
    """Factor `num_devices` into a mesh plan. Explicit tp/sp/pp/ep are taken
    as given; the remainder goes to fsdp (default) and dp. Pass fsdp/dp
    explicitly to pin them; 0 means 'absorb the remainder' (fsdp wins)."""
    fixed = tp * sp * pp * ep
    if num_devices % fixed != 0:
        raise ValueError(
            f"{num_devices} devices not divisible by tp*sp*pp*ep={fixed}")
    remainder = num_devices // fixed
    if fsdp and dp:
        if dp * fsdp != remainder:
            raise ValueError(
                f"dp*fsdp={dp * fsdp} != remaining device count {remainder}")
    elif fsdp:
        if remainder % fsdp != 0:
            raise ValueError(f"fsdp={fsdp} does not divide {remainder}")
        dp = remainder // fsdp
    elif dp:
        if remainder % dp != 0:
            raise ValueError(f"dp={dp} does not divide {remainder}")
        fsdp = remainder // dp
    else:
        dp, fsdp = 1, remainder
    return MeshPlan({"dp": dp, "fsdp": fsdp, "tp": tp, "sp": sp,
                     "pp": pp, "ep": ep})


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.is_initialized() and \
        dist.get_backend() == "nccl" else "cpu"


def rank_grid(plan: MeshPlan, ranks: Sequence[int]) -> np.ndarray:
    """The first `plan.num_devices` of `ranks`, shaped to the plan."""
    if len(ranks) < plan.num_devices:
        raise ValueError(
            f"mesh needs {plan.num_devices} devices, have {len(ranks)}")
    return np.array(list(ranks)[: plan.num_devices]).reshape(plan.dims())


def _device_mesh(plan: MeshPlan, grid: np.ndarray,
                 device_type: Optional[str]) -> DeviceMesh:
    return DeviceMesh(_device_type(device_type), torch.as_tensor(grid),
                      mesh_dim_names=plan.axis_names)


def make_mesh(plan: MeshPlan, device_type: Optional[str] = None
              ) -> DeviceMesh:
    """The DeviceMesh of `plan` over the world's first ranks, in rank
    order, which keeps the inner axes on neighbouring ranks. Needs an
    initialized process group."""
    return _device_mesh(plan, rank_grid(plan, range(_world())),
                        device_type)


def hybrid_rank_grid(plan: MeshPlan, slice_of: Sequence[int]
                     ) -> np.ndarray:
    """The rank grid of a multi-slice layout, rank r lying in slice
    `slice_of[r]`: ranks ordered slice-major so the OUTERMOST plan axes
    span slices and everything inner stays within one, the rule that only
    data parallelism should cross DCN. A plan that fits in one slice stays
    there; otherwise it must take whole slices, and only dp (or axes of
    size 1) may contribute to the product before it covers them."""
    slices: dict[int, list[int]] = {}
    for rank, s in enumerate(slice_of):
        slices.setdefault(s, []).append(rank)
    if len(slices) <= 1:
        return rank_grid(plan, list(range(len(slice_of))))
    n_slices = len(slices)
    per_slice = min(len(v) for v in slices.values())
    if n_slices * per_slice < plan.num_devices:
        raise ValueError(
            f"mesh needs {plan.num_devices} devices; have {n_slices} "
            f"slices x {per_slice}")
    if plan.num_devices <= per_slice:
        return rank_grid(plan, slices[sorted(slices)[0]])
    if plan.num_devices % per_slice != 0:
        raise ValueError(
            f"plan of {plan.num_devices} devices does not tile whole "
            f"slices of {per_slice}; choose a mesh whose inner axes "
            f"multiply to a multiple of the slice size")
    used_slices = plan.num_devices // per_slice
    ordered = []
    for s in sorted(slices)[:used_slices]:
        ordered.extend(slices[s][:per_slice])
    n_slices = used_slices
    dims = plan.dims()
    names = plan.axis_names
    outer = 1
    for name, dim in zip(names, dims):
        if outer % n_slices == 0:
            break
        if dim > 1 and name != "dp":
            raise ValueError(
                f"slice boundary falls inside ICI-intended axis {name!r}: "
                f"mesh {dict(zip(names, dims))} on {n_slices} slices needs "
                f"dp (outermost) to cover the slice count so only data "
                f"parallelism rides DCN")
        outer *= dim
    if outer % n_slices != 0:
        raise ValueError(
            f"outer mesh axes {dims} do not tile {n_slices} slices; "
            f"put the DCN-crossing axis (dp) outermost")
    return np.array(ordered[: plan.num_devices]).reshape(dims)


def slice_of_ranks(world: int, num_slices: int) -> list[int]:
    """Each rank's slice: contiguous blocks of ceil(world / num_slices)
    ranks, as the executor renders TPU_SLICE_ID."""
    per_slice = max(1, -(-world // max(1, num_slices)))
    return [r // per_slice for r in range(world)]


def make_hybrid_mesh(plan: MeshPlan, num_slices: int,
                     device_type: Optional[str] = None) -> DeviceMesh:
    """`make_mesh` for a world split into `num_slices` slices
    (`hybrid_rank_grid`)."""
    grid = hybrid_rank_grid(plan, slice_of_ranks(_world(), num_slices))
    return _device_mesh(plan, grid, device_type)


def plan_from_env(world: int) -> tuple[MeshPlan, int]:
    """(plan, slice count) from TPU_MESH_SHAPE/TPU_MESH_AXES and
    TPU_NUM_SLICES; pure fsdp over `world` ranks when the shape is
    unset."""
    shape_s = os.environ.get(C.TPU_MESH_SHAPE, "")
    axes_s = os.environ.get(C.TPU_MESH_AXES, "")
    if not shape_s:
        return plan_mesh(world), 1
    dims = [int(x) for x in shape_s.split(",") if x.strip()]
    axes = [a.strip() for a in axes_s.split(",") if a.strip()]
    if len(dims) != len(axes):
        raise ValueError(
            f"TPU_MESH_SHAPE {shape_s!r} / TPU_MESH_AXES {axes_s!r} mismatch")
    return (MeshPlan(dict(zip(axes, dims))),
            int(os.environ.get(C.TPU_NUM_SLICES, "1")))


def mesh_from_env(device_type: Optional[str] = None) -> DeviceMesh:
    """The mesh the executor asked for (TPU_MESH_SHAPE='2,2,2' +
    TPU_MESH_AXES='dp,fsdp,tp'), over the process group's ranks, with
    every axis it names, size-1 ones too. Multi-slice jobs
    (TPU_NUM_SLICES > 1) lay the outermost axis across slices. Unset: a
    1-dim fsdp mesh over the world. The default plan's other five axes
    are of size 1, which the code reads as absent (`axis_size`,
    `axis_index`, the placement rules), and DTensor's sharding
    propagation enumerates strategies over every mesh dim: over all six,
    each new shape's first op took orders of magnitude longer."""
    if not os.environ.get(C.TPU_MESH_SHAPE, ""):
        return make_mesh(MeshPlan({"fsdp": _world()}), device_type)
    plan, num_slices = plan_from_env(_world())
    if num_slices > 1:
        return make_hybrid_mesh(plan, num_slices, device_type)
    return make_mesh(plan, device_type)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of `axis` in `mesh` (1 when absent or no mesh)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's coordinate along `axis` (0 when absent or no mesh)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def pp_neighbours(mesh: DeviceMesh, axis: str = "pp") -> tuple[int, int]:
    """(previous, next) global ranks of this rank along pp: its own
    coordinates on every other axis, pp - 1 and pp + 1 (mod the pp
    size). The pipeline's sends go to `next`, its receives come from
    `previous` (the reverse in the backward)."""
    grid = mesh.mesh
    coord = list(mesh.get_coordinate())
    dim = mesh.mesh_dim_names.index(axis)
    n = grid.shape[dim]
    out = []
    for step in (-1, 1):
        at = list(coord)
        at[dim] = (coord[dim] + step) % n
        out.append(int(grid[tuple(at)]))
    return out[0], out[1]


def drop_axis(mesh: Optional[DeviceMesh], axis: str
              ) -> Optional[DeviceMesh]:
    """The submesh of this rank's other axes (the mesh a pipeline stage
    runs on, without pp): None when no mesh, or when those axes hold
    this rank alone, so the stage runs on plain tensors."""
    if mesh is None:
        return None
    names = tuple(a for a in mesh.mesh_dim_names if a != axis)
    if not names or math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                              for a in names) == 1:
        return None
    return mesh[names]


def env_rank_grid(world: int) -> tuple[MeshPlan, np.ndarray]:
    """The plan and rank grid `mesh_from_env` lays out for `world` ranks,
    without a process group (the entry point needs them before the
    rendezvous)."""
    plan, num_slices = plan_from_env(world)
    if num_slices > 1:
        return plan, hybrid_rank_grid(plan, slice_of_ranks(world,
                                                           num_slices))
    return plan, rank_grid(plan, range(world))


def data_index(world: int, rank: int) -> int:
    """Which shard of the global batch rank `rank` holds on the mesh the
    env asks for: its (dp, fsdp) coordinate, dp major. Ranks that differ
    only on the other axes (tp, sp, ...) hold the same rows."""
    plan, grid = env_rank_grid(world)
    where = np.argwhere(grid == rank)
    if not len(where):
        raise ValueError(f"rank {rank} is not in the mesh {plan.shape}")
    coord = dict(zip(plan.axis_names, where[0]))
    return int(coord.get("dp", 0)) * plan.shape.get("fsdp", 1) + int(
        coord.get("fsdp", 0))
