"""Logical-axis rules as DTensor placements.

Counterpart of `tony_tpu/parallel/sharding.py`. Models name each tensor
dim with a *logical* axis ("vocab", "embed", "heads", ...); the rules map
those to mesh axes, and a mesh turns that into one DTensor placement per
mesh dim: `Shard(d)` where the mesh axis shards tensor dim d,
`Replicate()` elsewhere. The rules are the JAX package's (combined FSDP
and tensor parallelism: weights shard their output-feature dim on tp and
their input dim on fsdp), with both of its rules kept: a mesh axis shards
at most one tensor dim (the first that asks), and an axis absent from the
mesh replicates.

`constrain` is `with_sharding_constraint`'s counterpart: a `redistribute`
of a DTensor to the rule's placements (DTensor inserts the collective),
and a no-op on a plain tensor, so the model code runs unchanged on one
device.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor, Partial, Placement, Replicate, Shard,
)
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset,
)

from tony_tpu_torch.train.optim import tree_map

# (logical axis, mesh axis | tuple of mesh axes | None). First match wins;
# None = replicate. Tuples shard one logical dim over several mesh axes
# jointly (batch over dp AND fsdp, dp major).
DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("vocab", "tp"),
    ("embed", "fsdp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("expert", "ep"),
    ("layers", "pp"),
    ("stage", "pp"),
    ("norm", None),
)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules=DEFAULT_RULES,
                    axis_names: Optional[Sequence[str]] = None) -> tuple:
    """('vocab', 'embed') -> ('tp', 'fsdp'): the mesh axes of each tensor
    dim, as the JAX package's PartitionSpec lists them (an entry is None,
    an axis name or a tuple of them; trailing Nones dropped). Axes not in
    `axis_names` (when given) replicate."""
    rule_map = dict(rules)
    available = set(axis_names) if axis_names is not None else None

    def resolve(mesh_ax):
        if mesh_ax is None:
            return None
        if isinstance(mesh_ax, tuple):
            kept = tuple(a for a in mesh_ax
                         if available is None or a in available)
            return kept if kept else None
        if available is not None and mesh_ax not in available:
            return None
        return mesh_ax

    spec = []
    used: set = set()
    for ax in logical_axes:
        mesh_ax = resolve(rule_map.get(ax)) if ax is not None else None
        # a mesh axis shards at most one tensor dim: first dim wins
        if isinstance(mesh_ax, tuple):
            mesh_ax = tuple(a for a in mesh_ax if a not in used) or None
            if mesh_ax is not None:
                used.update(mesh_ax)
        elif mesh_ax is not None:
            if mesh_ax in used:
                mesh_ax = None
            else:
                used.add(mesh_ax)
        spec.append(mesh_ax)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def spec_to_placements(spec: Sequence, mesh: DeviceMesh
                       ) -> tuple[Placement, ...]:
    """One placement per mesh dim: Shard(d) where the dim's axis is named
    by spec entry d, Replicate() where no entry names it."""
    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                dim_of[axis] = d
    # a mesh dim of size 1 splits nothing: Replicate says the same, and
    # keeps an op on the tensor a local view (a stacked weight's layer
    # slice on a pp of 1)
    return tuple(Shard(dim_of[name])
                 if name in dim_of and mesh.size(i) > 1 else Replicate()
                 for i, name in enumerate(mesh.mesh_dim_names))


def logical_to_mesh_axes(logical_axes: Sequence[Optional[str]],
                         rules=DEFAULT_RULES,
                         mesh: Optional[DeviceMesh] = None
                         ) -> tuple[Placement, ...]:
    """The placements (one per mesh dim of `mesh`) of a tensor whose dims
    carry `logical_axes`."""
    if mesh is None:
        raise ValueError("placements need a mesh")
    return spec_to_placements(
        logical_to_spec(logical_axes, rules, mesh.mesh_dim_names), mesh)


def to_placements(x: DTensor, placements: Sequence[Placement]) -> DTensor:
    """`x` redistributed to `placements` (itself when it has them)."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain(x, logical_axes: Sequence[Optional[str]],
              rules=DEFAULT_RULES):
    """Redistribute the DTensor `x` to the placements of `logical_axes` on
    its own mesh; a plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    return to_placements(x, logical_to_mesh_axes(logical_axes, rules,
                                                 x.device_mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def make_partition_spec(logical_tree: Any, rules=DEFAULT_RULES,
                        mesh: Optional[DeviceMesh] = None) -> Any:
    """A tree of logical-axes tuples -> the same tree of placements."""
    if isinstance(logical_tree, dict):
        return {k: make_partition_spec(v, rules, mesh)
                for k, v in logical_tree.items()}
    if not _is_axes(logical_tree):
        raise TypeError(f"not a logical-axes tuple: {logical_tree!r}")
    return logical_to_mesh_axes(logical_tree, rules, mesh)


def _children(node):
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def tree_paths(tree, is_leaf=lambda x: False) -> list:
    """[(key path, leaf)] of nested dicts, namedtuples and tuples; None
    is a leaf."""
    kids = None if is_leaf(tree) else _children(tree)
    if kids is None:
        return [((), tree)]
    return [((str(k),) + p, leaf) for k, child in kids
            for p, leaf in tree_paths(child, is_leaf)]


def _map_like(tree, leaves):
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _map_like(v, leaves) for k, v in kids}
    vals = [_map_like(v, leaves) for _, v in kids]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(
        vals)


def is_placements(x) -> bool:
    """Whether `x` is a tuple of placements (a leaf of a placements
    tree)."""
    return (isinstance(x, tuple) and len(x) > 0
            and all(isinstance(p, Placement) for p in x))


def opt_state_specs(opt_state_tree: Any, param_specs: Any) -> Any:
    """Placements for an optimizer state tree (the optax layout of
    `OptState.tree()`), from the params' placements: a state leaf whose
    key-path SUFFIX is a parameter's path (f32 masters, Adam mu and nu)
    gets that parameter's placements; everything else (counts) is None,
    a host value that is not sharded."""
    by_path = dict(tree_paths(param_specs, is_placements))
    out = []
    for path, leaf in tree_paths(opt_state_tree):
        spec = None
        for i in range(len(path)):
            cand = by_path.get(path[i:])
            if cand is not None and getattr(leaf, "ndim", 0) >= 1:
                spec = cand
                break
        out.append(spec)
    return _map_like(opt_state_tree, iter(out))


def local_region(shape: Sequence[int], mesh: DeviceMesh,
                 placements: Sequence[Placement]) -> list[list[int]]:
    """[[start, stop], ...] per dim: the region of a global `shape` this
    rank holds under `placements`."""
    local, offset = compute_local_shape_and_global_offset(
        list(shape), mesh, list(placements))
    return [[o, o + n] for o, n in zip(offset, local)]


def shard_tensor(x: torch.Tensor, mesh: DeviceMesh,
                 placements: Sequence[Placement]) -> DTensor:
    """A DTensor of `x`, which every rank built the same (from one seed):
    each rank keeps its own region and no collective runs. A tensor that
    is not split stays the same storage; a split one keeps a copy of this
    rank's region only."""
    shape = x.shape
    region = local_region(shape, mesh, placements)
    if any(b - a != n for (a, b), n in zip(region, shape)):
        x = x[tuple(slice(a, b) for a, b in region)].clone()
    return DTensor.from_local(x, mesh, placements, run_check=False,
                              shape=shape, stride=_contiguous_strides(shape))


def shard_pytree(tree: Any, logical_tree: Any, mesh: DeviceMesh,
                 rules=DEFAULT_RULES) -> Any:
    """Every tensor of a nested dict as a DTensor placed by its logical
    axes (`shard_tensor`)."""
    def place(x, placements):
        if isinstance(x, dict):
            return {k: place(v, placements[k]) for k, v in x.items()}
        return shard_tensor(x, mesh, placements)

    return place(tree, make_partition_spec(logical_tree, rules, mesh))


def _contiguous_strides(shape) -> tuple[int, ...]:
    strides, acc = [], 1
    for n in reversed(list(shape)):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


def replicated(x: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """`x` (the same on every rank) as a DTensor replicated over `mesh`."""
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def gathered_local(w: torch.Tensor, x: DTensor) -> torch.Tensor:
    """The weight `w` whole on every rank, as a local tensor for an op on
    the DTensor `x`'s local rows. Its gradient is a partial sum over the
    mesh dims that split `x`, which the backward of the gather
    reduce-scatters back onto `w`'s own shards."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    if any(p.is_shard() for p in w.placements):
        w = w.redistribute(mesh, [Replicate()] * mesh.ndim)
    return w.to_local(grad_placements=[
        Partial() if p.is_shard() else Replicate() for p in x.placements])


def data_shards(x: DTensor) -> int:
    """How many pieces the mesh dims that shard `x` cut it into."""
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard():
            n *= x.device_mesh.size(i)
    return n


def sum_over_shards(local: torch.Tensor, x: DTensor) -> torch.Tensor:
    """The sum over the ranks that hold different shards of `x` of each
    rank's `local` value, the same on every rank, as a plain tensor.
    Differentiable: each rank's `local` gets the full gradient."""
    mesh = x.device_mesh
    partial = DTensor.from_local(
        local, mesh,
        [Partial() if p.is_shard() else Replicate() for p in x.placements],
        run_check=False)
    return partial.full_tensor()


def data_parallel_loss(loss_fn, params: Any, batch: dict) -> torch.Tensor:
    """`loss_fn(params, batch)` (a mean over the batch's rows). With the
    batch's leaves DTensors (a Trainer under a mesh: rows over (dp,
    fsdp)), each rank runs `loss_fn` on its local rows with every
    parameter whole (`gathered_local`), and the ranks' means are averaged
    (`sum_over_shards`): the global mean, a plain tensor equal on every
    rank, whose gradient reaches each parameter as the sum over the data
    ranks, as GSPMD's all-reduce gives the JAX package's image models.
    Plain tensors go straight to `loss_fn`."""
    x = next(iter(batch.values()))
    if not isinstance(x, DTensor):
        return loss_fn(params, batch)
    batch = {k: constrain(v, ("batch",) + (None,) * (v.ndim - 1))
             for k, v in batch.items()}
    x = next(iter(batch.values()))
    local = loss_fn(tree_map(lambda w: gathered_local(w, x), params),
                    {k: v.to_local() for k, v in batch.items()})
    return sum_over_shards(local / data_shards(x), x)


def gather_for_use(w):
    """A DTensor weight with its fsdp (and dp) shards gathered, the FSDP
    all-gather before a product (its backward reduce-scatters the
    gradient); tp shards stay. Anything else is returned as it is."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in ("dp", "fsdp") else p
                 for i, p in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def local_matmul(x: DTensor, w: DTensor) -> DTensor:
    """x @ w of a DTensor x (..., K) and a 2-d DTensor weight w (K, N),
    computed on the local shards: per mesh dim, a weight split over its
    columns (N) gives an output split over its last dim, one split over
    its rows (K, with x split over K there too) a partial sum, and an
    unsplit weight the output split as x is. x is redistributed first
    where a dim asks for it. DTensor's own matmul flattens x to 2-d,
    which torch 2.11's view rule refuses when the sequence dim is split
    (sp)."""
    last = x.ndim - 1
    want, out, gx, gw = [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if pw.is_shard() and pw.dim == 1:          # columns: x whole
            px_need, po = Replicate(), Shard(last)
        elif pw.is_shard() and pw.dim == 0:        # rows: x split on K
            px_need, po = Shard(last), Partial()
        else:                                      # w whole: x as it is
            px_need = Replicate() if px.is_shard() and px.dim == last \
                else px
            po = px_need
        want.append(px_need)
        out.append(po)
        # the gradients: x's is a partial sum where w's columns are split,
        # w's where x's rows are
        gx.append(Partial() if pw.is_shard() and pw.dim == 1 else px_need)
        gw.append(Partial() if px_need.is_shard() and pw.is_replicate()
                  else pw)
    x = to_placements(x, want)
    y = x.to_local(grad_placements=gx) @ w.to_local(grad_placements=gw)
    return DTensor.from_local(y, x.device_mesh, out, run_check=False)


def splits_dim0(w) -> bool:
    """Whether the DTensor `w` splits its leading dim over a mesh dim (a
    layer stack over pp)."""
    return isinstance(w, DTensor) and any(
        p.is_shard() and p.dim == 0 for p in w.placements)


def whole_dim0(w: DTensor) -> DTensor:
    """`w` with its leading dim gathered whole on every rank (GSPMD's
    gather of a pp-split layer stack for a loss that is not pipelined);
    differentiable, the gradient of each rank's slice its own."""
    return to_placements(w, tuple(
        Replicate() if p.is_shard() and p.dim == 0 else p
        for p in w.placements))


def stage_local(w, pp_dim: Optional[int], pp: int, layers: list[int]
                ) -> torch.Tensor:
    """This pp rank's stage stack of the layer stack `w` as a local
    tensor (inner dims still split as `w` splits them), its layers in the
    order `layers` lists them (global indices).

    At rest the stack lies contiguous on pp, so with one chunk a rank
    (`layers` its own contiguous block) it is the local shard itself. The
    interleaved schedule's round-robin chunks instead gather the stack
    over pp and take this rank's layers: the move the JAX package makes
    with an all-gather and a re-slice. Its gradient goes back by the
    inverse move: each rank's chunk gradients scattered into a zero
    stack, a partial sum over pp, reduce-scattered onto the owners."""
    if not isinstance(w, DTensor):
        return w if layers == list(range(w.shape[0])) else \
            w.index_select(0, torch.tensor(layers, device=w.device))
    if pp_dim is None or pp == 1:
        local = w.to_local()
        return local if layers == list(range(local.shape[0])) else \
            local.index_select(0, torch.tensor(layers, device=local.device))
    per = w.shape[0] // pp
    me = w.device_mesh.get_local_rank(pp_dim)
    if layers == list(range(me * per, (me + 1) * per)):
        return w.to_local()
    whole = to_placements(w, tuple(Replicate() if i == pp_dim else p
                                   for i, p in enumerate(w.placements)))
    local = whole.to_local(grad_placements=[
        Partial() if i == pp_dim else p
        for i, p in enumerate(whole.placements)])
    return local.index_select(0, torch.tensor(layers, device=local.device))
