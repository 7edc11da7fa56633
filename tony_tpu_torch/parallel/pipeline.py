"""Pipeline parallelism: microbatches through the stages of the `pp` axis.

Counterpart of `tony_tpu/parallel/pipeline.py`, on `torch.distributed`.
Each rank of the pp group holds one stage's layers (the local `pp` shard
of the stacked weights), or, with `n_virtual` = v > 1, v round-robin
chunks of them (chunk j on pp rank d is virtual stage j * n + d, as
`interleave_stage_dim` lays them out).

- **The tick plan** is the JAX package's, as plain functions on ints:
  `interleaved_ticks`, `_sched_fwd`, `_sched_bwd` and `_exit_ticks`
  (v = 1 is the plain fill/drain schedule), so the tests hold them to
  JAX's case for case.
- **Forward** (`_forward`): at tick t, pp rank d runs the (chunk,
  microbatch) slot `_sched_fwd(t, d)` gives it on the microbatch stream
  (stage 0, chunk 0) or on what the previous rank sent it last tick, and
  keeps that stage INPUT, nothing else. The last stage's outputs are
  broadcast to every pp rank (JAX's masked `psum`), so each can take the
  loss.
- **Backward** (`_backward`), hand-scheduled in 1F1B drain order: at tick
  t rank d recomputes the slot `_sched_bwd(t, d)` from its saved input
  with grad on and runs its backward against the cotangent of the next
  stage (the dy stream for the exit slot), accumulating the weight
  gradients in f32 per chunk and casting once at the end (JAX's
  `_acc_dtype`); the input cotangent goes to the previous rank. Stage 0's
  input gradients are broadcast to every pp rank.
- **Sends**: once a tick, every rank sends to the next rank of the ring
  and receives from the previous one (reverse in the backward), as one
  `batch_isend_irecv`, as `parallel/ring.py` rotates K/V; a rank with no
  valid slot sends zeros. So no rank waits on a send its peer never
  posts, on gloo or nccl. Where JAX's lockstep scan computes every tick
  and masks the invalid ones, a rank here skips them: its valid ticks
  compute exactly what JAX's do.

The schedule runs over a transport: `_PpRing` (one stage per process, the
pp process group) or `LocalStages` (all n stages in one process, a copy
standing in for each send: a one-process check of the schedule's
arithmetic, for `chip_smoke.py`; the entry point never builds one). The
per-tick stage body is the caller's `stage_fn(chunk_params, x) -> y`.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from tony_tpu_torch.parallel.mesh import pp_neighbours

StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# the tick plan
# ---------------------------------------------------------------------------

def interleaved_ticks(n_micro: int, n_stages: int, v: int) -> int:
    """Ticks of ONE phase (forward or backward) of the interleaved
    schedule (v = 1: the fill/drain schedule's M + n - 1)."""
    return n_micro * v + n_stages - 1


def _wave(sigma: int, n_micro: int, n: int, v: int
          ) -> tuple[bool, int, int]:
    valid = 0 <= sigma < n_micro * v
    sigma = min(max(sigma, 0), n_micro * v - 1)
    b, r = divmod(sigma, n * v)
    return valid, r // n, b * n + r % n


def _sched_fwd(t: int, d: int, n_micro: int, n: int, v: int
               ) -> tuple[bool, int, int]:
    """-> (valid, chunk j, microbatch m) for device d at forward tick t."""
    return _wave(t - d, n_micro, n, v)


def _sched_bwd(t: int, d: int, n_micro: int, n: int, v: int
               ) -> tuple[bool, int, int]:
    """-> (valid, chunk j, microbatch m) for device d at backward tick t:
    the forward's wave mirrored, chunks in reverse."""
    valid, j, m = _wave(t - (n - 1 - d), n_micro, n, v)
    return valid, (v - 1) - j, m


def _exit_ticks(n_micro: int, n: int, v: int) -> list[int]:
    """The tick at which microbatch m's last virtual stage completes on
    the exit device: the same for the forward (chunk v-1, device n-1) and
    the backward (chunk 0, device 0)."""
    return [(m // n) * n * v + (v - 1) * n + (m % n) + (n - 1)
            for m in range(n_micro)]


def _saved_tick(j: int, m: int, d: int, n: int, v: int) -> int:
    """The forward tick at which device d saved the input of (chunk j,
    microbatch m)."""
    return (m // n) * n * v + j * n + (m % n) + d


# ---------------------------------------------------------------------------
# stacking and microbatches
# ---------------------------------------------------------------------------

def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def interleave_stage_dim(stacked: Any, n_stages: int, v: int) -> Any:
    """Reorder a (n*v, ...)-leading stacked tree from virtual-stage order
    (s = 0..n*v-1) into the contiguous-shard layout: position d*v + j
    holds virtual stage j*n + d, so a split of dim 0 over pp hands device
    d exactly its round-robin chunks [d, n+d, ...]."""
    def one(p):
        vn = p.shape[0]
        if vn != n_stages * v:
            raise ValueError(f"stage dim {vn} != n_stages*v "
                             f"{n_stages}*{v}")
        return p.reshape((v, n_stages) + tuple(p.shape[1:])).transpose(
            0, 1).reshape((vn,) + tuple(p.shape[1:]))
    return _tree_map(one, stacked)


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (M, B/M, ...)."""
    b = x.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def merge_microbatches(y: torch.Tensor) -> torch.Tensor:
    return y.reshape((y.shape[0] * y.shape[1],) + tuple(y.shape[2:]))


def stack_stage_params(per_stage_params: list) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    dim."""
    return _tree_map(lambda *xs: torch.stack(xs, dim=0), *per_stage_params)


def virtual_stage_layers(d: int, n: int, v: int, per_chunk: int
                         ) -> list[int]:
    """The layer indices device d holds, in its local order: its chunks
    j = 0..v-1 (virtual stages j * n + d), `per_chunk` layers each."""
    return [(j * n + d) * per_chunk + i for j in range(v)
            for i in range(per_chunk)]


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class _PpRing:
    """One stage per process over the pp process group `group` (None: a
    pp of 1, this process alone). `neighbours`: the (previous, next)
    global ranks along pp (`mesh.pp_neighbours`); by default the group's
    ring order gives them."""

    def __init__(self, group, neighbours: Optional[tuple[int, int]] = None):
        self.group = group
        self.n = dist.get_world_size(group) if group is not None else 1
        me = dist.get_rank(group) if group is not None else 0
        self.devices = (me,)
        if neighbours is None and self.n > 1:
            neighbours = (self._peer(me - 1), self._peer(me + 1))
        self.neighbours = neighbours

    def _peer(self, d: int) -> int:
        return dist.get_global_rank(self.group, d % self.n)

    def shift(self, values: dict, step: int, like: torch.Tensor) -> dict:
        """Device d's value to device d + step, step +1 or -1 (mod n): a
        send to that neighbour and a receive from the other, in one
        batch. None sends zeros (a tick with no valid slot)."""
        (me,) = self.devices
        if self.n == 1:
            return dict(values)
        prev, nxt = self.neighbours
        dst, src = (nxt, prev) if step == 1 else (prev, nxt)
        out = values[me]
        send = torch.zeros_like(like) if out is None else out.contiguous()
        recv = torch.empty_like(like)
        ops = [dist.P2POp(dist.isend, send, dst, self.group),
               dist.P2POp(dist.irecv, recv, src, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return {me: recv}

    def broadcast(self, t: Optional[torch.Tensor], src: int,
                  like: torch.Tensor) -> torch.Tensor:
        """Device src's tensor on every device."""
        if self.n == 1:
            return t
        if t is None:
            t = torch.empty_like(like)
        dist.broadcast(t, src=self._peer(src), group=self.group)
        return t


class LocalStages:
    """All n pipeline stages in this process: each tick runs every
    device's slot in turn, and a copy of each device's output stands in
    for its send. The schedule's arithmetic on one card; the entry point
    never uses it."""

    def __init__(self, n: int):
        self.n = n
        self.devices = tuple(range(n))

    def shift(self, values: dict, step: int, like: torch.Tensor) -> dict:
        return {(d + step) % self.n: None if y is None else y.clone()
                for d, y in values.items()}

    def broadcast(self, t, src: int, like) -> torch.Tensor:
        return t


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def stage_vjp(stage_fn: StageFn, params: dict, x: torch.Tensor,
              g: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """(d params, dx) of y = stage_fn(params, x) against the cotangent g:
    the stage recomputed from its input with grad on, then its backward.
    The parameters enter as fresh leaves (detached, taking grad), so the
    stage's own per-layer gradient routing applies."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    x_leaf = x.detach().requires_grad_()
    with torch.enable_grad():
        y = stage_fn(leaves, x_leaf)
    torch.autograd.backward(y, g)
    return {k: leaf.grad for k, leaf in leaves.items()}, x_leaf.grad


def _forward(stage_fn: StageFn, chunks: dict, microbatches: torch.Tensor,
             transport, v: int):
    """(out (M, mb, ...) on every device, saved inputs {device: [tick ->
    input or None]})."""
    n, n_micro = transport.n, microbatches.shape[0]
    ticks = interleaved_ticks(n_micro, n, v)
    like = microbatches[0]
    carry = {d: None for d in transport.devices}
    ins = {d: [None] * ticks for d in transport.devices}
    outs: list = [None] * n_micro
    for t in range(ticks):
        ys = {}
        for d in transport.devices:
            valid, j, m = _sched_fwd(t, d, n_micro, n, v)
            y = None
            if valid:
                x = microbatches[m] if d == 0 and j == 0 else carry[d]
                ins[d][t] = x
                y = stage_fn(chunks[d][j], x)
                if d == n - 1 and j == v - 1:
                    outs[m] = y
            ys[d] = y
        if t < ticks - 1:
            carry = transport.shift(ys, +1, like)
    out = torch.stack(outs) if n - 1 in transport.devices else None
    return transport.broadcast(out, n - 1, microbatches), ins


def _acc_dtype(p: torch.Tensor) -> torch.dtype:
    """At least f32 for a floating gradient's running sum (a bf16 sum
    over microbatches drops low-order contributions)."""
    if p.is_floating_point():
        return torch.promote_types(p.dtype, torch.float32)
    return p.dtype


def _backward(stage_fn: StageFn, chunks: dict, ins: dict, dy: torch.Tensor,
              transport, v: int):
    """({device: [chunk -> {name: f32 gradient}]}, d microbatches on every
    device). Each saved input is dropped once its tick has used it."""
    n, n_micro = transport.n, dy.shape[0]
    ticks = interleaved_ticks(n_micro, n, v)
    like = dy[0]
    acc = {d: [None] * v for d in transport.devices}
    g_carry = {d: None for d in transport.devices}
    d_mb: list = [None] * n_micro
    for t in range(ticks):
        gs = {}
        for d in transport.devices:
            valid, j, m = _sched_bwd(t, d, n_micro, n, v)
            dx = None
            if valid:
                g_in = dy[m] if d == n - 1 and j == v - 1 else g_carry[d]
                saved = _saved_tick(j, m, d, n, v)
                grads, dx = stage_vjp(stage_fn, chunks[d][j], ins[d][saved],
                                      g_in)
                ins[d][saved] = None
                if acc[d][j] is None:
                    acc[d][j] = {k: g.to(_acc_dtype(g)) for k, g in
                                 grads.items()}
                else:
                    for k, g in grads.items():
                        acc[d][j][k].add_(g)
                if d == 0 and j == 0:
                    d_mb[m] = dx
            gs[d] = dx
        if t < ticks - 1:
            g_carry = transport.shift(gs, -1, like)
    d_in = torch.stack(d_mb) if 0 in transport.devices else None
    return acc, transport.broadcast(d_in, 0, dy)


class _Run:
    """What one pipelined call needs beside its tensors: the stage body,
    the transport, v, the parameter names and `wrap(name, local chunk)`,
    which puts a local chunk into the form the stage body takes."""

    def __init__(self, stage_fn: StageFn, transport, v: int,
                 names: Sequence[str], wrap):
        self.stage_fn, self.transport, self.v = stage_fn, transport, v
        self.names = tuple(names)
        self.wrap = wrap

    def chunks(self, flat: Sequence[torch.Tensor]) -> dict:
        """{device: [chunk j -> {name: the stage body's tensor}]} of the
        flat local stacks (device-major, then name)."""
        out, i = {}, 0
        for d in self.transport.devices:
            stacks = dict(zip(self.names, flat[i:i + len(self.names)]))
            i += len(self.names)
            per = next(iter(stacks.values())).shape[0] // self.v
            out[d] = [{k: self.wrap(k, w[j * per:(j + 1) * per])
                       for k, w in stacks.items()} for j in range(self.v)]
        return out

    def flat_grads(self, acc: dict, flat: Sequence[torch.Tensor]) -> list:
        """The accumulated chunk gradients as local stacks, in `flat`'s
        order and dtypes."""
        grads = []
        for d in self.transport.devices:
            for k in self.names:
                parts = [_local(acc[d][j][k]) for j in range(self.v)]
                grads.append(parts[0] if self.v == 1 else
                             torch.cat(parts))
        return [g.to(p.dtype) for g, p in zip(grads, flat)]


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


class _Pipeline(torch.autograd.Function):
    """The pipeline as one autograd node over local tensors: forward the
    fill/drain (or interleaved) schedule, backward the 1F1B recompute."""

    @staticmethod
    def forward(ctx, run: _Run, microbatches, *flat):
        out, ins = _forward(run.stage_fn, run.chunks(flat), microbatches,
                            run.transport, run.v)
        ctx.run, ctx.ins = run, ins
        ctx.save_for_backward(*flat)
        return out

    @staticmethod
    def backward(ctx, dy):
        run, flat = ctx.run, ctx.saved_tensors
        acc, d_mb = _backward(run.stage_fn, run.chunks(flat), ctx.ins,
                              dy.contiguous(), run.transport, run.v)
        ctx.ins = None
        return (None, d_mb, *run.flat_grads(acc, flat))


def _identity_wrap(_name, t):
    return t


def pipeline_apply(stage_fn: StageFn, group, stage_params: dict,
                   microbatches: torch.Tensor) -> torch.Tensor:
    """One stage per process over the pp process group `group`:
    stage_params this rank's stage weights (local tensors), microbatches
    (M, mb, ...) the same on every pp rank. Returns (M, mb, ...), the
    last stage's outputs, on every rank. Differentiable (the 1F1B
    backward)."""
    return pipeline_apply_interleaved(stage_fn, group, 1, stage_params,
                                      microbatches)


def pipeline_apply_interleaved(stage_fn: StageFn, group, v: int,
                               stage_params: dict,
                               microbatches: torch.Tensor,
                               wrap=_identity_wrap) -> torch.Tensor:
    """`pipeline_apply` with v chunks a rank: each stage_params leaf's
    leading dim holds the rank's v chunks back to back (chunk j is virtual
    stage j * n + rank)."""
    run = _Run(stage_fn, _PpRing(group), v, list(stage_params), wrap)
    return _Pipeline.apply(run, microbatches, *stage_params.values())


def make_pipelined_fn(stage_fn: StageFn, mesh, n_micro: int,
                      axis_name: str = "pp", n_virtual: int = 1,
                      wrap=_identity_wrap) -> Callable:
    """f(per_device, x) -> y: x (B, ...) split into n_micro microbatches
    through the pipeline and merged back. `mesh` is a DeviceMesh (its
    `axis_name` group; absent or None: a pp of 1) or `LocalStages`;
    `per_device` lists, for each device this process runs (one, or all n
    of `LocalStages`), {name: local stack} with the device's n_virtual
    chunks back to back. `wrap(name, local chunk)` gives the stage body's
    form of a chunk (a DTensor on the stage's mesh, say). n_virtual > 1
    needs n_micro divisible by the pp size."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if isinstance(mesh, LocalStages):
        transport = mesh
    elif axis_name in names and mesh.size(names.index(axis_name)) > 1:
        transport = _PpRing(mesh.get_group(axis_name),
                            pp_neighbours(mesh, axis_name))
    else:
        transport = _PpRing(None)
    pp = transport.n
    if n_virtual > 1 and n_micro % pp != 0:
        raise ValueError(
            f"interleaved schedule needs n_micro ({n_micro}) divisible "
            f"by the pp size ({pp})")

    def f(per_device: Sequence[dict], x: torch.Tensor) -> torch.Tensor:
        if len(per_device) != len(transport.devices):
            raise ValueError(f"{len(per_device)} stage trees for "
                             f"{len(transport.devices)} devices")
        names = list(per_device[0])
        run = _Run(stage_fn, transport, n_virtual, names, wrap)
        flat = [tree[k] for tree in per_device for k in names]
        y = _Pipeline.apply(run, split_microbatches(x, n_micro), *flat)
        return merge_microbatches(y)

    return f
