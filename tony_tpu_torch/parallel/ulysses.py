"""Ulysses (DeepSpeed-style) sequence parallelism: an all-to-all swap of
the sequence and head splits.

Counterpart of `tony_tpu/parallel/ulysses.py`, the second flavour next to
ring attention (`parallel/ring.py`). Activations arrive split over the
sequence (each rank holds S/n of every head); one `all_to_all_single` per
tensor on the sp group re-splits them over heads (each rank holds H/n
heads of the whole sequence), `flash_attention` (K1, and K2/K3 in its
backward) runs on the local heads, and a second all-to-all restores the
sequence split. Each all-to-all is an autograd.Function whose backward is
the inverse all-to-all.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from tony_tpu_torch.ops.attention import (
    _gqa_broadcast, flash_attention, kernel_placements,
)
from tony_tpu_torch.parallel.mesh import axis_size
from tony_tpu_torch.parallel.ring import sequence_parallel


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Piece j of dim 0 goes to rank j; piece j of the result came from
    rank j."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """(B, H, S/n, D) -> (B, H/n, S, D): this rank's heads of the whole
    sequence."""
    n = dist.get_world_size(group)
    b, h, s, d = x.shape
    pieces = x.reshape(b, n, h // n, s, d).transpose(0, 1).contiguous()
    got = _all_to_all(pieces, group)             # (n src chunks, B, H/n..)
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """(B, H/n, S, D) -> (B, H, S/n, D): the inverse of `seq_to_heads`."""
    n = dist.get_world_size(group)
    b, hl, s, d = x.shape
    pieces = x.reshape(b, hl, n, s // n, d).permute(2, 0, 1, 3, 4)
    got = _all_to_all(pieces.contiguous(), group)  # (n head groups, ...)
    return got.transpose(0, 1).reshape(b, n * hl, s // n, d)


class _SeqToHeads(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return heads_to_seq(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return seq_to_heads(g, ctx.group), None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, causal: bool = False,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: this rank's (B, H, S/n, D) chunks of a sequence split over
    the n ranks of `group` (H divisible by n; K/V as many heads as Q).
    Returns the local (B, H, S/n, D) output chunk; differentiable."""
    if group is None:
        raise ValueError("Ulysses attention needs the sp process group; "
                         "none was given")
    n = dist.get_world_size(group)
    h = q.shape[1]
    if h % n != 0:
        raise ValueError(f"n_heads {h} not divisible by sp={n} "
                         f"(Ulysses shards heads; use ring attention)")
    q_h, k_h, v_h = (_SeqToHeads.apply(x, group) for x in (q, k, v))
    out_h = flash_attention(q_h, k_h, v_h, causal=causal, sm_scale=sm_scale)
    return _HeadsToSeq.apply(out_h, group)


def ulysses_attention_sharded(q: DTensor, k: DTensor, v: DTensor,
                              causal: bool = False,
                              sm_scale: Optional[float] = None) -> DTensor:
    """Ulysses attention of global DTensors on their mesh. K/V are
    broadcast to Q's heads on each rank first (every rank's head slice
    needs its own K/V). With heads also over tp, Ulysses splits the LOCAL
    head count over sp; where (H / tp) % sp fails the heads stay whole
    on every tp rank instead of raising on a config the plain path
    accepts."""
    mesh = q.device_mesh
    placements = kernel_placements(mesh, q.shape[0], q.shape[1],
                                   k.shape[1], seq_axis="sp")
    tp, sp = axis_size(mesh, "tp"), axis_size(mesh, "sp")
    if tp > 1 and (q.shape[1] // tp) % sp != 0:
        tp_dim = mesh.mesh_dim_names.index("tp")
        placements = tuple(Replicate() if i == tp_dim else p
                           for i, p in enumerate(placements))
    return sequence_parallel(
        lambda a, b, c, group: ulysses_attention(
            a, *_gqa_broadcast(a, b, c), group, causal, sm_scale),
        q, k, v, placements)
