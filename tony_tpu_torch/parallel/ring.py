"""Ring attention: sequence (context) parallelism over the `sp` axis.

Counterpart of `tony_tpu/parallel/ring.py`. The sequence is split over
the ranks of the sp group in ring order; each rank keeps its local Q
chunk while the K/V chunks travel around the ring (`dist.batch_isend_irecv`
to the next rank, from the previous one), and each visiting chunk goes
through the flash kernels:

- forward: per ring step, K1 on (local Q, visiting K/V chunk) gives a
  normalized partial (out_c, lse_c), merged into the running result by
  log-sum-exp weights (`merge_partials`): an exact online softmax.
- backward: the ring is a distributed loop over key blocks, so the flash
  backward of each chunk with the GLOBAL lse and delta = rowsum(dO * O)
  is exact: K2 and K3 per chunk (`_chunk_backward`). dQ accumulates
  locally in f32; each visiting chunk's f32 dK/dV partial travels WITH
  its chunk and arrives home after n rotations, every rank's
  contribution summed.

Causality is decided per chunk pair (`_chunk_mode`): a K/V chunk wholly
in this Q chunk's future is skipped (no kernel launch), the diagonal chunk
runs the causal kernel, past chunks the dense one. So causal sp = n
launches n (n + 1) / 2 chunks of each kernel over the group.

The chunks the kernels read are the local shards and the received
buffers, both contiguous (B, Hkv, S/n, D) tensors: the kernels' stride and
TMA checks hold for them as for the model's own views. On a CPU tensor
the chunk functions run the kernels' plain versions. The loop body stays
separate functions so a single process can drive the same arithmetic by
chunk index (`chip_smoke.py`'s parallel phase).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from tony_tpu_torch.ops.attention import (
    NEG_INF, attention_delta, blockwise_backward, blockwise_forward,
    flash_bwd_cuda, flash_fwd_cuda, kernel_placements, merge_partials,
)
from tony_tpu_torch.parallel.sharding import to_placements

DENSE, DIAGONAL, SKIP = 0, 1, 2


def _chunk_mode(src_idx: int, my_idx: int, causal: bool) -> int:
    """DENSE (a past chunk, or any chunk without causality), DIAGONAL
    (the chunk of this rank's own positions) or SKIP (a future chunk)."""
    if not causal:
        return DENSE
    if src_idx == my_idx:
        return DIAGONAL
    return DENSE if src_idx < my_idx else SKIP


def _chunk_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mode: int, sm_scale: float
                   ) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
    """One visiting chunk's (out_c, lse_c): K1 on a card, its plain
    version on the CPU; None for SKIP, which launches nothing."""
    if mode == SKIP:
        return None
    causal = mode == DIAGONAL
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, causal, sm_scale)
    return blockwise_forward(q, k, v, causal, sm_scale)


def _chunk_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor,
                    delta: torch.Tensor, g: torch.Tensor, mode: int,
                    sm_scale: float
                    ) -> Optional[tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]]:
    """One visiting chunk's (dq_c, dk_c, dv_c) against the GLOBAL out,
    lse and delta: K2 and K3 on a card, the plain backward on the CPU;
    None for SKIP."""
    if mode == SKIP:
        return None
    causal = mode == DIAGONAL
    if q.device.type == "cuda":
        return flash_bwd_cuda(q, k, v, g, lse, delta, causal, sm_scale)
    return blockwise_backward(q, k, v, out, lse, g, causal, sm_scale)


def _rotate(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Send each tensor to the next rank of the ring and receive the
    previous rank's, in one batch of point-to-point ops."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + 1) % n)
    src = dist.get_global_rank(group, (me - 1) % n)
    recvs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, src, group) for r in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


def _group_index(group) -> tuple[int, int]:
    if group is None:
        raise ValueError("ring attention needs the sp process group; "
                         "none was given")
    return dist.get_world_size(group), dist.get_rank(group)


def ring_forward(q, k, v, group, causal: bool, sm_scale: float):
    """(out in q's dtype, lse f32) of this rank's Q chunk against every
    rank's K/V chunk."""
    n, me = _group_index(group)
    b, h, s, d = q.shape
    out = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                     device=q.device)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for t in range(n):
        part = _chunk_forward(q, k_cur, v_cur,
                              _chunk_mode((me - t) % n, me, causal),
                              sm_scale)
        if part is not None:
            out, lse = merge_partials(out, lse, *part)
        if t < n - 1:
            k_cur, v_cur = _rotate([k_cur, v_cur], group)
    return out.to(q.dtype), lse


def ring_backward(q, k, v, out, lse, g, group, causal: bool,
                  sm_scale: float):
    """(dq, dk, dv) of `ring_forward`: dK/dV partials ride the ring with
    their chunks and are home, summed, after n rotations."""
    n, me = _group_index(group)
    g = g.contiguous()
    delta = attention_delta(g, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for t in range(n):
        part = _chunk_backward(q, k_cur, v_cur, out, lse, delta, g,
                               _chunk_mode((me - t) % n, me, causal),
                               sm_scale)
        if part is not None:
            dq.add_(part[0])
            dk.add_(part[1])
            dv.add_(part[2])
        rotating = [dk, dv] + ([k_cur, v_cur] if t < n - 1 else [])
        rotated = _rotate(rotating, group)
        dk, dv = rotated[:2]
        if t < n - 1:
            k_cur, v_cur = rotated[2:]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        out, lse = ring_forward(q, k, v, group, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, out, lse, g, ctx.group,
                                   ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, S/n, D), k/v (B, Hkv, S/n, D): this rank's chunks of a
    sequence split over the n ranks of `group` in rank order. Returns the
    local output chunk; differentiable."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, group, bool(causal),
                                float(sm_scale))


def sequence_parallel(inner, q: DTensor, k: DTensor, v: DTensor,
                      placements: tuple) -> DTensor:
    """`inner(q, k, v, group)` on each rank's local shards, q/k/v placed
    by `placements` (their sequence dim split over sp); the output takes
    the same placements."""
    mesh = q.device_mesh
    q, k, v = (to_placements(x, placements) for x in (q, k, v))
    out = inner(q.to_local(), k.to_local(), v.to_local(),
                mesh.get_group("sp"))
    return DTensor.from_local(out, mesh, placements, run_check=False)


def ring_attention_sharded(q: DTensor, k: DTensor, v: DTensor,
                           causal: bool = False,
                           sm_scale: Optional[float] = None) -> DTensor:
    """Ring attention of global DTensors on their mesh: the sequence over
    sp, batch and heads over their usual axes (`kernel_placements`)."""
    placements = kernel_placements(q.device_mesh, q.shape[0], q.shape[1],
                                   k.shape[1], seq_axis="sp")
    return sequence_parallel(
        lambda a, b, c, group: ring_attention(a, b, c, group, causal,
                                              sm_scale),
        q, k, v, placements)
