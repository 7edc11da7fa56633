"""Fused chunked softmax cross-entropy for large-vocab LM heads.

Counterpart of `tony_tpu/ops/xent.py`. `fused_cross_entropy(x, w, targets,
chunk)` is the mean next-token cross-entropy of the head x @ w without
ever holding more than one sequence chunk of logits:

- forward: a loop over chunks of `chunk` positions; each chunk's logits
  (B, C, V) are accumulated in f32, reduced to logsumexp minus the gold
  logit, and freed. Only (x, w, targets) are saved.
- backward: each chunk's logits are recomputed, turned into
  softmax - onehot in place (the gold column is decremented by index; no
  (B, C, V) onehot is made), scaled by the incoming gradient over the
  token count, and used for dx (per chunk) and dw (an f32 accumulator).

The JAX version pads S up to a multiple of the chunk and masks the padded
positions; here the last chunk is simply short, which gives the same sum.
The logits and dlogits products are plain products that the JAX package
leaves to XLA, so they stay `torch.matmul`; the logits come out in f32
(`matmul_f32`, which the model's head and generation use too), and the
backward's products take the f32 dlogits with the weights cast to f32, as
XLA promotes them.
"""

from __future__ import annotations

import torch


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result, as JAX's preferred_element_type=f32:
    the operands stay in their dtype, the products accumulate and come out
    in f32. On the card one cuBLAS call does it (torch.mm's out_dtype);
    the CPU has no such overload, so there the operands are cast to f32
    first, which gives the same exact products. f32 operands need
    neither."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    # the out_dtype overload has no autograd formula: under autograd the
    # f32 operands give the same exact products
    differentiable = torch.is_grad_enabled() and (x.requires_grad
                                                  or w.requires_grad)
    if x.device.type == "cuda" and not differentiable:
        flat = x.reshape(-1, x.shape[-1])
        out = torch.mm(flat, w, out_dtype=torch.float32)
        return out.view(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


class FusedCrossEntropy(torch.autograd.Function):
    """Sum over every token of (logsumexp - gold logit), / token count."""

    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        b, s, _ = x.shape
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, s, chunk):
            logits = matmul_f32(x[:, c0:c0 + chunk], w)
            logz = torch.logsumexp(logits, dim=-1)                # (B, C)
            gold = torch.gather(logits, -1,
                                targets[:, c0:c0 + chunk, None])[..., 0]
            total = total + torch.sum(logz - gold)
            del logits
        ctx.save_for_backward(x, w, targets)
        ctx.chunk = chunk
        return total / (b * s)

    @staticmethod
    def backward(ctx, g):
        x, w, targets = ctx.saved_tensors
        chunk = ctx.chunk
        b, s, _ = x.shape
        coef = g.float() / (b * s)
        w_f = w.float()
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = torch.empty_like(x)
        for c0 in range(0, s, chunk):
            x_c = x[:, c0:c0 + chunk]
            t_c = targets[:, c0:c0 + chunk, None]
            dlog = matmul_f32(x_c, w)
            logz = torch.logsumexp(dlog, dim=-1, keepdim=True)
            dlog.sub_(logz).exp_()                                # softmax
            dlog.scatter_add_(-1, t_c, torch.full(t_c.shape, -1.0,
                                                  device=dlog.device))
            dlog.mul_(coef)
            dx[:, c0:c0 + chunk] = (dlog @ w_f.t()).to(x.dtype)
            dw.addmm_(x_c.reshape(-1, x.shape[-1]).float().t(),
                      dlog.reshape(-1, w.shape[-1]))
            del dlog
        return dx, dw.to(w.dtype), None, None


def fused_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor,
                        chunk: int = 1024) -> torch.Tensor:
    """Mean next-token CE of an LM head, without full logits.

    x: (B, S, D) final hidden states; w: (D, V) head weights; targets:
    (B, S) int. Equal to `cross_entropy(x @ w, targets)` with f32 logits,
    up to f32 summation order, at O(B * chunk * V) logits memory."""
    chunk = max(1, min(chunk, x.shape[1]))
    return FusedCrossEntropy.apply(x, w, targets.long(), chunk)
