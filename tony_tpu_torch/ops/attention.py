"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain PyTorch versions.

Counterpart of `tony_tpu/ops/attention.py`.
`flash_attention(q, k, v, causal, sm_scale)` takes q (B, H, S, D) and the
narrow GQA k/v (B, Hkv, S, D) with H % Hkv == 0, at any S, and computes
out with an online softmax whose statistics stay in f32. It is
differentiable.

- The forward is one operator, `torch.ops.tony_tpu_torch.flash_fwd`
  (a `torch.library.custom_op`), returning out and the f32 log-sum-exp.
  Being one named operator is what lets the `save_flash` remat policy
  (models/llama.py) keep exactly its two outputs, as the JAX package names
  them `flash_out` and `flash_lse`. It saves (q, k, v, out, lse) for the
  backward, as `_fwd_rule` does.
- On a CUDA tensor the forward launches `csrc/flash_fwd.cu` (replaces the
  Pallas `_flash_fwd_kernel`), and the backward computes
  delta = rowsum(dO * O) in f32 with a plain torch reduction (outside the
  kernels, as on the TPU) and launches the two kernels of
  `csrc/flash_bwd.cu`: dQ (replaces `_flash_bwd_dq_kernel`) and the
  group-summed narrow dK/dV (replaces `_flash_bwd_dkv_kernel` and
  `_gqa_reduce`): in bf16 on the tensor cores (wgmma, TMA), in f32 on the
  CUDA cores. The kernels read q, k, v and dO through their strides;
  only the last dim must be contiguous (and, for the bf16 backward's TMA,
  bases and strides 16-byte aligned), and the wrappers raise otherwise.
  A ragged S is masked inside the kernels; nothing is padded.
- On a CPU tensor it runs `blockwise_forward` and `blockwise_backward`,
  the same math over key blocks in plain PyTorch.

The JAX package's TPU workarounds have no counterpart here: the
long-sequence segmentation, the shard_map wrapping of the Mosaic call and
the lcm padding.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tony_tpu_torch.ops.cuda_lib import Kernel, dtype_code

NEG_INF = -1e30
DEFAULT_BLOCK_K = 512
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

FLASH_FWD = Kernel(
    "flash_fwd", "flash_fwd.cu", "tt_flash_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int],
    replaces="tony_tpu/ops/attention.py:71")
FLASH_BWD_DQ = Kernel(
    "flash_bwd_dq", "flash_bwd.cu", "tt_flash_bwd_dq",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int],
    replaces="tony_tpu/ops/attention.py:378")
FLASH_BWD_DKV = Kernel(
    "flash_bwd_dkv", "flash_bwd.cu", "tt_flash_bwd_dkv",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int],
    replaces="tony_tpu/ops/attention.py:419")


def _gqa_broadcast(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Repeat K/V heads up to Q's head count (plain paths only; the kernels
    read the narrow K/V directly)."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def _gqa_reduce(dk: torch.Tensor, dv: torch.Tensor, hk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum per-q-head K/V grads over each GQA group -> (B, Hkv, S, D)."""
    b, h, s, d = dk.shape
    if h == hk:
        return dk, dv
    rep = h // hk
    return (dk.reshape(b, hk, rep, s, d).sum(dim=2),
            dv.reshape(b, hk, rep, s, d).sum(dim=2))


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """O(S^2) oracle. q: (B, H, S, D); k/v: (B, Hkv, S, D)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    k, v = _gqa_broadcast(q, k, v)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        qlen, klen = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(qlen, klen, dtype=torch.bool,
                          device=q.device).tril(klen - qlen)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def blockwise_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, sm_scale: float,
                      block_k: int = DEFAULT_BLOCK_K
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the kernel's online-softmax math over key blocks
    of `block_k` (the last block may be short), O(S * block_k) memory.
    Returns out (B, H, S, D) in q's dtype and lse (B, H, S) f32."""
    k, v = _gqa_broadcast(q, k, v)
    b, h, s, d = q.shape
    qf = q.float() * sm_scale
    m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    rows = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, block_k):
        k_blk = k[:, :, k0:k0 + block_k].float()
        v_blk = v[:, :, k0:k0 + block_k].float()
        s_blk = qf @ k_blk.transpose(-1, -2)                # (B,H,S,Bk)
        if causal:
            cols = k0 + torch.arange(k_blk.shape[2], device=q.device)
            s_blk = torch.where(rows >= cols[None, :], s_blk, NEG_INF)
        m_new = torch.maximum(m, s_blk.amax(dim=-1, keepdim=True))
        p = torch.exp(s_blk - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ v_blk
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def attention_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, H, S): the backward's per-row
    correction, a plain reduction outside the kernels as on the TPU."""
    return torch.sum(g.float() * out.float(), dim=-1)


def blockwise_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                       causal: bool, sm_scale: float,
                       block_k: int = DEFAULT_BLOCK_K
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward (`_blockwise_backward`): recompute
    P per key block of `block_k` (the last may be short) from the saved
    lse, dS = P * (dP - delta) * scale, with GQA by broadcast and then
    `_gqa_reduce`. Returns dq in q's dtype and the narrow dk, dv in k's
    and v's."""
    hk = k.shape[1]
    k, v = _gqa_broadcast(q, k, v)
    s = q.shape[2]
    qf = q.float()
    gf = g.float()
    delta = attention_delta(g, out)[..., None]               # (B,H,S,1)
    lse = lse[..., None]
    rows = torch.arange(s, device=q.device)[:, None]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_blocks, dv_blocks = [], []
    for k0 in range(0, s, block_k):
        k_f = k[:, :, k0:k0 + block_k].float()
        v_f = v[:, :, k0:k0 + block_k].float()
        s_blk = (qf @ k_f.transpose(-1, -2)) * sm_scale      # (B,H,S,Bk)
        if causal:
            cols = k0 + torch.arange(k_f.shape[2], device=q.device)
            s_blk = torch.where(rows >= cols[None, :], s_blk, NEG_INF)
        p = torch.exp(s_blk - lse)
        dv_blocks.append(p.transpose(-1, -2) @ gf)
        dp = gf @ v_f.transpose(-1, -2)
        ds = p * (dp - delta) * sm_scale
        dq = dq + ds @ k_f
        dk_blocks.append(ds.transpose(-1, -2) @ qf)
    dk, dv = _gqa_reduce(torch.cat(dk_blocks, dim=2),
                         torch.cat(dv_blocks, dim=2), hk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _check_kernel_inputs(what: str, ref: torch.Tensor,
                         tensors: tuple[torch.Tensor, ...]) -> int:
    """Shared checks of the flash kernels' operands; returns the dtype
    code."""
    code = dtype_code(ref.dtype)
    if code is None or any(t.dtype != ref.dtype for t in tensors):
        raise TypeError(f"{what} takes float32 or bfloat16 operands of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    if ref.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what} takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"got {ref.shape[-1]}")
    if any(t.device != ref.device for t in tensors):
        raise ValueError(f"{what}: operands on "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{what} needs a contiguous last dim on every "
                         f"operand")
    return code


def _strides(*tensors: torch.Tensor):
    """The batch, head and sequence strides of each tensor, as the C array
    the kernels take."""
    values = [st for t in tensors for st in t.stride()[:3]]
    return ctypes.cast((ctypes.c_longlong * len(values))(*values),
                       ctypes.c_void_p)


def _ptrs(*tensors: torch.Tensor):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _flash_fwd_cuda_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, sm_scale: float
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel; out comes back as its (B, S, H, D)
    buffer, lse as (B, H, S) f32."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    code = _check_kernel_inputs("flash kernel", q, (q, k, v))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if s == 0:
        return out, lse
    FLASH_FWD.launch(q.device, *_ptrs(q, k, v, out, lse), b, h, hk, s, d,
                     _strides(q, k, v, out.transpose(1, 2)),
                     float(sm_scale), int(causal), code)
    return out, lse


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, sm_scale: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel. q, k, v: f32 or bf16 on one card, last
    dim contiguous, head_dim in KERNEL_HEAD_DIMS. `out` comes back as a
    (B, H, S, D) view of a (B, S, H, D) buffer, so the caller's
    transpose(1, 2).reshape(B, S, H * D) is free."""
    out, lse = _flash_fwd_cuda_bshd(q, k, v, causal, sm_scale)
    return out.transpose(1, 2), lse


def _check_bwd_inputs(q, k, v, g, lse, delta) -> int:
    b, h, s, _ = q.shape
    code = _check_kernel_inputs("flash backward kernels", q, (q, k, v, g))
    if g.shape != q.shape:
        raise ValueError(f"dO {tuple(g.shape)} != q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, h, s) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"({b}, {h}, {s}) tensor on {q.device}")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernels load q, k, v and dO by TMA
        for name, t in zip("qkvg", (q, k, v, g)):
            if t.data_ptr() % 16 or any(
                    (st * t.element_size()) % 16
                    for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
                raise ValueError(
                    f"flash backward kernels: bf16 {name} needs a 16-byte "
                    f"aligned base and batch, head and sequence strides of "
                    f"a multiple of 16 bytes, got strides {t.stride()}")
    return code


def flash_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                      causal: bool, sm_scale: float) -> torch.Tensor:
    """Launch the dQ kernel (operands as `flash_bwd_cuda`). dq comes back
    as a (B, H, S, D) view of a (B, S, H, D) buffer."""
    b, h, s, d = q.shape
    code = _check_bwd_inputs(q, k, v, g, lse, delta)
    dq = torch.empty((b, s, h, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    if s:
        FLASH_BWD_DQ.launch(q.device, *_ptrs(q, k, v, g, lse, delta, dq),
                            b, h, k.shape[1], s, d, _strides(q, k, v, g, dq),
                            float(sm_scale), int(causal), code)
    return dq


def flash_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, causal: bool, sm_scale: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel (operands as `flash_bwd_cuda`). dk and dv
    come back narrow, as (B, Hkv, S, D) views of (B, S, Hkv, D) buffers."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    code = _check_bwd_inputs(q, k, v, g, lse, delta)
    dk = torch.empty((b, s, hk, d), dtype=k.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty((b, s, hk, d), dtype=v.dtype,
                     device=q.device).transpose(1, 2)
    if s:
        FLASH_BWD_DKV.launch(q.device,
                             *_ptrs(q, k, v, g, lse, delta, dk, dv), b, h,
                             hk, s, d, _strides(q, k, v, g, dk, dv),
                             float(sm_scale), int(causal), code)
    return dk, dv


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   causal: bool, sm_scale: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dQ kernel and the dK/dV kernel. q and g (dO): (B, H, S,
    D); k, v: (B, Hkv, S, D); one dtype (f32 or bf16), last dim
    contiguous; lse and delta contiguous (B, H, S) f32. The results are in
    the layout of `qkv_proj`'s products ((B, S, heads, D) memory), so the
    backward of its transposes copies nothing."""
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, sm_scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the differentiable operator
# ---------------------------------------------------------------------------

@torch.library.custom_op("tony_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, sm_scale: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The flash forward as one operator: out as its (B, S, H, D) buffer
    (a custom op returns no views) and lse (B, H, S) f32."""
    if q.device.type == "cuda":
        return _flash_fwd_cuda_bshd(q, k, v, causal, sm_scale)
    out, lse = blockwise_forward(q, k, v, causal, sm_scale)
    return out.transpose(1, 2).contiguous(), lse


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, sm_scale):
    b, h, s, d = q.shape
    return (q.new_empty((b, s, h, d)),
            q.new_empty((b, h, s), dtype=torch.float32))


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                   causal: bool, sm_scale: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's (out, lse) and dO: the two kernels
    on a CUDA tensor, `blockwise_backward` on a CPU tensor."""
    if q.device.type == "cuda":
        if g.stride(-1) != 1:       # e.g. the expanded grad of a sum
            g = g.contiguous()
        return flash_bwd_cuda(q, k, v, g, lse, attention_delta(g, out),
                              causal, sm_scale)
    return blockwise_backward(q, k, v, out, lse, g, causal, sm_scale)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, causal, sm_scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal = causal
    ctx.sm_scale = sm_scale


def _flash_backward_rule(ctx, g_out, g_lse):
    # lse is a statistic: its gradient (if any) is not propagated, as the
    # JAX core op returns out alone
    q, k, v, out, lse = ctx.saved_tensors
    if g_out is None:
        return None, None, None, None, None
    dq, dk, dv = flash_backward(q, k, v, out.transpose(1, 2), lse,
                                g_out.transpose(1, 2), ctx.causal,
                                ctx.sm_scale)
    return dq, dk, dv, None, None


flash_fwd_op.register_autograd(_flash_backward_rule,
                               setup_context=_flash_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    return_lse: bool = False):
    """Memory-efficient attention. q: (B, H, S, D); k/v: (B, Hkv, S, D)
    with H % Hkv == 0, any S. Returns out (B, H, S, D) in q's dtype (a view
    of (B, S, H, D) memory), and with return_lse=True also lse (B, H, S)
    f32. Differentiable in q, k and v."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:] or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention takes q (B,H,S,D) and k/v "
                         f"(B,Hkv,S,D) with H % Hkv == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {q.device}")
    out, lse = flash_fwd_op(q, k, v, bool(causal), float(sm_scale))
    out = out.transpose(1, 2)
    return (out, lse) if return_lse else out
