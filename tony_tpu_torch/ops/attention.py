"""Flash-attention forward: a hand-written CUDA kernel and its plain PyTorch
version.

Counterpart of the forward half of `tony_tpu/ops/attention.py`.
`flash_attention(q, k, v, causal, sm_scale)` takes q (B, H, S, D) and the
narrow GQA k/v (B, Hkv, S, D) with H % Hkv == 0, at any S, and computes
(out, lse) with an online softmax whose statistics stay in f32.

- On a CUDA tensor it launches `csrc/flash_fwd.cu`, which replaces the
  Pallas `_flash_fwd_kernel`. The kernel reads q, k and v through their
  strides, so the transposed views that `qkv_proj` returns need no copy;
  only the last dim must be contiguous, and the wrapper raises otherwise.
  A ragged S is masked inside the kernel; nothing is padded.
- On a CPU tensor it runs `blockwise_forward`, the same online-softmax
  math over key blocks in plain PyTorch.

The JAX package's TPU workarounds have no counterpart here: the
long-sequence segmentation, the shard_map wrapping of the Mosaic call and
the lcm padding. The backward kernels arrive with the training slice.
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


def _gqa_broadcast(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Repeat K/V heads up to Q's head count (plain paths only; the kernel
    reads the narrow K/V directly)."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


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


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, sm_scale: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. q, k, v: f32 or bf16 on one card, last dim
    contiguous, head_dim in KERNEL_HEAD_DIMS. `out` comes back as a
    (B, H, S, D) view of a (B, S, H, D) buffer, so the caller's
    transpose(1, 2).reshape(B, S, H * D) is free."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    code = dtype_code(q.dtype)
    if code is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel needs a contiguous last dim on "
                         "q, k and v")
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if s == 0:
        return out, lse
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    FLASH_FWD.launch(
        q.device, *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out,
                                                             lse)),
        b, h, hk, s, d, ctypes.cast(strides, ctypes.c_void_p),
        float(sm_scale), int(causal), code)
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    return_lse: bool = False):
    """Memory-efficient attention. q: (B, H, S, D); k/v: (B, Hkv, S, D)
    with H % Hkv == 0, any S. Returns out (B, H, S, D) in q's dtype, and
    with return_lse=True also lse (B, H, S) f32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:] or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention takes q (B,H,S,D) and k/v "
                         f"(B,Hkv,S,D) with H % Hkv == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type == "cuda":
        out, lse = flash_fwd_cuda(q, k, v, causal, sm_scale)
    elif q.device.type == "cpu":
        out, lse = blockwise_forward(q, k, v, causal, sm_scale)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {q.device}")
    return (out, lse) if return_lse else out
