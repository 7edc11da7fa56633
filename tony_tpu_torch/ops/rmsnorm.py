"""RMSNorm forward: a hand-written CUDA kernel and its plain PyTorch version.

Counterpart of `tony_tpu/ops/rmsnorm.py`. y = x * rsqrt(mean(x^2) + eps) *
weight over the last dim, with the statistics and the weight in f32 and
the result in x's dtype. The kernel (`csrc/rmsnorm.cu`) replaces the
Pallas `_rms_kernel`: it reads x once in 16-byte vectors where a row is a
whole number of them, and element by element otherwise (the same
arithmetic); `rms_norm_reference` is the same math in plain PyTorch.
Dispatch is on the tensor's device: a CUDA tensor goes to the kernel (or
raises), a CPU tensor to the plain version. The backward is
`rms_norm_backward`, in plain PyTorch on both devices.
"""

from __future__ import annotations

import ctypes

import torch

from tony_tpu_torch.ops.cuda_lib import Kernel, dtype_code

RMSNORM_FWD = Kernel(
    "rmsnorm_fwd", "rmsnorm.cu", "tt_rmsnorm_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_int],
    replaces="tony_tpu/ops/rmsnorm.py:26")


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """The plain version: f32 statistics, f32 weight, x's dtype out."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Launch the kernel: x contiguous f32 or bf16 on the card, weight a
    contiguous f32 (d,) on the same card. Raises on anything else."""
    d = x.shape[-1]
    code = dtype_code(x.dtype)
    if code is None:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if weight.dtype != torch.float32 or weight.shape != (d,):
        raise TypeError(f"rmsnorm kernel takes a float32 ({d},) weight, "
                        f"got {weight.dtype} {tuple(weight.shape)}")
    if weight.device != x.device:
        raise ValueError(f"x on {x.device}, weight on {weight.device}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and weight")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    RMSNORM_FWD.launch(x.device, ctypes.c_void_p(x.data_ptr()),
                       ctypes.c_void_p(weight.data_ptr()),
                       ctypes.c_void_p(out.data_ptr()), rows, d,
                       float(eps), code)
    return out


def rms_norm_backward(x: torch.Tensor, weight: torch.Tensor,
                      g: torch.Tensor, eps: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """`_rms_bwd` in plain PyTorch: f32 throughout; dw summed over every
    leading dim; dx in x's dtype, dw in the weight's."""
    xf = x.float()
    gf = g.float()
    wf = weight.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xf * rstd
    dw = torch.sum((gf * xhat).reshape(-1, x.shape[-1]), dim=0)
    gw = gf * wf
    # d/dx of x * rsqrt(mean(x^2)+eps): gw*rstd - xhat * mean(gw*xhat) * rstd
    dx = rstd * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
    return dx.to(x.dtype), dw.to(weight.dtype)


def _rms_norm_forward(x: torch.Tensor, weight: torch.Tensor,
                      eps: float) -> torch.Tensor:
    if x.device.type == "cuda":
        return rms_norm_cuda(x, weight, eps)
    if x.device.type == "cpu":
        return rms_norm_reference(x, weight, eps)
    raise ValueError(f"rms_norm runs on cuda or cpu, not {x.device}")


class RMSNormFunction(torch.autograd.Function):
    """The forward on the kernel (CUDA) or the plain version (CPU); the
    backward `rms_norm_backward`."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_backward(x, weight, g, ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * weight, over the last dim."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNormFunction.apply(x, weight, eps)
    return _rms_norm_forward(x, weight, eps)
