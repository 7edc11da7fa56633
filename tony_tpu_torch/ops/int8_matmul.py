"""The int8-weight product: K5, a hand-written W8A16 kernel, and its plain
PyTorch version.

y = x @ w for an int8 weight {"int8": q, "scale": scale}, the sum in f32;
the layer products come out in x's dtype, the LM head in f32 (JAX's
`preferred_element_type=f32`). The weight element is q * bf16(scale),
exact in f32 (an int8 times an 8-bit significand): the element the JAX
package's compiled decode and prefill multiply by. Its `dequantize` is
bf16(int8) * bf16(scale) in bf16, but inside a compiled computation XLA
keeps the product unrounded (excess precision, which it allows by
default), and its jitted steps agree with this definition to f32 rounding
(tests/test_torch_quant.py).

Routing, by the number of rows of x (M), not a fallback:
- M <= KERNEL_MAX_ROWS (the decode step's slot count, and short prompts):
  K5 (`csrc/int8_matmul.cu`), which reads each int8 weight byte once and
  never writes a dequantized weight. These products are bound by the
  weight bytes.
- more rows (a prefill, one layer at a time): the weight is dequantized to
  x's dtype (bf16 for the served models, the element rounded once) and the
  product is one `torch.matmul`, as the JAX package left it to XLA. These
  products are bound by the arithmetic, where the transient weight costs
  little.

A tensor on the CPU takes the plain version (`int8_matmul_reference`, the
same element and an f32 product). On the card a build or launch failure
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tony_tpu_torch.models.quant import dequantize
from tony_tpu_torch.ops.cuda_lib import Kernel, dtype_code
from tony_tpu_torch.ops.xent import matmul_f32

# int8 products with at most this many rows of x go to K5
KERNEL_MAX_ROWS = 16
# K5's column tile (csrc/int8_matmul.cu kTileN), the blocks per SM its
# split of K aims for, and the floats of x a block may stage in shared
# memory (kMaxSmem)
TILE_N = 512
K_LANES = 8
BLOCKS_PER_SM = 2
MAX_STAGED = 200 * 1024 // 4
# a block's fixed cost (staging x, the cross-warp sum, its partial sums),
# in rows of its weight loop
BLOCK_ROWS = 512

INT8_MATMUL = Kernel(
    "int8_matmul", "int8_matmul.cu", "tt_int8_matmul",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int],
    replaces="tony_tpu/models/quant.py:66 (XLA's fused dequantize -> dot, "
             "tony_tpu/models/generate.py:161-163)")


def _qt(t: dict) -> tuple[torch.Tensor, torch.Tensor]:
    q, scale = t["int8"], t["scale"]
    if q.dim() != 2 or scale.shape != (1, q.shape[1]):
        raise ValueError(f"int8 product takes a (K, N) int8 weight and a "
                         f"(1, N) scale, got {tuple(q.shape)} and "
                         f"{tuple(scale.shape)}")
    return q, scale


def weight_f32(t: dict) -> torch.Tensor:
    """The weight's elements q * bf16(scale), exact in f32."""
    return t["int8"].float() * t["scale"].to(torch.bfloat16).float()


def int8_matmul_reference(x: torch.Tensor, t: dict,
                          out_f32: bool = False) -> torch.Tensor:
    """The plain version: the f32 weight and an f32 product, in x's dtype
    (the LM head in f32)."""
    y = x.float() @ weight_f32(t)
    return y if out_f32 else y.to(x.dtype)


def _dequantized_matmul(x: torch.Tensor, t: dict,
                        out_f32: bool) -> torch.Tensor:
    """A prefill's product on the card: the weight dequantized to x's
    dtype, then one library product."""
    if x.dtype == torch.float32:
        return x @ weight_f32(t)
    w = dequantize(t, x.dtype)
    return matmul_f32(x, w) if out_f32 else x @ w


def rows_per_block(m: int) -> int:
    """The rows of x one K5 block takes (MT): 1, 2, 4 or 8."""
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8


@functools.lru_cache(maxsize=1024)
def splits_for(m: int, k: int, n: int, n_sm: int) -> int:
    """K5's split of K, from a model of its time per column of weight.
    The blocks (column tiles x row blocks x splits) run in waves of
    BLOCKS_PER_SM per SM; a last wave that is not full leaves SMs idle,
    so the weight's K rows, and BLOCK_ROWS for each block, take waves *
    wave / blocks times longer. Split K ways, the f32 partial sums add
    8 * splits * M bytes (written, then read back). The split of least
    time is taken (the fewest on a tie), each k lane of a block keeping at
    least 4 rows, and never fewer splits than keep a block's staged x
    within MAX_STAGED."""
    mt = rows_per_block(m)
    tiles = -(-n // TILE_N) * -(-m // mt)
    wave = BLOCKS_PER_SM * n_sm
    least = max(1, -(-k * mt // MAX_STAGED))
    most = max(least, k // (K_LANES * 4))

    def cost(s: int) -> float:
        blocks = tiles * s
        idle = -(-blocks // wave) * wave / blocks
        return idle * (k + s * BLOCK_ROWS) + (8 * s * m if s > 1 else 0)
    return min(range(least, most + 1), key=lambda s: (cost(s), s))


def int8_matmul_cuda(x: torch.Tensor, t: dict,
                     out_f32: bool = False) -> torch.Tensor:
    """Launch K5: x (.., K) f32 or bf16 on the card, t's int8 (K, N) and
    f32 (1, N) scale on the same card. Raises on anything else."""
    q, scale = _qt(t)
    k, n = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has {x.shape[-1]} columns, the weight {k} rows")
    x_code = dtype_code(x.dtype)
    if x_code is None:
        raise TypeError(f"int8 product takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8 product takes an int8 weight and a float32 "
                        f"scale, got {q.dtype} and {scale.dtype}")
    if not (q.device == scale.device == x.device):
        raise ValueError(f"x on {x.device}, weight on {q.device}, scale on "
                         f"{scale.device}")
    if n % 16 or not (q.is_contiguous() and scale.is_contiguous()) \
            or q.data_ptr() % 16:
        raise ValueError("int8 product takes a contiguous, 16-byte aligned "
                         "weight with N a multiple of 16")
    out_dtype = torch.float32 if out_f32 else x.dtype
    flat = x.reshape(-1, k).contiguous()
    m = flat.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.view(*x.shape[:-1], n)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = splits_for(m, k, n, n_sm)
    part = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    INT8_MATMUL.launch(
        x.device, ctypes.c_void_p(flat.data_ptr()),
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(part.data_ptr() if part is not None else 0),
        m, k, n, splits, x_code, dtype_code(out_dtype))
    return out.view(*x.shape[:-1], n)


def int8_matmul(x: torch.Tensor, t: dict,
                out_f32: bool = False) -> torch.Tensor:
    """x @ dequantize(t), routed by the rows of x (module docstring)."""
    if x.device.type == "cuda":
        if x.numel() // x.shape[-1] <= KERNEL_MAX_ROWS:
            return int8_matmul_cuda(x, t, out_f32)
        return _dequantized_matmul(x, t, out_f32)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, t, out_f32)
    raise ValueError(f"int8 product runs on cuda or cpu, not {x.device}")
