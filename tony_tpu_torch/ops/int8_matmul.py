"""The int8-weight product: K5, a hand-written W8A16 kernel, and its plain
PyTorch version; for one weight (`int8_matmul`) and for a bank of expert
weights (`int8_bmm`).

y = x @ w for an int8 weight {"int8": q, "scale": scale}, the sum in f32;
the layer products come out in x's dtype, the LM head in f32 (JAX's
`preferred_element_type=f32`). The weight element is q * bf16(scale),
exact in f32 (an int8 times an 8-bit significand): the element the JAX
package's compiled decode and prefill multiply by. Its `dequantize` is
bf16(int8) * bf16(scale) in bf16, but inside a compiled computation XLA
keeps the product unrounded (excess precision, which it allows by
default), and its jitted steps agree with this definition to f32 rounding
(tests/test_torch_quant.py). A bank {"int8": (E, K, N), "scale": (E, 1,
N)} times x (E, C, K) is the counterpart of `torch.bmm` and of the JAX
package's bank einsum "ecd,edf->ecf" (`tony_tpu/models/moe.py:179-182`).

Routing, by the number of rows of x (M; a bank: C, the rows of each
expert), not a fallback:
- M <= KERNEL_MAX_ROWS (the decode step's slot count, and short prompts):
  K5 (`csrc/int8_matmul.cu`), one launch for the product or the whole
  bank, which reads each int8 weight byte once and never writes a
  dequantized weight. These products are bound by the weight bytes.
- more rows (a prefill, one layer at a time): the weight is dequantized to
  x's dtype (bf16 for the served models, the element rounded once) and the
  product is one `torch.matmul` (a bank: one `torch.bmm`), as the JAX
  package left it to XLA. These products are bound by the arithmetic,
  where the transient weight costs little.

A tensor on the CPU takes the plain version (`int8_matmul_reference`,
`int8_bmm_reference`: the same element and an f32 product). On the card a
build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tony_tpu_torch.ops.cuda_lib import Kernel, dtype_code
from tony_tpu_torch.ops.xent import matmul_f32

# int8 products with at most this many rows of x go to K5
KERNEL_MAX_ROWS = 16
# K5's column tile (csrc/int8_matmul.cu kTileN), the blocks an SM holds at
# once, and the floats of x a block may stage in shared memory (kMaxSmem)
TILE_N = 512
BLOCKS_PER_SM = 2
MAX_STAGED = 200 * 1024 // 4
# K5's time model, in microseconds, fitted on an H100 to a sweep of every
# split of K at llama3_8b's and mixtral_proxy's decode products
# (`python3 tools/k5_compare.py --tree . --sweep`): a block's K rows of one
# column tile, alone on its SM (ROW_US a row) or sharing it with a second
# block (SHARED_SM times slower); a block's fixed cost (staging x, the
# cross-warp sums, the epilogue); one round of adding the split sums (the
# last block's arrival, then its reads: PARTIAL_US for each partial sum
# of each row of x)
ROW_US = 0.02
SHARED_SM = 1.8
BLOCK_US = 4.0
ROUND_US = 1.0
PARTIAL_US = 0.045

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
INT8_MATMUL = Kernel(
    "int8_matmul", "int8_matmul.cu", "tt_int8_matmul",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L,
     _I, _I],
    replaces="tony_tpu/models/quant.py:66 (XLA's fused dequantize -> dot, "
             "tony_tpu/models/generate.py:161-163; a bank: the einsum of "
             "tony_tpu/models/moe.py:179-182 on dequantize_layer)")

# K5's arrival counters, one int32 buffer per (device index, stream),
# zeros between launches (each launch sets back what it counted); grown
# to the largest grid it has served
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _qt(t: dict, bank: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """t's int8 weight and scale, if their shapes are (K, N) and (1, N),
    or with `bank` (E, K, N) and (E, 1, N)."""
    q, scale = t["int8"], t["scale"]
    lead = q.shape[:1] if bank else ()
    if q.dim() != 2 + len(lead) or scale.shape != (*lead, 1, q.shape[-1]):
        want = ("an (E, K, N) int8 weight and an (E, 1, N) scale" if bank
                else "a (K, N) int8 weight and a (1, N) scale")
        raise ValueError(f"int8 product takes {want}, got {tuple(q.shape)} "
                         f"and {tuple(scale.shape)}")
    return q, scale


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    """x's, q's and scale's dtypes and devices as K5 takes them."""
    if dtype_code(x.dtype) is None:
        raise TypeError(f"int8 product takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8 product takes an int8 weight and a float32 "
                        f"scale, got {q.dtype} and {scale.dtype}")
    if not (q.device == scale.device == x.device):
        raise ValueError(f"x on {x.device}, weight on {q.device}, scale on "
                         f"{scale.device}")


def weight_f32(t: dict) -> torch.Tensor:
    """The weight's elements q * bf16(scale), exact in f32."""
    return t["int8"].float() * t["scale"].to(torch.bfloat16).float()


def int8_matmul_reference(x: torch.Tensor, t: dict,
                          out_f32: bool = False) -> torch.Tensor:
    """The plain version: the f32 weight and an f32 product, in x's dtype
    (the LM head in f32)."""
    y = x.float() @ weight_f32(t)
    return y if out_f32 else y.to(x.dtype)


def int8_bmm_reference(x: torch.Tensor, t: dict) -> torch.Tensor:
    """The plain version of a bank: each expert's plain product, stacked
    (an f32 `bmm` on the CPU adds in another order than E products)."""
    return torch.stack([
        int8_matmul_reference(x[e], {"int8": t["int8"][e],
                                     "scale": t["scale"][e]})
        for e in range(x.shape[0])])


def _dequantized_matmul(x: torch.Tensor, t: dict,
                        out_f32: bool) -> torch.Tensor:
    """A prefill's product on the card: the weight dequantized to x's
    dtype, then one library product."""
    # imported here: the models package imports this module (its __init__
    # loads the Llama tower), so a top-level import would be a cycle
    from tony_tpu_torch.models.quant import dequantize

    if x.dtype == torch.float32:
        return x @ weight_f32(t)
    w = dequantize(t, x.dtype)
    return matmul_f32(x, w) if out_f32 else x @ w


def _dequantized_bmm(x: torch.Tensor, t: dict) -> torch.Tensor:
    """A prefill's bank product on the card: the bank dequantized to x's
    dtype, then one library product."""
    from tony_tpu_torch.models.quant import dequantize

    if x.dtype == torch.float32:
        return torch.bmm(x, weight_f32(t))
    return torch.bmm(x, dequantize(t, x.dtype))


def rows_per_block(m: int) -> int:
    """The rows of x one K5 block takes (MT): 1, 2, 4 or 8."""
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8


def _fold_us(splits: int, group: int, mt: int) -> float:
    """The model's time to add `splits` partial sums of mt rows: one
    round of them all, or two rounds (the groups', then their sums)."""
    if splits == 1:
        return 0.0
    if group >= splits:
        return ROUND_US + PARTIAL_US * splits * mt
    return 2 * ROUND_US + PARTIAL_US * (group + -(-splits // group)) * mt


@functools.lru_cache(maxsize=1024)
def fold_group(splits: int, m: int) -> int:
    """The splits whose partial sums one block of K5 adds (the last of
    them to arrive): all of them, in one round, or about their square
    root, in two rounds (each group's last block adds the group's, the
    last group's the groups' sums), whichever the model finds faster for
    m rows of x."""
    two = math.isqrt(splits - 1) + 1 if splits > 1 else 1
    mt = rows_per_block(m)
    return (splits if _fold_us(splits, splits, mt) <= _fold_us(splits, two,
                                                                 mt)
            else two)


@functools.lru_cache(maxsize=1024)
def splits_for(m: int, k: int, n: int, n_sm: int, batch: int = 1) -> int:
    """K5's split of K, the one of least time under the model above. The
    blocks (column tiles x row blocks x batch x splits) run in waves of
    BLOCKS_PER_SM * n_sm; each block of a wave takes its K / splits rows
    (slower where two share an SM) and its fixed cost, and the split sums
    are then added (`fold_group`). Each k lane of a block keeps at least
    4 rows, and never fewer splits than keep a block's staged x within
    MAX_STAGED; the fewest splits on a tie."""
    mt = rows_per_block(m)
    tiles = -(-n // TILE_N) * -(-m // mt) * batch
    slots = BLOCKS_PER_SM * n_sm
    least = max(1, -(-k * mt // MAX_STAGED))
    most = max(least, k // 32)

    def cost(s: int) -> float:
        waves = -(-tiles * s // slots)
        last = tiles * s - (waves - 1) * slots
        row = ROW_US * k / s
        shared = row * SHARED_SM + BLOCK_US
        return ((waves - 1) * shared
                + (shared if last > n_sm else row + BLOCK_US)
                + _fold_us(s, fold_group(s, m), mt))
    return min(range(least, most + 1), key=lambda s: (cost(s), s))


def counters_for(m: int, n: int, splits: int, batch: int = 1) -> int:
    """The arrival counters K5's grid needs: none for one split, else one
    per group of splits and one for the groups, for each (batch, row
    block, column tile)."""
    if splits <= 1:
        return 0
    groups = -(-splits // fold_group(splits, m))
    return (-(-n // TILE_N) * -(-m // rows_per_block(m)) * batch
            * (groups + 1))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _counters(device: torch.device, need: int) -> torch.Tensor:
    """At least `need` int32 zeros on `device` for its current stream."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _k5(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
        out_f32: bool) -> torch.Tensor:
    """One K5 launch: x (B, M, K) contiguous, q (B, K, N) or (K, N) and
    scale (B, 1, N) or (1, N), all on one card -> (B, M, N)."""
    if x.device.type != "cuda":
        raise ValueError(f"K5 runs on a CUDA tensor, not on {x.device}")
    batch, m, k = x.shape
    n = q.shape[-1]
    if n % 16 or not (q.is_contiguous() and scale.is_contiguous()) \
            or q.data_ptr() % 16:
        raise ValueError("int8 product takes a contiguous, 16-byte aligned "
                         "weight with N a multiple of 16")
    out_dtype = torch.float32 if out_f32 else x.dtype
    out = torch.empty((batch, m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    device = x.device
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    splits = splits_for(m, k, n, _sm_count(device.index), batch)
    need = counters_for(m, n, splits, batch)
    part = (torch.empty((splits, batch, m, n), dtype=torch.float32,
                        device=device) if splits > 1 else None)
    counters = _counters(device, need) if need else None
    per_q = k * n if q.dim() == 3 else 0
    INT8_MATMUL.launch(
        device, _P(x.data_ptr()), _P(q.data_ptr()), _P(scale.data_ptr()),
        _P(out.data_ptr()), _P(part.data_ptr() if part is not None else 0),
        _P(counters.data_ptr() if counters is not None else 0),
        counters.numel() if counters is not None else 0,
        batch, m, k, n, splits, fold_group(splits, m), m * k, per_q,
        n if per_q else 0, m * n, dtype_code(x.dtype),
        dtype_code(out_dtype))
    return out


def int8_matmul_cuda(x: torch.Tensor, t: dict,
                     out_f32: bool = False) -> torch.Tensor:
    """Launch K5: x (.., K) f32 or bf16 on the card, t's int8 (K, N) and
    f32 (1, N) scale on the same card. Raises on anything else."""
    q, scale = _qt(t)
    k, n = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has {x.shape[-1]} columns, the weight {k} rows")
    _check(x, q, scale)
    out = _k5(x.reshape(1, -1, k).contiguous(), q, scale, out_f32)
    return out.view(*x.shape[:-1], n)


def _bank(x: torch.Tensor, t: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """t's int8 bank and scale, if x (E, C, K) and t's (E, K, N) int8 and
    (E, 1, N) scale fit each other and K5's dtypes and devices."""
    q, scale = _qt(t, bank=True)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"int8 product runs on cuda or cpu, not {x.device}")
    _check(x, q, scale)
    if x.dim() != 3 or x.shape[0] != q.shape[0] or x.shape[2] != q.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not fit an int8 bank of "
                         f"{tuple(q.shape)}")
    return q, scale


def int8_bmm_cuda(x: torch.Tensor, t: dict) -> torch.Tensor:
    """Launch K5 once for a bank: x (E, C, K) f32 or bf16 on the card,
    t's int8 (E, K, N) and f32 (E, 1, N) scale on the same card; y (E, C,
    N) in x's dtype. Raises on anything else."""
    q, scale = _bank(x, t)
    return _k5(x.contiguous(), q, scale, False)


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


def int8_bmm(x: torch.Tensor, t: dict) -> torch.Tensor:
    """x (E, C, K) times each expert's dequantize(t) of a bank, in x's
    dtype; routed by C, the rows of each expert (module docstring). On
    the card, one K5 launch for the whole bank: no loop over experts."""
    q, scale = _bank(x, t)
    if x.device.type == "cpu":
        return int8_bmm_reference(x, t)
    if x.shape[1] <= KERNEL_MAX_ROWS:
        return _k5(x.contiguous(), q, scale, False)
    return _dequantized_bmm(x, t)
