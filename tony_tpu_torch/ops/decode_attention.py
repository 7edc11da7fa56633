"""Decode attention: K6, a hand-written CUDA kernel for one decode step's
attention sublayer, and its plain PyTorch version.

For one layer at per-row positions pos (B,): RoPE of the new q (B, H, 1,
hd) and k (B, Hkv, 1, hd) at pos (f32, rounded to the compute dtype, as
`apply_rope`), the rotated k and the raw v written into row pos[b] of the
layer's cache (L, B, Hkv, S, hd) in place, and GQA attention of each query
head over its row's cache positions [0, pos[b]] (q scaled by hd**-0.5 in
f32, f32 scores, softmax and sums, the result in the compute dtype). The
result is (B, 1, H * hd), the layout the output projection takes.

The JAX package has no Pallas kernel here: its decode step rotates,
writes with `dynamic_update_slice` and attends with two masked einsums
(`tony_tpu/models/generate.py:120-139`), fused by XLA. The plain version
(`decode_attention_reference`) is that composition in PyTorch: `apply_rope`
twice, `write_rows` and `cache_attention`, which cast every slot's whole
budget to f32. The kernel (`csrc/decode_attention.cu`) reads only each
row's live cache rows, in the cache's own dtype, in one launch a layer; it
is bound by those bytes.

Dispatch is on the tensor's device: a CUDA tensor goes to the kernel (or
raises: a head dim, group size or dtype it does not take is an error), a
CPU tensor to the plain version. An int8 cache is another algorithm
(`models/generate.py` dequantizes its rows for `cache_attention`) and never
reaches this function.
"""

from __future__ import annotations

import ctypes

import torch

from tony_tpu_torch.ops.attention import NEG_INF
from tony_tpu_torch.ops.cuda_lib import Kernel, dtype_code
from tony_tpu_torch.ops.rope import apply_rope

# the head dims and query heads per KV head K6 is built for
HEAD_DIMS = (16, 64, 128)
GROUPS = (1, 2, 4, 8)
# the most units one (row, KV head) pair spans and the most rows of one
# launch (csrc/decode_attention.cu kMaxParts, kMaxBatch)
MAX_PARTS = 32
MAX_BATCH = 256

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
DECODE_ATTENTION = Kernel(
    "decode_attention", "decode_attention.cu", "tt_decode_attention",
    [_P, _P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
     _I, ctypes.c_float, _I],
    replaces="none: XLA's RoPE, dynamic_update_slice and masked einsums of "
             "tony_tpu/models/generate.py:194-243 (`_cache_attention` "
             ":120-139)")

# the partials' f32 scratch and the int32 counters (zeros between
# launches: each launch sets back what it counted), one pair per (device
# index, stream), grown to the largest launch served
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def write_rows(dst: torch.Tensor, src: torch.Tensor, rows: torch.Tensor,
               offsets: torch.Tensor) -> None:
    """dst (B, Hkv, S, hd)[rows, :, offsets + w] = src (B, Hkv, W, hd)[:,
    :, w] for each w, in dst's dtype, in place."""
    for w in range(src.shape[2]):
        dst[rows, :, offsets + w] = src[:, :, w].to(dst.dtype)


def cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor,
                    cur_len: torch.Tensor) -> torch.Tensor:
    """Single-position attention against the cache. q: (B, H, 1, hd);
    caches: (B, Hkv, S_max, hd); each row's positions >= cur_len (B,) are
    masked. q is scaled in f32 before the product, as in the JAX
    package."""
    b, nh, _, hd = q.shape
    nkv = k_cache.shape[1]
    rep = nh // nkv
    cur_len = cur_len[:, None, None, None]                 # (B,1,1,1)
    qg = q.reshape(b, nkv, rep, hd).float() * hd ** -0.5
    scores = torch.einsum("bgrd,bgsd->bgrs", qg, k_cache.float())
    cols = torch.arange(scores.shape[-1], device=q.device)
    scores = torch.where(cols < cur_len, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", probs, v_cache.float())
    return out.reshape(b, nh, 1, hd).to(q.dtype)


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, layer: int,
                               cos: torch.Tensor, sin: torch.Tensor,
                               pos: torch.Tensor) -> torch.Tensor:
    """The plain version: `apply_rope` of q and k at pos, the rows written
    into layer `layer` of the caches in place, `cache_attention` over
    [0, pos]; (B, 1, H * hd)."""
    positions = pos[:, None]
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    kc, vc = k_cache[layer], v_cache[layer]
    rows = torch.arange(k.shape[0], device=k.device)
    write_rows(kc, k, rows, pos)
    write_rows(vc, v, rows, pos)
    attn = cache_attention(q, kc, vc, pos + 1)
    return attn.transpose(1, 2).reshape(q.shape[0], 1, -1)


def _scratch(device: torch.device, n_part: int, n_counters: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """At least n_part f32 and n_counters int32 zeros on `device`, for its
    current stream."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    held = _SCRATCH.get(key)
    if held is None or held[0].numel() < n_part \
            or held[1].numel() < n_counters:
        held = (torch.empty(n_part, dtype=torch.float32, device=device),
                torch.zeros(n_counters, dtype=torch.int32, device=device))
        _SCRATCH[key] = held
    return held


def _check(q, k, v, k_cache, v_cache, layer, cos, sin, pos) -> None:
    """Raise unless the arguments are what K6 takes. (Every layer of a
    decode step passes here: explicit comparisons, no generators.)"""
    b, h, one, hd = q.shape
    kshape, cshape = k.shape, k_cache.shape
    hkv = kshape[1]
    n_layers, s = cshape[0], cshape[3]
    if one != 1 or kshape != (b, hkv, 1, hd) or v.shape != kshape:
        raise ValueError(f"decode attention takes q (B, H, 1, hd) and k, v "
                         f"(B, Hkv, 1, hd), got {tuple(q.shape)}, "
                         f"{tuple(kshape)}, {tuple(v.shape)}")
    if cshape != (n_layers, b, hkv, s, hd) or v_cache.shape != cshape:
        raise ValueError(f"decode attention takes caches (L, {b}, {hkv}, S, "
                         f"{hd}), got {tuple(cshape)} and "
                         f"{tuple(v_cache.shape)}")
    dtype = q.dtype
    if (dtype_code(dtype) is None or k.dtype != dtype or v.dtype != dtype
            or k_cache.dtype != dtype or v_cache.dtype != dtype):
        raise TypeError(f"decode attention kernel takes q, k, v and the "
                        f"caches all float32 or all bfloat16, got "
                        f"{dtype}, {k.dtype}, {v.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    rep = h // hkv
    if hd not in HEAD_DIMS or h % hkv or rep not in GROUPS \
            or rep > hd * q.element_size() // 16:
        raise ValueError(f"decode attention kernel takes head dims "
                         f"{HEAD_DIMS} and {GROUPS} query heads a KV head, "
                         f"at most hd * itemsize / 16, got hd {hd}, H {h}, "
                         f"Hkv {hkv}, {dtype}")
    tshape = cos.shape
    if cos.dtype != torch.float32 or sin.dtype != torch.float32 \
            or sin.shape != tshape or tshape[0] < s \
            or tshape[1:] != (hd // 2,):
        raise TypeError(f"decode attention takes float32 (>= {s}, "
                        f"{hd // 2}) RoPE tables, got {cos.dtype} "
                        f"{tuple(tshape)} and {sin.dtype} "
                        f"{tuple(sin.shape)}")
    if pos.dtype != torch.int64 or pos.shape != (b,):
        raise TypeError(f"decode attention takes int64 ({b},) positions, "
                        f"got {pos.dtype} {tuple(pos.shape)}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} of a {n_layers}-layer cache")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if (qs[3] != 1 or qs[1] != hd or ks[3] != 1 or ks[1] != hd
            or vs[3] != 1 or vs[1] != hd or ks[0] != vs[0]):
        raise ValueError("decode attention takes q, k, v whose heads are "
                         "contiguous rows of hd")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()
            and cos.is_contiguous() and sin.is_contiguous()
            and pos.is_contiguous()):
        raise ValueError("decode attention takes contiguous caches, tables "
                         "and positions")
    device = q.device
    if (k.device != device or v.device != device
            or k_cache.device != device or v_cache.device != device
            or cos.device != device or sin.device != device
            or pos.device != device):
        raise ValueError("decode attention takes its tensors on one device")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          layer: int, cos: torch.Tensor, sin: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """K6: one launch for up to MAX_BATCH rows (a launch a slice of them
    past that); raises on anything it does not take (`_check`)."""
    _check(q, k, v, k_cache, v_cache, layer, cos, sin, pos)
    b, h, _, hd = q.shape
    hkv, s = k.shape[1], k_cache.shape[3]
    rep = h // hkv
    out = torch.empty((b, 1, h * hd), dtype=q.dtype, device=q.device)
    rows = min(b, MAX_BATCH)
    part, counters = _scratch(q.device,
                              rows * hkv * MAX_PARTS * rep * (hd + 2),
                              rows * hkv)
    es = q.element_size()
    row_bytes = hkv * s * hd * es                  # one row of a layer
    at = layer * b * row_bytes
    for b0 in range(0, b, MAX_BATCH):
        n = min(MAX_BATCH, b - b0)
        DECODE_ATTENTION.launch(
            q.device, _P(q.data_ptr() + b0 * q.stride(0) * es),
            _P(k.data_ptr() + b0 * k.stride(0) * es),
            _P(v.data_ptr() + b0 * v.stride(0) * es), q.stride(0),
            k.stride(0), _P(k_cache.data_ptr() + at + b0 * row_bytes),
            _P(v_cache.data_ptr() + at + b0 * row_bytes),
            _P(cos.data_ptr()), _P(sin.data_ptr()),
            _P(pos.data_ptr() + b0 * 8), _P(out.data_ptr() + b0 * h * hd * es),
            _P(part.data_ptr()), _P(counters.data_ptr()), n, hkv, rep, s, hd,
            hd ** -0.5, dtype_code(q.dtype))
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     layer: int, cos: torch.Tensor, sin: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """One decode step's attention sublayer for layer `layer` (module
    docstring): q (B, H, 1, hd), k/v (B, Hkv, 1, hd) pre-RoPE, the caches
    (L, B, Hkv, S, hd) written in place, f32 (S, hd/2) RoPE tables, int64
    (B,) positions -> (B, 1, H * hd)."""
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k, v, k_cache, v_cache, layer, cos,
                                     sin, pos)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, k_cache, v_cache, layer,
                                          cos, sin, pos)
    raise ValueError(f"decode attention runs on cuda or cpu, not "
                     f"{q.device}")
