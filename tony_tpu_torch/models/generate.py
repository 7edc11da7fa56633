"""Autoregressive generation for the Llama family: KV-cache decode.

Counterpart of `tony_tpu/models/generate.py`, bf16/f32 caches only:

- **Prefill** runs the prompt through the model with causal flash attention
  over narrow GQA K/V (the flash and RMSNorm kernels on the card) and
  writes each layer's K/V into a cache laid out as in the JAX package,
  (L, B, Hkv, cache_len, hd).
- **Decode step**: one token per row, at a scalar position or at per-row
  positions (B,) (continuous batching). Each layer's new K/V row is
  written into the cache in place, where JAX used `dynamic_update_slice`
  on an immutable array, and attention is a masked single-query einsum
  against the cache, grouped by GQA head group (K/V never repeated).
- **Sampling**: greedy, or temperature with optional top-k and top-p; the
  random draws come from a `torch.Generator`.

The logits are f32 (`ops/xent.matmul_f32`). The int8 cache and int8
weights arrive with the port's quant slice, MoE with its models slice.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from tony_tpu_torch.models.llama import (
    LlamaConfig, Params, embed_lookup, layer_params, matmul_f32, qkv_proj,
    rope_tables, swiglu_mlp,
)
from tony_tpu_torch.ops.attention import NEG_INF, flash_attention
from tony_tpu_torch.ops.rmsnorm import rms_norm
from tony_tpu_torch.ops.rope import apply_rope

Cache = dict[str, torch.Tensor]


def empty_cache(config: LlamaConfig, batch: int, cache_len: int,
                device: torch.device) -> Cache:
    """Zero cache {"k", "v"}: (L, batch, Hkv, cache_len, hd) each."""
    shape = (config.n_layers, batch, config.n_kv_heads, cache_len,
             config.head_dim)
    return {"k": torch.zeros(shape, dtype=config.dtype, device=device),
            "v": torch.zeros(shape, dtype=config.dtype, device=device)}


def write_cache_rows(kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, offsets: torch.Tensor) -> None:
    """Write new K/V rows (B, Hkv, W, hd) into one layer's caches
    (B, Hkv, S, hd) at per-row offsets (B,), in place (where the JAX
    package returned new arrays from `dynamic_update_slice`). The int8
    cache and its scales arrive with the quant slice."""
    rows = torch.arange(k.shape[0], device=k.device)
    for w in range(k.shape[2]):
        kc[rows, :, offsets + w] = k[:, :, w].to(kc.dtype)
        vc[rows, :, offsets + w] = v[:, :, w].to(vc.dtype)


def _cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cur_len: Union[int, torch.Tensor],
                     config: LlamaConfig) -> torch.Tensor:
    """Single-position attention against the cache. q: (B, H, 1, hd);
    caches: (B, Hkv, S_max, hd); positions >= cur_len are masked. cur_len
    is an int (whole batch) or (B,) per-row lengths. q is scaled in f32
    before the product, as in the JAX package."""
    b, nh, _, hd = q.shape
    nkv = k_cache.shape[1]
    rep = nh // nkv
    if isinstance(cur_len, torch.Tensor) and cur_len.ndim == 1:
        cur_len = cur_len[:, None, None, None]             # (B,1,1,1)
    qg = q.reshape(b, nkv, rep, hd).float() * hd ** -0.5
    scores = torch.einsum("bgrd,bgsd->bgrs", qg, k_cache.float())
    cols = torch.arange(scores.shape[-1], device=q.device)
    scores = torch.where(cols < cur_len, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", probs, v_cache.float())
    return out.reshape(b, nh, 1, hd).to(q.dtype)


def prefill(params: Params, tokens: torch.Tensor, config: LlamaConfig,
            cache_len: int, cache: Optional[Cache] = None
            ) -> tuple[torch.Tensor, Cache]:
    """Run the prompt through the model; returns last-position logits
    (B, V) f32 and the cache with the prompt's K/V in positions [0, P).

    tokens: (B, P) int; cache_len >= P. Without `cache` a zero cache of
    cache_len positions is made. With one (shape (L, B, Hkv, S, hd), for
    instance a slot's rows of a shared cache, as views), the prompt's K/V
    are written into it in place and its positions >= P are left as they
    were."""
    b, p = tokens.shape
    if p > cache_len:
        raise ValueError(f"prompt {p} exceeds cache_len {cache_len}")
    if cache is None:
        cache = empty_cache(config, b, cache_len, tokens.device)
    cos, sin = rope_tables(config, cache_len, tokens.device)
    cos, sin = cos[:p], sin[:p]
    x = embed_lookup(params["embed"], tokens, config)
    for i in range(config.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q, k, v = qkv_proj(h, layer, config)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = flash_attention(q, k, v, True)
        attn = attn.transpose(1, 2).reshape(b, p, -1)
        x = x + attn @ layer["wo"]
        h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
        x = x + swiglu_mlp(h, layer)
        cache["k"][i, :, :, :p] = k
        cache["v"][i, :, :, :p] = v
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = matmul_f32(x[:, -1], params["output"])
    return logits, cache


def decode_step(params: Params, config: LlamaConfig, cache: Cache,
                token: torch.Tensor, pos: Union[int, torch.Tensor]
                ) -> tuple[torch.Tensor, Cache]:
    """One decode step. token: (B,) int; pos: an int (the position every
    row's token occupies) or (B,) int per-row positions (continuous
    batching: every row an independent request at its own length).
    Returns (logits (B, V) f32, cache), the cache updated in place."""
    cache_len = cache["k"].shape[3]
    device = token.device
    cos, sin = rope_tables(config, cache_len, device)
    b = token.shape[0]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos[:, None]                      # (B, 1)
        offsets = pos
    else:
        pos = int(pos)
        positions = torch.tensor([pos], device=device)   # (1,)
        offsets = torch.full((b,), pos, device=device)
    cur_len = pos + 1
    x = embed_lookup(params["embed"], token[:, None], config)  # (B, 1, D)
    for i in range(config.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q, k, v = qkv_proj(h, layer, config)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        kc, vc = cache["k"][i], cache["v"][i]
        write_cache_rows(kc, vc, k, v, offsets)
        attn = _cache_attention(q, kc, vc, cur_len, config)
        attn = attn.transpose(1, 2).reshape(b, 1, -1)
        x = x + attn @ layer["wo"]
        h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
        x = x + swiglu_mlp(h, layer)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = matmul_f32(x[:, 0], params["output"])
    return logits, cache


def _sample(logits: torch.Tensor, temperature: float, top_k: int,
            generator: Optional[torch.Generator],
            top_p: float = 1.0) -> torch.Tensor:
    """(B, V) -> (B,) next tokens: argmax at temperature 0, else a
    Gumbel-max draw from the truncated, tempered distribution."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        top_k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]    # (B, 1)
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        # nucleus: the smallest set of tokens whose mass reaches top_p,
        # floored so the most probable token always survives
        top_p = max(top_p, 1e-9)
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        threshold = torch.where(keep, srt, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits >= threshold, logits, NEG_INF)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def generate(params: Params, config: LlamaConfig, prompt: torch.Tensor,
             max_new_tokens: int, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompt: (B, P) int -> (B, max_new_tokens) generated tokens.

    Greedy when temperature == 0 (generator unused); once a row emits
    eos_id it keeps emitting eos_id."""
    b, p = prompt.shape
    cache_len = p + max_new_tokens
    if cache_len > config.max_seq:
        raise ValueError(f"prompt {p} + max_new {max_new_tokens} exceeds "
                         f"max_seq {config.max_seq}")
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    with torch.inference_mode():
        logits, cache = prefill(params, prompt, config, cache_len)
        tok = _sample(logits, temperature, top_k, generator, top_p)
        done = (tok == eos_id) if eos_id is not None else None
        out = [tok]
        for pos in range(p, p + max_new_tokens - 1):
            # decode the previous token, sample the next: the last sampled
            # token never pays a trailing decode step
            logits, cache = decode_step(params, config, cache, tok, pos)
            tok = _sample(logits, temperature, top_k, generator, top_p)
            if done is not None:
                tok = torch.where(done, eos_id, tok)
                done = done | (tok == eos_id)
            out.append(tok)
        return torch.stack(out, dim=1)
