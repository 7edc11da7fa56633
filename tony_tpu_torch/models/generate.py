"""Autoregressive generation for the Llama family: KV-cache decode.

Counterpart of `tony_tpu/models/generate.py`:

- **Prefill** runs the prompt through the model with causal flash attention
  over narrow GQA K/V (the flash and RMSNorm kernels on the card) and
  writes each layer's K/V into a cache laid out as in the JAX package,
  (L, B, Hkv, cache_len, hd).
- **Decode step**: one token per row, at a scalar position or at per-row
  positions (B,) (continuous batching). Each layer's RoPE, the write of
  its new K/V row into the cache in place (where JAX used
  `dynamic_update_slice` on an immutable array) and the single-query
  attention over each row's live positions, grouped by GQA head group
  (K/V never repeated), are one `ops/decode_attention.decode_attention`
  call: one K6 launch on the card, the JAX package's masked einsums on
  the CPU.
- **Sampling**: greedy, or temperature with optional top-k and top-p; the
  random draws come from a `torch.Generator`.
- **int8 cache** (`quant_cache=True`): K/V rows stored as per-row int8
  with f32 scales (..., 1) beside them, "k_scale" and "v_scale", in the
  JAX layout; `decode_step` finds it by the "k_scale" key and attends to
  the rows dequantized to f32 (`cache_attention`), as the JAX package
  does.
- **int8 weights** (`models/quant.quantize_params`) pass straight through:
  `models/llama.linear` and `lm_head` route their products.
- **MoE** (`models/moe.py`): the MLP is `llama.mlp`, dispatched on the
  config type, so one stack serves both families. Each call routes its own
  tokens: at capacity_factor >= n_experts / top_k nothing overflows and
  incremental decode is the training forward; below it `generate` warns
  (`_warn_moe_below_capacity`), as the JAX package does.

The logits are f32 (`llama.lm_head`). `generate_text` wraps `generate` for
a tokenizer with encode/decode, batching prompts of one length together.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

import torch

from tony_tpu_torch.models.llama import (
    LlamaConfig, Params, embed_lookup, layer_params, linear, lm_head, mlp,
    qkv_proj, rope_tables,
)
from tony_tpu_torch.models.quant import dequantize_rows, quantize_rows
from tony_tpu_torch.ops.attention import NEG_INF, flash_attention
from tony_tpu_torch.ops.decode_attention import (
    cache_attention, decode_attention, write_rows,
)
from tony_tpu_torch.ops.rmsnorm import rms_norm
from tony_tpu_torch.ops.rope import apply_rope

Cache = dict[str, torch.Tensor]


def _warn_moe_below_capacity(config: LlamaConfig, who: str = "decode"
                             ) -> None:
    """Warn when an MoE config below no-drop capacity reaches the decode
    path: decode routes each step's tokens on their own while the training
    forward routes the whole sequence, so the two overflow different
    expert queues and decode serves tokens training dropped."""
    if not getattr(config, "n_experts", 0):
        return
    from tony_tpu_torch.models.moe import no_drop_capacity_floor
    floor = no_drop_capacity_floor(config)
    if config.capacity_factor < floor:
        warnings.warn(
            f"MoE config reaches the {who} path below no-drop capacity "
            f"(capacity_factor {config.capacity_factor} < n_experts/"
            f"top_k = {floor}): decode routes tokens the training "
            f"forward dropped — raise capacity_factor to >= {floor} "
            f"for train/serve parity", stacklevel=3)


def empty_cache(config: LlamaConfig, batch: int, cache_len: int,
                device: torch.device, quant_cache: bool = False) -> Cache:
    """Zero cache {"k", "v"}: (L, batch, Hkv, cache_len, hd) each, in
    config.dtype, or int8 with f32 scales (..., 1) "k_scale", "v_scale"."""
    shape = (config.n_layers, batch, config.n_kv_heads, cache_len,
             config.head_dim)
    if quant_cache:
        scale = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale, dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(scale, dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=config.dtype, device=device),
            "v": torch.zeros(shape, dtype=config.dtype, device=device)}


def write_cache_rows(kc: torch.Tensor, vc: torch.Tensor, scales,
                     k: torch.Tensor, v: torch.Tensor,
                     offsets: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write new K/V rows (B, Hkv, W, hd) into one layer's caches
    (B, Hkv, S, hd) at per-row offsets (B,), in place (where the JAX
    package returned new arrays from `dynamic_update_slice`), quantizing
    them iff `scales` is given ((k_scale, v_scale) of an int8 cache, None
    for a bf16/f32 one). Returns the attention-ready views (k, v): the
    caches themselves, or their rows dequantized to f32."""
    rows = torch.arange(k.shape[0], device=k.device)
    if scales is None:
        write_rows(kc, k, rows, offsets)
        write_rows(vc, v, rows, offsets)
        return kc, vc
    ksc, vsc = scales
    qk, k_s = quantize_rows(k)
    qv, v_s = quantize_rows(v)
    for dst, src in ((kc, qk), (vc, qv), (ksc, k_s), (vsc, v_s)):
        write_rows(dst, src, rows, offsets)
    return dequantize_rows(kc, ksc), dequantize_rows(vc, vsc)


def prefill(params: Params, tokens: torch.Tensor, config: LlamaConfig,
            cache_len: int, cache: Optional[Cache] = None,
            quant_cache: bool = False) -> tuple[torch.Tensor, Cache]:
    """Run the prompt through the model; returns last-position logits
    (B, V) f32 and the cache with the prompt's K/V in positions [0, P).

    tokens: (B, P) int; cache_len >= P. Without `cache` a zero cache of
    cache_len positions is made, int8 with scales when quant_cache. With
    one (shape (L, B, Hkv, S, hd), for instance a slot's rows of a shared
    cache, as views; int8 when it holds "k_scale"), the prompt's K/V are
    written into it in place and its positions >= P are left as they
    were."""
    b, p = tokens.shape
    if p > cache_len:
        raise ValueError(f"prompt {p} exceeds cache_len {cache_len}")
    if cache is None:
        cache = empty_cache(config, b, cache_len, tokens.device,
                            quant_cache)
    quant = "k_scale" in cache
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
        x = x + linear(attn, layer["wo"])
        h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
        x = x + mlp(h, layer, config)
        if quant:
            (cache["k"][i, :, :, :p],
             cache["k_scale"][i, :, :, :p]) = quantize_rows(k)
            (cache["v"][i, :, :, :p],
             cache["v_scale"][i, :, :, :p]) = quantize_rows(v)
        else:
            cache["k"][i, :, :, :p] = k
            cache["v"][i, :, :, :p] = v
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = lm_head(x[:, -1], params["output"])
    return logits, cache


def decode_step(params: Params, config: LlamaConfig, cache: Cache,
                token: torch.Tensor, pos: Union[int, torch.Tensor]
                ) -> tuple[torch.Tensor, Cache]:
    """One decode step. token: (B,) int; pos: an int (the position every
    row's token occupies) or (B,) int64 per-row positions (continuous
    batching: every row an independent request at its own length).
    Returns (logits (B, V) f32, cache), the cache updated in place. An
    int8 cache is found by its "k_scale" key and attends to its rows
    dequantized (`cache_attention`); any other takes `decode_attention`."""
    quant = "k_scale" in cache
    cache_len = cache["k"].shape[3]
    device = token.device
    cos, sin = rope_tables(config, cache_len, device)
    b = token.shape[0]
    if not (isinstance(pos, torch.Tensor) and pos.ndim == 1):
        pos = torch.full((b,), int(pos), dtype=torch.long, device=device)
    if quant:
        positions = pos[:, None]                      # (B, 1)
        cur_len = pos + 1
    x = embed_lookup(params["embed"], token[:, None], config)  # (B, 1, D)
    for i in range(config.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q, k, v = qkv_proj(h, layer, config)
        if quant:
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            k_eff, v_eff = write_cache_rows(
                cache["k"][i], cache["v"][i],
                (cache["k_scale"][i], cache["v_scale"][i]), k, v, pos)
            attn = cache_attention(q, k_eff, v_eff, cur_len)
            attn = attn.transpose(1, 2).reshape(b, 1, -1)
        else:
            attn = decode_attention(q, k, v, cache["k"], cache["v"], i, cos,
                                    sin, pos)
        x = x + linear(attn, layer["wo"])
        h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
        x = x + mlp(h, layer, config)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = lm_head(x[:, 0], params["output"])
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
             generator: Optional[torch.Generator] = None,
             quant_cache: bool = False) -> torch.Tensor:
    """prompt: (B, P) int -> (B, max_new_tokens) generated tokens.

    Greedy when temperature == 0 (generator unused); once a row emits
    eos_id it keeps emitting eos_id. quant_cache keeps the KV cache in
    per-row int8; int8 weights (`quantize_params`) compose with it. An MoE
    config below no-drop capacity warns (`_warn_moe_below_capacity`)."""
    _warn_moe_below_capacity(config)
    b, p = prompt.shape
    cache_len = p + max_new_tokens
    if cache_len > config.max_seq:
        raise ValueError(f"prompt {p} + max_new {max_new_tokens} exceeds "
                         f"max_seq {config.max_seq}")
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    with torch.inference_mode():
        logits, cache = prefill(params, prompt, config, cache_len,
                                quant_cache=quant_cache)
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


def generate_text(params: Params, config: LlamaConfig, prompt, tokenizer,
                  max_new_tokens: int = 64, **kwargs) -> list[str]:
    """For a tokenizer object with encode/decode (a transformers tokenizer,
    say); prompt: a str or a list of str. The decode path has no padding
    mask, so prompts are grouped by length and each group generated as a
    batch of its own: a padded shorter prompt would feed pad embeddings
    into attention and shift its RoPE positions. The prompts go to the
    embedding table's device; `kwargs` go to `generate`."""
    if isinstance(prompt, str):
        prompt = [prompt]
    device = params["embed"].device
    ids = [list(tokenizer.encode(t)) for t in prompt]
    out: dict[int, list[int]] = {}
    by_len: dict[int, list[int]] = {}
    for i, seq in enumerate(ids):
        by_len.setdefault(len(seq), []).append(i)
    for idxs in by_len.values():
        batch = torch.tensor([ids[i] for i in idxs], dtype=torch.long,
                             device=device)
        toks = generate(params, config, batch, max_new_tokens, **kwargs)
        for i, row in zip(idxs, toks.tolist()):
            out[i] = row
    return [tokenizer.decode(out[i]) for i in range(len(ids))]
