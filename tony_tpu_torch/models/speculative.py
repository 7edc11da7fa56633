"""Speculative decoding: a draft model proposes, the target verifies.

Counterpart of `tony_tpu/models/speculative.py`. A small draft model
proposes `gamma` tokens a round and the target checks all of them in one
window of gamma + 1 positions. Greedy only, and lossless: the stream is
the target's greedy `generate` stream; the draft changes how many rounds
it takes, never which tokens come out.

The JAX package's mechanics, kept:
- every round drafts exactly `gamma` tokens and verifies a fixed
  (gamma + 1)-token window; rows that accept different counts keep
  per-row cache lengths (`write_cache_rows` at per-row offsets, RoPE at
  per-row positions);
- the caches may hold stale rows beyond a row's length: the window's mask
  (`col < len + row + 1`) hides them and later rounds overwrite them;
- the draft chain consumes all gamma drafted tokens (gamma + 1 steps), so
  its cache stays exactly one token behind the target's stream;
- emit and advance are clipped to the tokens a row still needs, so a
  finishing row never outruns the cache's gamma + 2 slack;
- the eos latch is post-processing on the finished stream.

The JAX `lax.while_loop` is a host loop here that reads one flag (any row
still short of `max_new_tokens`) per round. The window attention is an
f32 einsum, as in the JAX package, not a kernel; the prefills run K1 and
K4, every window K4, and int8 weights take their products through
`llama.linear` (K5 where a product has at most 16 rows).

Exactness is pinned per backend, not assumed: a window's products have
B * (gamma + 1) rows where a decode step's have B, so a library product
(or K5's split plan) may add in another order, and a near-tie of two
logits may then flip. `chip_smoke.py` measures that gap on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from tony_tpu_torch.models.generate import prefill, write_cache_rows
from tony_tpu_torch.models.llama import (
    LlamaConfig, Params, embed_lookup, layer_params, linear, lm_head, mlp,
    qkv_proj, rope_tables,
)
from tony_tpu_torch.models.moe import no_drop_capacity_floor
from tony_tpu_torch.ops.attention import NEG_INF
from tony_tpu_torch.ops.rmsnorm import rms_norm
from tony_tpu_torch.ops.rope import apply_rope

Cache = dict[str, torch.Tensor]


def _window_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, lens: torch.Tensor,
                      config: LlamaConfig) -> torch.Tensor:
    """q: (B, H, W, hd) for window rows written at per-row offsets `lens`
    (B,); caches (B, Hkv, S, hd). Window row i of batch row b attends to
    cache columns < lens[b] + i + 1 (the prefix, then causal within the
    window). f32 scores and softmax, q scaled before the product."""
    b, nh, w, hd = q.shape
    nkv, s = k_cache.shape[1], k_cache.shape[2]
    rep = nh // nkv
    qg = q.reshape(b, nkv, rep, w, hd).float() * hd ** -0.5
    scores = torch.einsum("bgrwd,bgsd->bgrws", qg, k_cache.float())
    col = torch.arange(s, device=q.device)
    row = torch.arange(w, device=q.device)[:, None]
    limit = lens[:, None, None, None, None] + row + 1     # (B,1,1,W,1)
    scores = torch.where(col < limit, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrws,bgsd->bgrwd", probs, v_cache.float())
    return out.reshape(b, nh, w, hd).to(q.dtype)


def window_logits(params: Params, config: LlamaConfig, cache: Cache,
                  tokens: torch.Tensor, lens: torch.Tensor
                  ) -> tuple[torch.Tensor, Cache]:
    """Forward a (B, W) token window against per-row cache lengths (B,).

    Writes the window's K/V at row b's positions lens[b] .. lens[b]+W-1,
    in place, and returns (logits (B, W, V) f32, cache). The caller keeps
    the lengths: it advances only past accepted tokens, and whatever lies
    beyond stays masked until a later window overwrites it. An int8 cache
    is found by its "k_scale" key, as `decode_step` finds it."""
    quant = "k_scale" in cache
    b, w = tokens.shape
    cache_len = cache["k"].shape[3]
    cos, sin = rope_tables(config, cache_len, tokens.device)
    positions = lens[:, None] + torch.arange(w, device=tokens.device)[None]
    x = embed_lookup(params["embed"], tokens, config)      # (B, W, D)
    for i in range(config.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q, k, v = qkv_proj(h, layer, config)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        scales = ((cache["k_scale"][i], cache["v_scale"][i]) if quant
                  else None)
        k_eff, v_eff = write_cache_rows(cache["k"][i], cache["v"][i],
                                        scales, k, v, lens)
        attn = _window_attention(q, k_eff, v_eff, lens, config)
        attn = attn.transpose(1, 2).reshape(b, w, -1)
        x = x + linear(attn, layer["wo"])
        h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
        x = x + mlp(h, layer, config)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return lm_head(x, params["output"]), cache


def speculative_generate(params: Params, draft_params: Params,
                         config: LlamaConfig, draft_config: LlamaConfig,
                         prompt: torch.Tensor, max_new_tokens: int,
                         gamma: int = 4, quant_cache: bool = False,
                         eos_id: Optional[int] = None,
                         stats: Optional[dict] = None) -> torch.Tensor:
    """prompt: (B, P) int -> (B, max_new_tokens), greedily identical to
    `generate(params, config, prompt, max_new_tokens,
    quant_cache=quant_cache, eos_id=eos_id)`: with an int8 cache both
    quantize the same K/V rows at the same positions. The models must
    share a vocabulary, and an MoE target or draft must be at no-drop
    capacity; gamma = drafted tokens a round. `stats`, if given, receives
    "rounds" and "accepted" (the drafted tokens accepted over every live
    row and round), read once at the end."""
    if config.vocab_size != draft_config.vocab_size:
        raise ValueError("target and draft must share a vocabulary: "
                         f"{config.vocab_size} vs "
                         f"{draft_config.vocab_size}")
    for cfg, who in ((config, "target"), (draft_config, "draft")):
        if not getattr(cfg, "n_experts", 0):
            continue
        floor = no_drop_capacity_floor(cfg)
        if cfg.capacity_factor < floor:
            # below no-drop capacity, a queue's overflow depends on how
            # many tokens each call routes: the window routes gamma + 1 a
            # row where a decode step routes one, so the two paths would
            # drop different tokens and the identity would break silently
            raise ValueError(
                f"speculative decoding needs the {who} MoE config at "
                f"no-drop capacity (capacity_factor >= n_experts/top_k "
                f"= {floor}); got {cfg.capacity_factor}")
    b, p = prompt.shape
    n = max_new_tokens
    # slack: a round may write gamma + 1 rows past a row's frozen length
    cache_len = p + n + gamma + 2
    if cache_len > config.max_seq or cache_len > draft_config.max_seq:
        raise ValueError(f"prompt {p} + max_new {n} + gamma {gamma} "
                         f"slack exceeds max_seq")
    device = prompt.device
    with torch.inference_mode():
        t_logits, t_cache = prefill(params, prompt, config, cache_len,
                                    quant_cache=quant_cache)
        _, d_cache = prefill(draft_params, prompt, draft_config, cache_len,
                             quant_cache=quant_cache)
        tok0 = torch.argmax(t_logits, dim=-1)
        out = torch.zeros((b, n), dtype=tok0.dtype, device=device)
        out[:, 0] = tok0
        # per row: `last` is the newest emitted token, which neither model
        # has consumed; at each round's start lens = the tokens the target
        # consumed (p + emitted - 1), and the draft cache holds the same
        lens = torch.full((b,), p, dtype=torch.long, device=device)
        last = tok0
        emitted = torch.ones((b,), dtype=torch.long, device=device)
        cols = torch.arange(n, device=device)[None]
        accepted_sum = torch.zeros((), dtype=torch.long, device=device)
        rounds = 0
        while bool((emitted < n).any()):
            rounds += 1
            live = emitted < n          # frozen rows stop advancing
            # the draft chain: gamma + 1 steps consume [last, d1..dgamma],
            # so the draft cache covers every token the target can accept;
            # the last proposal is never used
            d_len, tok, drafts = lens, last, []
            for _ in range(gamma + 1):
                lg, d_cache = window_logits(draft_params, draft_config,
                                            d_cache, tok[:, None], d_len)
                tok = torch.argmax(lg[:, 0], dim=-1)
                d_len = d_len + live
                drafts.append(tok)
            drafts = torch.stack(drafts[:gamma], dim=1)       # (B, gamma)
            # the target: one window over [last, d1..dgamma]
            window = torch.cat([last[:, None], drafts], dim=1)
            w_logits, t_cache = window_logits(params, config, t_cache,
                                              window, lens)
            greedy = torch.argmax(w_logits, dim=-1)       # (B, gamma + 1)
            # the longest drafted prefix the target's greedy agrees with
            match = drafts == greedy[:, :gamma]
            accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
            # emit accepted + 1 greedy tokens, clipped to what the row
            # still needs; a gather per output slot (no scatter)
            emit = torch.where(live, torch.minimum(accepted + 1,
                                                   n - emitted), 0)
            off = cols - emitted[:, None]                     # (B, n)
            sel = (off >= 0) & (off < emit[:, None])
            picked = torch.gather(greedy, 1, off.clamp(0, gamma))
            out = torch.where(sel, picked, out)
            # the target consumed [last, d1..d_accepted]; the new `last`
            # is its correction (or bonus) greedy[accepted]; the advance is
            # clipped as emit is, so a finishing row's length stays within
            # the slack
            new_last = torch.gather(greedy, 1, accepted[:, None])[:, 0]
            accepted_sum = accepted_sum + torch.where(live, accepted,
                                                      0).sum()
            lens = lens + emit
            last = torch.where(live, new_last, last)
            emitted = emitted + emit
        if eos_id is not None:
            # greedy generate latches eos: every token after the first
            # emitted eos_id is eos_id; the rounds above kept emitting the
            # target's greedy continuation, and the prefix before the
            # first eos is the same in both paths
            hit = out == eos_id
            first = torch.argmax(hit.int(), dim=1)
            after = cols > first[:, None]
            out = torch.where(after & hit.any(dim=1)[:, None], eos_id, out)
        if stats is not None:
            stats["rounds"] = rounds
            stats["accepted"] = int(accepted_sum)
        return out
