"""The benchmark's own arithmetic: peak rates, model FLOPs and kernel bounds.

Kept here so that a change to the program cannot move the yardstick.

- `CARD_PEAKS` is a copy of `tony_tpu_torch/device.py`'s table (NVIDIA's
  data sheets, dense rates): (substring of the card's name, memory TB/s,
  dense bf16 TFLOP/s, f32 non-tensor TFLOP/s); the first match wins.
- `flash_fwd_flops` / `flash_bwd_*` are the bounds `chip_smoke.py` holds
  K1-K3 to (`_flash_fwd_times`, the backward cases): two causal-half
  products of 2*S*S*D per head for K1, three for K2, four for K3, at the
  bf16 peak, or their bytes at the memory rate where those take longer.
- `useful_flops_per_token` is the count of `LlamaConfig.flops_per_token`
  and `MoEConfig.flops_per_token` (6 N plus attention, active parameters
  for an MoE) with two changes: the attention term counts the causal half
  (6 * L * dim * S, where the port's 12 * L * dim * S counts every pair),
  and the embedding lookup is no product, so its table is not in N.
"""

from __future__ import annotations

CARD_PEAKS = (
    ("H100 PCIe", 2.0, 756.0, 51.0),
    ("H100 NVL", 3.9, 835.0, 60.0),
    ("H200", 4.8, 989.0, 67.0),
    ("H100", 3.35, 989.0, 67.0),
)


def card_peaks(name: str) -> tuple[float, float, float] | None:
    """(bytes/s, bf16 FLOP/s, f32 FLOP/s) of the card named `name`, or None
    for a card not in the table."""
    for key, tbs, bf16, f32 in CARD_PEAKS:
        if key in name:
            return tbs * 1e12, bf16 * 1e12, f32 * 1e12
    return None


# ---------------------------------------------------------------------------
# model FLOPs and bytes (sizes from a configuration file's keys)
# ---------------------------------------------------------------------------

def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def attention_params(cfg: dict) -> int:
    """Products of one layer's attention: q, k, v and o."""
    d, hd = cfg["hidden_size"], head_dim(cfg)
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return d * nh * hd + 2 * d * nkv * hd + nh * hd * d


def mlp_params(cfg: dict) -> int:
    """One SwiGLU MLP's products (gate, up, down)."""
    return 3 * cfg["hidden_size"] * cfg["intermediate_size"]


def n_experts(cfg: dict) -> int:
    return int(cfg.get("num_local_experts", 0) or 0)


def layer_product_params(cfg: dict, active: bool = True) -> int:
    """Products one token takes through one layer: attention, and the
    dense MLP or, for an MoE, the router and `num_experts_per_tok` expert
    MLPs (every expert when active=False)."""
    e = n_experts(cfg)
    if not e:
        return attention_params(cfg) + mlp_params(cfg)
    k = cfg["num_experts_per_tok"] if active else e
    return (attention_params(cfg) + k * mlp_params(cfg)
            + cfg["hidden_size"] * e)


def product_params(cfg: dict, active: bool = True) -> int:
    """Every layer's products plus the output head (no embedding)."""
    return (cfg["num_hidden_layers"] * layer_product_params(cfg, active)
            + cfg["hidden_size"] * cfg["vocab_size"])


def weight_bytes(cfg: dict, itemsize: int = 2) -> int:
    """Bytes a forward reads of the weights that take products (every
    expert of every layer and the head), in the served dtype."""
    return product_params(cfg, active=False) * itemsize


def useful_flops_per_token(cfg: dict, seq: int) -> float:
    """Training FLOPs of one token at sequence length `seq`: 6 per active
    product parameter (forward, two backward products) plus the causal
    half of attention's four products of a (query, key) pair, forward and
    backward: 6 * L * dim * S. No recompute, no padding, no lookup."""
    attn = 6.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] \
        * head_dim(cfg) * seq
    return 6.0 * product_params(cfg) + attn


def prefill_flops(cfg: dict, prompt_len: int) -> float:
    """A prompt's prefill: 2 per active layer product parameter per token,
    the causal half of attention's two products per layer, and the head's
    product on the last position, which is all the engine computes."""
    layers = cfg["num_hidden_layers"]
    per_token = 2.0 * layers * layer_product_params(cfg)
    attn = 2.0 * layers * cfg["num_attention_heads"] * head_dim(cfg) \
        * prompt_len * prompt_len
    return per_token * prompt_len + attn \
        + 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def decode_token_flops(cfg: dict, context_len: int) -> float:
    """One decoded token: its layer products and head, and attention's two
    products over `context_len` cached positions."""
    layers = cfg["num_hidden_layers"]
    attn = 4.0 * layers * cfg["num_attention_heads"] * head_dim(cfg) \
        * context_len
    return 2.0 * product_params(cfg) + attn


def kv_bytes_per_position(cfg: dict, itemsize: int = 2) -> int:
    """Cache bytes one position holds over every layer (K and V)."""
    return (2 * cfg["num_hidden_layers"] * cfg["num_key_value_heads"]
            * head_dim(cfg) * itemsize)


# ---------------------------------------------------------------------------
# kernel bounds (chip_smoke.py's)
# ---------------------------------------------------------------------------

def _flash_pairs(s: int, causal: bool) -> float:
    return s * s / 2 if causal else s * s


def flash_fwd_bound_s(b: int, h: int, hk: int, s: int, d: int, peaks,
                      causal: bool = True, itemsize: int = 2) -> float:
    """K1's least time: two products of 2*D per (query, key) pair at the
    bf16 peak, or q, k, v, out and the f32 lse at the memory rate."""
    bw, bf16, _ = peaks
    flops = 4.0 * b * h * _flash_pairs(s, causal) * d
    nbytes = (2 * b * h * s * d + 2 * b * hk * s * d) * itemsize + 4 * b * h * s
    return max(flops / bf16, nbytes / bw)


def flash_bwd_bounds_s(b: int, h: int, hk: int, s: int, d: int, peaks,
                       causal: bool = True, itemsize: int = 2
                       ) -> tuple[float, float]:
    """(K2's, K3's) least time: three and four products of 2*D per pair;
    their inputs (q, k, v, dO and lse, delta) and outputs (dq; dk, dv)."""
    bw, bf16, _ = peaks
    product = 2.0 * b * h * _flash_pairs(s, causal) * d
    in_bytes = (2 * b * h * s * d + 2 * b * hk * s * d) * itemsize \
        + 2 * 4 * b * h * s
    dq_bytes = b * h * s * d * itemsize
    dkv_bytes = 2 * b * hk * s * d * itemsize
    k2 = max(3 * product / bf16, (in_bytes + dq_bytes) / bw)
    k3 = max(4 * product / bf16, (in_bytes + dkv_bytes) / bw)
    return k2, k3


def flash_train_step_bound_s(cfg: dict, batch: int, seq: int, peaks) -> float:
    """K1 + K2 + K3 bounds of one training step: every layer once each (the
    save_flash remat keeps K1's outputs, so the replay runs no K1)."""
    h, hk, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                head_dim(cfg))
    k1 = flash_fwd_bound_s(batch, h, hk, seq, d, peaks)
    k2, k3 = flash_bwd_bounds_s(batch, h, hk, seq, d, peaks)
    return cfg["num_hidden_layers"] * (k1 + k2 + k3)


def flash_prefill_bound_s(cfg: dict, prompt_len: int, peaks) -> float:
    """K1's bound over one prompt's prefill (batch 1, every layer)."""
    return cfg["num_hidden_layers"] * flash_fwd_bound_s(
        1, cfg["num_attention_heads"], cfg["num_key_value_heads"],
        prompt_len, head_dim(cfg), peaks)
