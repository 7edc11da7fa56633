"""Weights made from the seed on the device, in the layout the port serves
and trains: a dict with per-layer leaves stacked on a leading axis as
(L, in, out), the embedding (V, D), the head (D, V), the norms' f32 ones,
and for an MoE the router (L, D, E) and the expert banks (L, E, D, F) and
(L, E, F, D).

One `normal_` call a stacked leaf, drawn straight into bf16 on the device
from one `torch.Generator` seeded by the run's seed, at the port's
scaled-normal widths (`llama_init`/`moe_init`: in-dim ** -0.5). The same
seed gives the same bits, so the program and the reference each build
their own copy and share nothing. Imports nothing of the program.
"""

from __future__ import annotations

import torch

# torch.Generator takes seeds below 2**64; a run's seed is any whole number
SEED_MODULUS = 2 ** 63


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg.get("torch_dtype", "bfloat16"))


def leaf_shapes(cfg: dict) -> dict:
    """{path: (shape, scale)} of every leaf that is drawn, in draw order;
    the norms (ones) are not drawn."""
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    L = cfg["num_hidden_layers"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // nh
    e = int(cfg.get("num_local_experts", 0) or 0)
    shapes = {
        "embed": ((v, d), 1.0),
        "layers/wq": ((L, d, nh * hd), d ** -0.5),
        "layers/wk": ((L, d, nkv * hd), d ** -0.5),
        "layers/wv": ((L, d, nkv * hd), d ** -0.5),
        "layers/wo": ((L, nh * hd, d), d ** -0.5),
    }
    if e:
        shapes["layers/router"] = ((L, d, e), d ** -0.5)
        shapes["layers/we_gate"] = ((L, e, d, f), d ** -0.5)
        shapes["layers/we_up"] = ((L, e, d, f), d ** -0.5)
        shapes["layers/we_down"] = ((L, e, f, d), f ** -0.5)
    else:
        shapes["layers/w_gate"] = ((L, d, f), d ** -0.5)
        shapes["layers/w_up"] = ((L, d, f), d ** -0.5)
        shapes["layers/w_down"] = ((L, f, d), f ** -0.5)
    shapes["output"] = ((d, v), d ** -0.5)
    return shapes


def drawn_leaves(cfg: dict, seed: int, device):
    """(path, leaf) of every drawn leaf in draw order, one at a time: what
    `make_params` holds, for a reader that wants one leaf at once."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(
        int(seed) % SEED_MODULUS)
    dtype = dtype_of(cfg)
    for path, (shape, scale) in leaf_shapes(cfg).items():
        leaf = torch.empty(shape, dtype=dtype, device=device)
        leaf.normal_(0.0, scale, generator=gen)
        yield path, leaf


def make_params(cfg: dict, seed: int, device) -> dict:
    """The model's weights from `seed`, on `device`."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    params: dict = {"layers": {}}
    for path, leaf in drawn_leaves(cfg, seed, device):
        if path.startswith("layers/"):
            params["layers"][path.split("/", 1)[1]] = leaf
        else:
            params[path] = leaf
    for name in ("attn_norm", "mlp_norm"):
        params["layers"][name] = torch.ones((L, d), dtype=torch.float32,
                                            device=device)
    params["final_norm"] = torch.ones((d,), dtype=torch.float32,
                                      device=device)
    # the port's leaf order (llama_init's tree)
    return {k: params[k] for k in ("embed", "layers", "final_norm",
                                   "output")}


def leaf_paths(params: dict) -> list[str]:
    """'embed', 'layers/wq', ... of a parameter dict."""
    out = []
    for k, v in params.items():
        if isinstance(v, dict):
            out.extend(f"{k}/{kk}" for kk in v)
        else:
            out.append(k)
    return out


def get_leaf(params: dict, path: str) -> torch.Tensor:
    node = params
    for part in path.split("/"):
        node = node[part]
    return node
