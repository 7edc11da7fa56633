"""The system under test as the benchmark builds it: a configuration file's
published keys as the port's `LlamaConfig` or `MoEConfig`, no preset
edited. The only module of the benchmark's own that maps sizes onto the
port; the reference reads the same file without it.
"""

from __future__ import annotations

import torch


def port_config(cfg: dict, **overrides):
    """The port's config for a configuration file (`cfg`), with the cell's
    training or serving settings as `overrides`."""
    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.models.moe import MoEConfig

    fields = dict(
        vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        ffn_dim=cfg["intermediate_size"],
        max_seq=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        dtype=getattr(torch, cfg.get("torch_dtype", "bfloat16")))
    if cfg.get("num_local_experts"):
        fields.update(n_experts=cfg["num_local_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      aux_loss_weight=cfg["router_aux_loss_coef"],
                      capacity_factor=cfg["assumed"]["capacity_factor"])
        fields.update(overrides)
        return MoEConfig(**fields)
    fields.update(overrides)
    return LlamaConfig(**fields)


def serving_config(cfg: dict):
    """The served config: an MoE at no-drop capacity, max(cf, E / k), as
    `python -m tony_tpu_torch.serve` serves one."""
    config = port_config(cfg)
    if getattr(config, "n_experts", 0):
        from dataclasses import replace
        config = replace(config, capacity_factor=max(
            config.capacity_factor, config.n_experts / config.top_k))
    return config
