"""Weights from the JAX package into the port.

The port keeps the JAX parameter layout (models/llama.py), so a tree from
`tony_tpu.models.llama.llama_init`, with its leaves as numpy arrays
(`jax.device_get`), converts leaf by leaf with `torch.from_numpy`, a dtype
and a device. No leaf is transposed or renamed.

bf16 leaves arrive from numpy as `ml_dtypes.bfloat16`, which torch does not
know. They are carried over by their bits: the array is viewed as int16
and the tensor viewed back as torch.bfloat16, so every value is kept
exactly and nothing passes through f32.

`empty_params` allocates the parameter tree on a device, for a restore
(`train/checkpoint.restore_params`) to fill in place.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.llama import LlamaConfig, Params


def tensor_from_numpy(a: Any, device: torch.device | str) -> torch.Tensor:
    """One leaf: same values, same dtype (bf16 by its bits)."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:       # jax.device_get hands out read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def param_shapes(config: LlamaConfig) -> dict[str, tuple[int, ...]]:
    """{"embed": shape, "layers/wq": shape, ...}: `llama_init`'s leaves."""
    d, f, v = config.dim, config.ffn_dim, config.vocab_size
    L, hd = config.n_layers, config.head_dim
    nh, nkv = config.n_heads, config.n_kv_heads
    return {
        "embed": (v, d), "final_norm": (d,), "output": (d, v),
        "layers/wq": (L, d, nh * hd), "layers/wk": (L, d, nkv * hd),
        "layers/wv": (L, d, nkv * hd), "layers/wo": (L, nh * hd, d),
        "layers/w_gate": (L, d, f), "layers/w_up": (L, d, f),
        "layers/w_down": (L, f, d), "layers/attn_norm": (L, d),
        "layers/mlp_norm": (L, d),
    }


def params_from_jax(tree: dict, config: LlamaConfig,
                    device: torch.device | str = "cuda") -> Params:
    """`llama_init`'s tree of numpy leaves -> the port's parameters on
    `device` (the card unless the caller asks for the CPU; with no card,
    the default raises before any leaf is placed). Checks every leaf's
    shape against `config`."""
    device = resolve_device(str(device))
    want = param_shapes(config)

    def leaf(path: str) -> torch.Tensor:
        node = tree
        for part in path.split("/"):
            node = node[part]
        t = tensor_from_numpy(node, device)
        if tuple(t.shape) != want[path]:
            raise ValueError(f"{path}: shape {tuple(t.shape)}, config "
                             f"wants {want[path]}")
        return t

    return {
        "embed": leaf("embed"),
        "layers": {name.split("/")[1]: leaf(name)
                   for name in want if name.startswith("layers/")},
        "final_norm": leaf("final_norm"),
        "output": leaf("output"),
    }


def empty_params(config: LlamaConfig,
                 device: torch.device | str = "cuda") -> Params:
    """The parameter tree of `config`, uninitialised, on `device`, in
    `llama_init`'s layout and dtypes (norms f32, the rest config.dtype)."""
    device = resolve_device(str(device))
    want = param_shapes(config)

    def empty(path: str) -> torch.Tensor:
        dtype = torch.float32 if path.endswith("norm") else config.dtype
        return torch.empty(want[path], dtype=dtype, device=device)

    return {
        "embed": empty("embed"),
        "layers": {name.split("/")[1]: empty(name)
                   for name in want if name.startswith("layers/")},
        "final_norm": empty("final_norm"),
        "output": empty("output"),
    }
