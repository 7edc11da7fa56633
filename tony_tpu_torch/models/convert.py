"""Weights from the JAX package into the port.

The port keeps the JAX parameter layout (models/llama.py), so a tree from
`tony_tpu.models.llama.llama_init`, with its leaves as numpy arrays
(`jax.device_get`), converts leaf by leaf with `torch.from_numpy`, a dtype
and a device. No leaf is transposed or renamed.

bf16 leaves arrive from numpy as `ml_dtypes.bfloat16`, which torch does not
know. They are carried over by their bits: the array is viewed as int16
and the tensor viewed back as torch.bfloat16, so every value is kept
exactly and nothing passes through f32.

An int8 tree (`tony_tpu.models.quant.quantize_params`) converts too: each
quantized leaf {"int8", "scale"} keeps its int8 values and f32 scales, the
port's own qtensor (`models/quant.py`). So does an MoE tree
(`tony_tpu.models.moe.moe_init`, an `MoEConfig`): the router and expert
banks in place of the dense MLP.

`empty_params` allocates the parameter tree on a device, for a restore
(`train/checkpoint.restore_params`) to fill in place.

The image zoo and the small models (`vit_init`, `resnet_init` with its
list of stages of blocks, `mnist_init`, `linreg_init`) convert through
`tree_from_jax`: the same nested dicts and lists, leaf by leaf, checked
against a port tree of the same model when one is given.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.llama import LlamaConfig, Params
from tony_tpu_torch.models.quant import is_qtensor


def tensor_from_numpy(a: Any, device: torch.device | str) -> torch.Tensor:
    """One leaf: same values, same dtype (bf16 by its bits)."""
    a = np.asarray(a)
    a = np.ascontiguousarray(a).reshape(a.shape)   # a 0-d leaf stays 0-d
    if not a.flags.writeable:       # jax.device_get hands out read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def param_shapes(config: LlamaConfig) -> dict[str, tuple[int, ...]]:
    """{"embed": shape, "layers/wq": shape, ...}: `llama_init`'s leaves,
    or `moe_init`'s for an MoE config."""
    d, f, v = config.dim, config.ffn_dim, config.vocab_size
    L, hd = config.n_layers, config.head_dim
    nh, nkv = config.n_heads, config.n_kv_heads
    # in the inits' order of the layer keys, which `tree_leaves` keeps
    shapes = {
        "embed": (v, d), "final_norm": (d,), "output": (d, v),
        "layers/wq": (L, d, nh * hd), "layers/wk": (L, d, nkv * hd),
        "layers/wv": (L, d, nkv * hd), "layers/wo": (L, nh * hd, d),
    }
    E = getattr(config, "n_experts", 0)
    if not E:
        shapes.update({"layers/w_gate": (L, d, f), "layers/w_up": (L, d, f),
                       "layers/w_down": (L, f, d)})
    shapes.update({"layers/attn_norm": (L, d), "layers/mlp_norm": (L, d)})
    if E:
        shapes.update({
            "layers/router": (L, d, E), "layers/we_gate": (L, E, d, f),
            "layers/we_up": (L, E, d, f), "layers/we_down": (L, E, f, d)})
    return shapes


def params_from_jax(tree: dict, config: LlamaConfig,
                    device: torch.device | str = "cuda") -> Params:
    """`llama_init`'s (or `moe_init`'s) tree of numpy leaves -> the port's
    parameters on `device` (the card unless the caller asks for the CPU;
    with no card, the default raises before any leaf is placed). Checks
    every leaf's shape against `config`."""
    device = resolve_device(str(device))
    want = param_shapes(config)

    def check(path: str, t: torch.Tensor, shape: tuple) -> torch.Tensor:
        if tuple(t.shape) != shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)}, config "
                             f"wants {shape}")
        return t

    def leaf(path: str):
        node = tree
        for part in path.split("/"):
            node = node[part]
        if is_qtensor(node):
            shape = want[path]
            return {"int8": check(path, tensor_from_numpy(
                        node["int8"], device), shape),
                    "scale": check(path + " scale", tensor_from_numpy(
                        node["scale"], device),
                        shape[:-2] + (1, shape[-1]))}
        return check(path, tensor_from_numpy(node, device), want[path])

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
    `llama_init`'s (or `moe_init`'s) layout and dtypes (norms f32, the
    rest config.dtype)."""
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


def tree_from_jax(tree: Any, device: torch.device | str = "cuda",
                  like: Any = None) -> Any:
    """A tree of numpy leaves in nested dicts and lists (ViT, ResNet with
    its list of stages of blocks, the MNIST MLP, linear regression) ->
    the same tree of tensors on `device`, names, shapes, layouts and
    dtypes kept (bf16 by its bits). With `like` (a port tree of the same
    model, e.g. its init) the keys, list lengths, shapes and dtypes are
    checked leaf by leaf."""
    device = resolve_device(str(device))

    def convert(node, ref, path: str):
        if isinstance(node, dict):
            if ref is not None and set(ref) != set(node):
                raise ValueError(f"{path or 'tree'}: keys {sorted(node)}, "
                                 f"the port's {sorted(ref)}")
            return {k: convert(v, None if ref is None else ref[k],
                               f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if ref is not None and len(ref) != len(node):
                raise ValueError(f"{path}: {len(node)} entries, the "
                                 f"port's {len(ref)}")
            return [convert(v, None if ref is None else ref[i],
                            f"{path}/{i}") for i, v in enumerate(node)]
        t = tensor_from_numpy(node, device)
        if ref is not None and (tuple(t.shape) != tuple(ref.shape)
                                or t.dtype != ref.dtype):
            raise ValueError(f"{path}: {t.dtype} {tuple(t.shape)}, the "
                             f"port's {ref.dtype} {tuple(ref.shape)}")
        return t

    return convert(tree, like, "")
