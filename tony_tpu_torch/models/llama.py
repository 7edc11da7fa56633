"""Llama-family transformer, forward and training loss, in PyTorch.

Counterpart of `tony_tpu/models/llama.py`:

- **The JAX parameter layout, kept**: a dict with the same tree as
  `llama_init` there. Per-layer weights are stacked on a leading axis as
  (L, in, out) and applied as `x @ w`; the embedding table is (V, D) and
  `output` is (D, V). A JAX parameter tree therefore converts by dtype and
  device alone (`models/convert.py`).
- **A Python loop over layers** takes the place of `lax.scan`. Under
  autograd each block runs inside `torch.utils.checkpoint` when
  `config.remat` is set: `remat_policy="save_flash"` keeps exactly the
  flash forward's two outputs (a selective-checkpoint policy on that one
  operator), so the replay never re-runs the flash kernel; `"full"` keeps
  nothing. There is no ring or pipeline path in this slice.
- **Stacked weights, per-layer gradients**: the stacked (L, in, out) layout
  stays (`convert.py` and serving read it), but a differentiable pass does
  not slice it with `w[i]`: backprop through L such views runs L
  `select_backward`s, each a full (L, in, out) zero tensor added into the
  gradient. `layer_params_for_grad` instead hands each layer leaves that
  view the stacked storage, whose `.grad` is preset to the matching slice
  of one stacked gradient buffer, so autograd accumulates each layer's
  gradient in place into its slice.
- **bf16 weights, f32 statistics**: RMSNorm and attention keep their
  statistics in f32 (the kernels in `ops/`); the logits are f32
  (`ops/xent.py`'s `matmul_f32`). The large matrix products stay
  `torch.matmul`, as the JAX package left them to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from tony_tpu_torch.ops.attention import flash_attention
from tony_tpu_torch.ops.rmsnorm import rms_norm
from tony_tpu_torch.ops.rope import apply_rope, rope_frequencies
from tony_tpu_torch.ops.xent import fused_cross_entropy, matmul_f32

Params = dict[str, Any]

# The JAX package's MoE presets (tony_tpu/models/moe.py): served there, not
# yet here.
MOE_PRESETS = ("moe_tiny", "mixtral_proxy")


def _save_flash_policy(ctx, op, *args, **kwargs):
    """Keep the flash forward's (out, lse); recompute everything else."""
    if op is torch.ops.tony_tpu_torch.flash_fwd.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    max_seq: int = 8192
    rope_theta: float = 500_000.0
    # Llama-3.1-style long-context RoPE rescale (ops/rope.py); 0 = off
    rope_scaling_factor: float = 0.0
    # pretrained context window the rescale anchors to; 0 = max_seq
    rope_orig_max_seq: int = 0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # training-side fields (the serving path reads none of them)
    remat: bool = True
    remat_policy: str = "save_flash"
    sp_mode: str = "ring"
    xent_chunk: int = 0

    def __post_init__(self):
        if self.remat_policy not in ("save_flash", "full"):
            raise ValueError(
                f"remat_policy must be 'save_flash' or 'full', got "
                f"{self.remat_policy!r}")

    def checkpoint_policy(self):
        """The `context_fn` of `torch.utils.checkpoint` for this config
        (None = save nothing), the counterpart of the JAX config's
        `save_only_these_names("flash_out", "flash_lse")`."""
        if self.remat_policy == "save_flash":
            return partial(create_selective_checkpoint_contexts,
                           _save_flash_policy)
        return None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Approx training FLOPs/token (fwd+bwd ≈ 6N + attention term)."""
        n = self.num_params()
        s = seq_len or self.max_seq
        attn = 12 * self.n_layers * self.dim * s  # causal: ~half of 2*2*3
        return 6.0 * n + attn

    def num_params(self) -> int:
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
        return v * d + self.n_layers * per_layer + d + d * v


PRESETS = {
    "llama3_8b": LlamaConfig(xent_chunk=1024),
    "llama3_70b": LlamaConfig(dim=8192, n_layers=80, n_heads=64,
                              n_kv_heads=8, ffn_dim=28_672,
                              xent_chunk=1024),
    "llama3_1b_proxy": LlamaConfig(vocab_size=32_000, dim=2048, n_layers=16,
                                   n_heads=16, n_kv_heads=8, ffn_dim=8192,
                                   max_seq=4096, xent_chunk=1024),
    "bench_350m": LlamaConfig(vocab_size=32_000, dim=1024, n_layers=16,
                              n_heads=16, n_kv_heads=8, ffn_dim=4096,
                              max_seq=2048, xent_chunk=1024),
    "tiny": LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=128, max_seq=128,
                        dtype=torch.float32, remat=False),
}


def get_config(name: str, **overrides) -> LlamaConfig:
    if name in MOE_PRESETS:
        raise NotImplementedError(
            f"{name} is a mixture-of-experts preset; MoE models arrive in "
            f"the port's later models slice (queue 1 of ROADMAP.md)")
    return replace(PRESETS[name], **overrides)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def llama_init(config: LlamaConfig, generator: torch.Generator) -> Params:
    """Scaled-normal init on the generator's device; per-layer weights
    stacked on a leading axis. The draws are f32, then cast to
    config.dtype. The same seed gives other numbers than the JAX
    package's init (another generator): weights move between the packages
    through `models/convert.py`."""
    d, f = config.dim, config.ffn_dim
    hd, nh, nkv = config.head_dim, config.n_heads, config.n_kv_heads
    L = config.n_layers
    device = generator.device

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(config.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    scale_in = d ** -0.5
    scale_ffn = f ** -0.5
    embed = normal((config.vocab_size, d), 1.0)
    layers = {
        "wq": normal((L, d, nh * hd), scale_in),
        "wk": normal((L, d, nkv * hd), scale_in),
        "wv": normal((L, d, nkv * hd), scale_in),
        "wo": normal((L, nh * hd, d), scale_in),
        "w_gate": normal((L, d, f), scale_in),
        "w_up": normal((L, d, f), scale_in),
        "w_down": normal((L, f, d), scale_ffn),
        "attn_norm": ones((L, d)),
        "mlp_norm": ones((L, d)),
    }
    return {"embed": embed, "layers": layers, "final_norm": ones((d,)),
            "output": normal((d, config.vocab_size), scale_in)}


def layer_params(params: Params, i: int) -> Params:
    """Layer i's weights: views into the stacked tensors, no copy."""
    return {name: w[i] for name, w in params["layers"].items()}


def layer_params_for_grad(params: Params) -> list[Params]:
    """Every layer's weights. A stacked weight that requires grad, with
    grad mode on, gets a stacked `.grad` buffer (zeros, unless one is
    there to accumulate into), and each layer gets a leaf that views its
    slice of the weight with `.grad` preset to the same slice of that
    buffer: autograd then adds the layer's gradient in place into the
    slice (AccumulateGrad adds into a defined `.grad`), and nothing is
    summed over the stack. The stacked weight itself stays out of the
    graph; its `.grad` is the gradient. Any other weight (inference,
    frozen weights) hands each layer its plain `w[i]` view."""
    n = next(iter(params["layers"].values())).shape[0]
    layers: list[Params] = [{} for _ in range(n)]
    grad_mode = torch.is_grad_enabled()
    for name, w in params["layers"].items():
        if not (grad_mode and w.requires_grad):
            for i in range(n):
                layers[i][name] = w[i]
            continue
        if w.grad is None:
            w.grad = torch.zeros_like(w)
        base = w.detach()
        for i in range(n):
            leaf = base[i].requires_grad_()
            leaf.grad = w.grad[i]
            layers[i][name] = leaf
    return layers


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def rope_tables(config: LlamaConfig, seq: int,
                device: Optional[torch.device] = None):
    """(cos, sin) tables honoring the config's theta and long-context
    scaling."""
    return rope_frequencies(
        config.head_dim, seq, config.rope_theta,
        scaling_factor=config.rope_scaling_factor,
        orig_max_seq=config.rope_orig_max_seq or config.max_seq,
        device=device)


def qkv_proj(h: torch.Tensor, layer: Params, config: LlamaConfig
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, D) -> q (B,H,S,hd), k/v (B,Hkv,S,hd), pre-RoPE. The results
    are transposed views of (B, S, H, hd) products, not contiguous; the
    flash kernel reads them through their strides."""
    b, s, _ = h.shape
    nh, nkv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    q = (h @ layer["wq"]).view(b, s, nh, hd).transpose(1, 2)
    k = (h @ layer["wk"]).view(b, s, nkv, hd).transpose(1, 2)
    v = (h @ layer["wv"]).view(b, s, nkv, hd).transpose(1, 2)
    return q, k, v


def swiglu_mlp(h: torch.Tensor, layer: Params) -> torch.Tensor:
    """SwiGLU feed-forward."""
    gate = h @ layer["w_gate"]
    up = h @ layer["w_up"]
    return (F.silu(gate) * up) @ layer["w_down"]


def attention_sublayer(h: torch.Tensor, layer: Params, config: LlamaConfig,
                       cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """QKV + RoPE + causal flash attention + output projection."""
    b, s, _ = h.shape
    q, k, v = qkv_proj(h, layer, config)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = flash_attention(q, k, v, True)
    attn = attn.transpose(1, 2).reshape(b, s, config.n_heads
                                        * config.head_dim)
    return attn @ layer["wo"]


def _block(config: LlamaConfig, cos, sin, x: torch.Tensor,
           layer: Params) -> torch.Tensor:
    h = rms_norm(x, layer["attn_norm"], config.norm_eps)
    x = x + attention_sublayer(h, layer, config, cos, sin)
    h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    return x + swiglu_mlp(h, layer)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 config: LlamaConfig) -> torch.Tensor:
    """(V, D) table x (B, S) ids -> (B, S, D) in the compute dtype."""
    return F.embedding(tokens, embed).to(config.dtype)


def llama_hidden(params: Params, tokens: torch.Tensor,
                 config: LlamaConfig) -> torch.Tensor:
    """tokens: (B, S) int -> final-normed hidden states (B, S, dim).
    Weights that take a gradient get per-layer gradient routing and, with
    config.remat, each block checkpointed under
    config.checkpoint_policy()."""
    s = tokens.shape[1]
    cos, sin = rope_tables(config, s, tokens.device)
    x = embed_lookup(params["embed"], tokens, config)
    block = partial(_block, config, cos, sin)
    layers = layer_params_for_grad(params)
    remat_kwargs = None
    if config.remat and any(w.requires_grad for w in layers[0].values()):
        context_fn = config.checkpoint_policy()
        remat_kwargs = {} if context_fn is None else {"context_fn": context_fn}
    for layer in layers:
        if remat_kwargs is None:
            x = block(x, layer)
        else:
            x = checkpoint(block, x, layer, use_reentrant=False,
                           **remat_kwargs)
    return rms_norm(x, params["final_norm"], config.norm_eps)


def llama_forward(params: Params, tokens: torch.Tensor,
                  config: LlamaConfig) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, vocab) in f32."""
    with torch.inference_mode():
        x = llama_hidden(params, tokens, config)
        return matmul_f32(x, params["output"])


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------

def unpack_lm_batch(batch: dict[str, torch.Tensor]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """{'tokens': (B,S+1)} or {'inputs','targets'} -> (inputs, targets)."""
    if "tokens" in batch:
        return batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    return batch["inputs"], batch["targets"]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token CE."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _head_loss(x: torch.Tensor, params: Params, targets: torch.Tensor,
               config: LlamaConfig) -> torch.Tensor:
    """LM head + mean CE on final hidden states; fused and chunked when
    config.xent_chunk > 0 (no full (B, S, V) logits)."""
    if config.xent_chunk > 0:
        return fused_cross_entropy(x, params["output"], targets,
                                   chunk=config.xent_chunk)
    return cross_entropy(matmul_f32(x, params["output"]), targets)


def llama_loss(params: Params, batch: dict[str, torch.Tensor],
               config: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy. batch: {'tokens': (B, S+1)} or
    {'inputs': (B,S), 'targets': (B,S)}."""
    inputs, targets = unpack_lm_batch(batch)
    x = llama_hidden(params, inputs, config)
    return _head_loss(x, params, targets, config)
