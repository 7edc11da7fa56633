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
  nothing.
- **The pipelined loss** (`llama_loss_pipelined`, a mesh with a `pp`
  axis): the embedding, final norm and head run on every pp rank as in
  `llama_loss`; the layers run as pipeline stages
  (`parallel/pipeline.py`), each stage the same blocks, with its own
  RoPE tables, remat policy and, on the stage's mesh without pp, the
  fsdp gathers, local products and sequence parallelism of the plain
  path.
- **Under a mesh** (parameters and batch are DTensors, sharded by
  `llama_param_axes` and `parallel/sharding.py`'s rules) the same code
  runs the global math: each layer weight's fsdp shards are gathered for
  its product, which runs on the local shards (`linear`), the
  `constrain` calls sit where the JAX forward has them, and the kernels,
  RoPE, the embedding lookup and the loss run on each rank's local
  shards. With sp > 1 attention is ring or Ulysses (`config.sp_mode`).
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
- **int8 weights** (`models/quant.py`, inference only): a quantized leaf
  {"int8", "scale"} takes its products through `linear` and `lm_head`,
  which route them to `ops/int8_matmul.py` (the W8A16 kernel K5 at decode
  row counts); a plain tensor leaf takes the same `@` as before.
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

from torch.distributed.tensor import DTensor

from tony_tpu_torch.models.quant import is_qtensor
from tony_tpu_torch.ops.attention import flash_attention
from tony_tpu_torch.ops.int8_matmul import int8_matmul
from tony_tpu_torch.ops.rmsnorm import rms_norm
from tony_tpu_torch.ops.rope import apply_rope, rope_frequencies
from tony_tpu_torch.ops.xent import (
    fused_cross_entropy, loss_over_shards, matmul_f32,
)
from tony_tpu_torch.parallel.mesh import axis_index, axis_size, drop_axis
from tony_tpu_torch.parallel.pipeline import (
    LocalStages, make_pipelined_fn, virtual_stage_layers,
)
from tony_tpu_torch.parallel.ring import ring_attention_sharded
from tony_tpu_torch.parallel.sharding import (
    constrain, gather_for_use, gathered_local, local_matmul,
    logical_to_mesh_axes, splits_dim0, stage_local, to_placements,
    whole_dim0,
)
from tony_tpu_torch.parallel.ulysses import ulysses_attention_sharded

Params = dict[str, Any]


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
    """A dense preset; the MoE presets are `models/moe.get_moe_config`'s
    (the entry points resolve the family with `moe.is_moe_preset`)."""
    return replace(PRESETS[name], **overrides)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def llama_param_axes(config: LlamaConfig) -> Params:
    """Logical sharding axes, the same tree as the params."""
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
            "attn_norm": ("layers", "norm"),
            "mlp_norm": ("layers", "norm"),
        },
        "final_norm": ("norm",),
        "output": ("embed", "vocab"),
    }


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


def _layer_slice(w, i: int):
    """Layer i of a stacked leaf: a view, of both halves of a qtensor."""
    if is_qtensor(w):
        return {"int8": w["int8"][i], "scale": w["scale"][i]}
    return w[i]


def layer_params(params: Params, i: int) -> Params:
    """Layer i's weights: views into the stacked tensors, no copy."""
    return {name: _layer_slice(w, i) for name, w in params["layers"].items()}


def layer_params_for_grad(params: Params) -> list[Params]:
    """Every layer's weights. A stacked weight that requires grad, with
    grad mode on, gets a stacked `.grad` buffer (zeros, unless one is
    there to accumulate into), and each layer gets a leaf that views its
    slice of the weight with `.grad` preset to the same slice of that
    buffer: autograd then adds the layer's gradient in place into the
    slice (AccumulateGrad adds into a defined `.grad`), and nothing is
    summed over the stack. The stacked weight itself stays out of the
    graph; its `.grad` is the gradient. Any other weight (inference,
    frozen weights, int8 weights) hands each layer its plain `w[i]`
    view. A stack split over pp (a mesh with pp > 1 whose loss is not
    pipelined) is gathered whole first, as GSPMD gathers it for the JAX
    package, and each layer takes its slice of that through autograd: an
    index of the split DTensor would gather a copy per layer, and a
    gradient preset on it would never reach the stack. A stack that is
    not a leaf (a parameter gathered whole for a data-parallel loss,
    `sharding.gathered_local`) is unbound through autograd too: autograd
    reads no `.grad` of it."""
    n = params["layers"]["attn_norm"].shape[0]
    layers: list[Params] = [{} for _ in range(n)]
    grad_mode = torch.is_grad_enabled()
    for name, w in params["layers"].items():
        if splits_dim0(w):
            whole = whole_dim0(w)
            for i in range(n):
                layers[i][name] = whole[i]
            continue
        if is_qtensor(w) or not (grad_mode and w.requires_grad):
            for i in range(n):
                layers[i][name] = _layer_slice(w, i)
            continue
        if not w.is_leaf:
            # one unbind, whose backward stacks the layers' gradients
            for i, piece in enumerate(w.unbind(0)):
                layers[i][name] = piece
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


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a layer weight: a plain tensor, or an int8 qtensor whose
    product is `int8_matmul`'s (the result in x's dtype either way)."""
    if is_qtensor(w):
        return int8_matmul(x, w)
    if isinstance(x, DTensor):
        return local_matmul(x, gather_for_use(w))
    return x @ w


def lm_head(x: torch.Tensor, w) -> torch.Tensor:
    """The f32 logits x @ w of the output head, plain or int8."""
    if is_qtensor(w):
        return int8_matmul(x, w, out_f32=True)
    return matmul_f32(x, w)


def qkv_proj(h: torch.Tensor, layer: Params, config: LlamaConfig
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, D) -> q (B,H,S,hd), k/v (B,Hkv,S,hd), pre-RoPE. The results
    are transposed views of (B, S, H, hd) products, not contiguous; the
    flash kernel reads them through their strides."""
    b, s, _ = h.shape
    nh, nkv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    q = linear(h, layer["wq"]).view(b, s, nh, hd).transpose(1, 2)
    k = linear(h, layer["wk"]).view(b, s, nkv, hd).transpose(1, 2)
    v = linear(h, layer["wv"]).view(b, s, nkv, hd).transpose(1, 2)
    return q, k, v


def swiglu_mlp(h: torch.Tensor, layer: Params) -> torch.Tensor:
    """SwiGLU feed-forward."""
    gate = linear(h, layer["w_gate"])
    up = linear(h, layer["w_up"])
    return linear(F.silu(gate) * up, layer["w_down"])


def mlp(h: torch.Tensor, layer: Params, config: LlamaConfig) -> torch.Tensor:
    """The serving stack's MLP, dispatched on the config type: dense
    SwiGLU, or an MoE config's expert MLP with its aux loss dropped (a
    training concern). The counterpart of `tony_tpu/models/generate.py`'s
    `_mlp`: each call routes its own tokens, so below no-drop capacity a
    decode step's queues overflow where the training forward's do not
    (`generate._warn_moe_below_capacity`)."""
    if getattr(config, "n_experts", 0):
        from tony_tpu_torch.models.moe import moe_mlp
        out, _aux = moe_mlp(h, layer, config)
        return out
    return swiglu_mlp(h, layer)


def _attention_dispatch(q, k, v, config: LlamaConfig):
    """Sequence-parallel attention (ring or Ulysses per config.sp_mode)
    when the mesh splits the sequence over sp > 1 ranks, flash attention
    otherwise (on each rank's batch and head shards under a mesh).
    Ulysses broadcasts the GQA groups on each rank; the ring streams the
    narrow K/V, so its rotations carry 1/group of the broadcast bytes."""
    if isinstance(q, DTensor) and axis_size(q.device_mesh, "sp") > 1:
        if config.sp_mode == "ulysses":
            return ulysses_attention_sharded(q, k, v, causal=True)
        return ring_attention_sharded(q, k, v, causal=True)
    return flash_attention(q, k, v, True)


def attention_sublayer(h: torch.Tensor, layer: Params, config: LlamaConfig,
                       cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """QKV + RoPE + causal flash attention + output projection."""
    b, s, _ = h.shape
    q, k, v = qkv_proj(h, layer, config)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = constrain(q, ("batch", "heads", "seq", None))
    k = constrain(k, ("batch", "kv_heads", "seq", None))
    v = constrain(v, ("batch", "kv_heads", "seq", None))
    attn = _attention_dispatch(q, k, v, config)
    attn = attn.transpose(1, 2).reshape(b, s, config.n_heads
                                        * config.head_dim)
    return linear(attn, layer["wo"])


def _block(config: LlamaConfig, cos, sin, x: torch.Tensor,
           layer: Params) -> torch.Tensor:
    h = rms_norm(x, layer["attn_norm"], config.norm_eps)
    x = x + attention_sublayer(h, layer, config, cos, sin)
    x = constrain(x, ("batch", "seq", None))
    h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    # swiglu_mlp inlined, so the mid-activation constraint can sit between
    # its products as in the JAX block
    gate = linear(h, layer["w_gate"])
    up = linear(h, layer["w_up"])
    ff = F.silu(gate) * up
    ff = constrain(ff, ("batch", "seq", "mlp"))
    x = x + linear(ff, layer["w_down"])
    return constrain(x, ("batch", "seq", None))


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 config: LlamaConfig) -> torch.Tensor:
    """(V, D) table x (B, S) ids -> (B, S, D) in the compute dtype. Under
    a mesh each rank looks its own tokens up in the whole table (the
    FSDP gather of the table), and the table's gradient sums over the
    ranks' tokens."""
    if isinstance(tokens, DTensor):
        tokens = constrain(tokens, ("batch", "seq"))
        x = F.embedding(tokens.to_local(), gathered_local(embed, tokens))
        return DTensor.from_local(x.to(config.dtype), tokens.device_mesh,
                                  tokens.placements, run_check=False)
    return F.embedding(tokens, embed).to(config.dtype)


def layer_blocks(params: Params, config: LlamaConfig, block):
    """(run, layers): every layer's weights (`layer_params_for_grad`) and
    `run(x, layer)`, which calls `block(x, layer)`, inside
    `torch.utils.checkpoint` under config.checkpoint_policy() when
    config.remat is set and the weights take a gradient. The per-layer
    loop of `llama_hidden` and `moe.moe_hidden`."""
    layers = layer_params_for_grad(params)
    if not (config.remat and any(isinstance(w, torch.Tensor)
                                 and w.requires_grad
                                 for w in layers[0].values())):
        return block, layers
    context_fn = config.checkpoint_policy()
    kwargs = {} if context_fn is None else {"context_fn": context_fn}

    def run(x, layer):
        return checkpoint(block, x, layer, use_reentrant=False, **kwargs)
    return run, layers


def llama_hidden(params: Params, tokens: torch.Tensor,
                 config: LlamaConfig) -> torch.Tensor:
    """tokens: (B, S) int -> final-normed hidden states (B, S, dim).
    Weights that take a gradient get per-layer gradient routing and, with
    config.remat, each block checkpointed under
    config.checkpoint_policy()."""
    s = tokens.shape[1]
    cos, sin = rope_tables(config, s, tokens.device)
    x = embed_lookup(params["embed"], tokens, config)
    run, layers = layer_blocks(params, config,
                               partial(_block, config, cos, sin))
    for layer in layers:
        x = run(x, layer)
    return rms_norm(x, params["final_norm"], config.norm_eps)


def llama_forward(params: Params, tokens: torch.Tensor,
                  config: LlamaConfig) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, vocab) in f32."""
    with torch.inference_mode():
        x = llama_hidden(params, tokens, config)
        return lm_head(x, params["output"])


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
    if isinstance(x, DTensor):
        return loss_over_shards(
            lambda x_, w_, t_: _head_loss(x_, {"output": w_}, t_, config),
            x, params["output"], targets)
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


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------

def llama_pipeline_param_axes(config: LlamaConfig) -> Params:
    """Logical axes of the STAGED layer tree ((pp, L/pp, ...) layout): the
    stage dim on pp, the inner dims keeping their fsdp/tp layout."""
    return {k: ("stage",) + tuple(v)
            for k, v in llama_param_axes(config)["layers"].items()}


def _pipeline_stage(config: LlamaConfig, seq: int, inner):
    """(stage_fn, wrap): the per-tick stage body over a chunk's layers
    and the form a local chunk takes for it. On a stage mesh (`inner`,
    the mesh without pp) chunks and activations are DTensors there, so
    the blocks run exactly as `llama_hidden`'s; without one, plain
    tensors."""
    staged = llama_pipeline_param_axes(config)
    act = (logical_to_mesh_axes(("batch", "seq", None), mesh=inner)
           if inner is not None else None)

    def wrap(name, t):
        if inner is None:
            return t
        return DTensor.from_local(
            t, inner, logical_to_mesh_axes(staged[name][1:], mesh=inner),
            run_check=False)

    def stage_fn(layers: Params, x_local: torch.Tensor) -> torch.Tensor:
        # the stage's own RoPE tables (at global positions: a DTensor's
        # rows are its sequence shard's)
        cos, sin = rope_tables(config, seq, x_local.device)
        x = x_local if inner is None else DTensor.from_local(
            x_local, inner, act, run_check=False)
        run, per_layer = layer_blocks({"layers": layers}, config,
                                      partial(_block, config, cos, sin))
        for layer in per_layer:
            x = run(x, layer)
        return x if inner is None else to_placements(x, act).to_local()

    return stage_fn, wrap


def llama_hidden_pipelined(params: Params, tokens: torch.Tensor,
                           config: LlamaConfig, mesh, n_micro: int,
                           n_virtual: int = 1) -> torch.Tensor:
    """The pipeline-parallel backbone up to the final norm (the head is
    the caller's). `mesh`: the run's DeviceMesh (its pp axis; absent or
    None: one stage), or `pipeline.LocalStages(n)` for n stages in this
    process on plain tensors. The layers split into pp * n_virtual
    chunks of consecutive layers, chunk j of pp rank d being virtual
    stage j * pp + d; embedding, final norm and head run on every pp
    rank. Needs n_layers % (pp * n_virtual) == 0 and each rank's batch
    rows % n_micro == 0."""
    local = isinstance(mesh, LocalStages)
    pp = mesh.n if local else axis_size(mesh, "pp")
    L = config.n_layers
    if L % (pp * n_virtual) != 0:
        raise ValueError(f"n_layers {L} not divisible by "
                         f"pp*n_virtual={pp}*{n_virtual}")
    per_chunk = L // (pp * n_virtual)
    x = embed_lookup(params["embed"], tokens, config)
    sharded = isinstance(x, DTensor)
    pp_dim = (mesh.mesh_dim_names.index("pp") if sharded
              and "pp" in mesh.mesh_dim_names else None)
    devices = range(pp) if local else (axis_index(mesh, "pp"),)
    per_device = [{k: stage_local(w, pp_dim, pp, virtual_stage_layers(
        d, pp, n_virtual, per_chunk)) for k, w in params["layers"].items()}
        for d in devices]
    stage_fn, wrap = _pipeline_stage(
        config, tokens.shape[1], drop_axis(mesh, "pp") if sharded else None)
    pipe = make_pipelined_fn(stage_fn, mesh, n_micro, n_virtual=n_virtual,
                             wrap=wrap)
    if sharded:
        x = constrain(x, ("batch", "seq", None))
        y = DTensor.from_local(pipe(per_device, x.to_local()),
                               x.device_mesh, x.placements,
                               run_check=False)
    else:
        y = pipe(per_device, x)
    return rms_norm(y, params["final_norm"], config.norm_eps)


def llama_forward_pipelined(params: Params, tokens: torch.Tensor,
                            config: LlamaConfig, mesh, n_micro: int,
                            n_virtual: int = 1) -> torch.Tensor:
    """The pipelined forward -> logits (B, S, vocab) f32."""
    with torch.no_grad():
        x = llama_hidden_pipelined(params, tokens, config, mesh, n_micro,
                                   n_virtual=n_virtual)
        return lm_head(x, params["output"])


def llama_loss_pipelined(params: Params, batch: dict[str, torch.Tensor],
                         config: LlamaConfig, mesh, n_micro: int,
                         n_virtual: int = 1) -> torch.Tensor:
    """`llama_loss` through the pipelined backbone."""
    inputs, targets = unpack_lm_batch(batch)
    x = llama_hidden_pipelined(params, inputs, config, mesh, n_micro,
                               n_virtual=n_virtual)
    return _head_loss(x, params, targets, config)
