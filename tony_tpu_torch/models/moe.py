"""Mixture-of-experts Llama, forward and training loss, in PyTorch.

Counterpart of `tony_tpu/models/moe.py`: the Llama block with its dense
SwiGLU MLP swapped for a router and `n_experts` SwiGLU expert banks, of
which each token takes its `top_k` choices.

- **Routing** as in the JAX package, step for step: f32 router logits
  (the product made in IEEE f32 on the card whatever the TF32 setting:
  a near-tie summed as TF32 flips a choice, and the output then differs
  by a whole expert), softmax, `top_k` first-index argmaxes one expert at
  a time, the gates renormalised, each token's queue position in each
  expert by a cumsum over tokens, and a token dropped from an expert whose
  queue holds `capacity = max(1, int(cf * T * k / E))` before it.
- **Sparse dispatch** (the default): each kept (token, choice) owns the
  slot `expert * C + pos`; the slot -> token map is built by plain writes
  (dropped choices all write the sentinel slot `E * C`, whose value is
  never read, so which write wins there does not matter), one gather
  feeds the expert banks and one gather of the k choices' rows from the
  expert outputs, with a zero sentinel row, combines them. Each gather's
  backward is a gather through the inverse map (a token's k slots; a
  slot's one choice), summed in a fixed order: no atomics, and no run of
  the empty slots' duplicate index on one warp.
- **Dense dispatch** (`dispatch_mode="dense"`): the one-hot dispatch and
  combine products, the same routing.
- **The expert banks' products** are batched products over the experts
  (`torch.bmm`), as the JAX package leaves them to XLA; an int8 bank
  (`models/quant.py`) takes one `ops/int8_matmul.py` `int8_bmm` a bank,
  so one K5 launch a bank at decode row counts.
- **Switch aux loss** over the choices before capacity, summed over the
  layers; `moe_loss` adds `aux_loss_weight` times it to the LM loss.
- **Counters**: each call adds the rows its banks execute (E * C) and
  the rows routed to them (T * k, the global T under a mesh) to the
  health registry (`count_expert_rows`), from host integers.
- **Under a mesh** (`moe_param_axes`: the expert dim over `ep`, embed
  and mlp over fsdp and tp, the router at ("layers", "embed", None)) the
  MLP routes the GLOBAL token set, as the JAX package's `moe_mlp` does
  over the batch and sequence it sees whole: each rank gathers every
  rank's tokens (over dp, fsdp and sp), so the capacity comes from the
  global T, each token's queue position is its place in global token
  order, every expert's queue fills from every batch rank's tokens, and
  the aux loss is the mean over the global T. A routing per rank would
  drop other tokens below no-drop capacity and train another model.
  Each ep rank runs its E / ep experts' products over every slot of
  those experts (tp: its columns, the down product summed over tp), and
  the bank outputs are gathered over ep for the combine. The work after
  the gather is the same on every data rank (the JAX package leaves the
  expert bank unsplit over the batch axes too), so each rank keeps its
  own tokens' rows of the output, and the gradients of everything the
  ranks share are whole on each.

The attention, RoPE, norms, per-layer loop (`layer_blocks`: per-layer
gradients, save_flash remat) and LM head are `models/llama.py`'s.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace
from functools import partial
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from tony_tpu_torch.models.llama import (
    LlamaConfig, Params, _head_loss, attention_sublayer, embed_lookup,
    layer_blocks, llama_init, llama_param_axes, lm_head, rope_tables,
    unpack_lm_batch,
)
from tony_tpu_torch.models.quant import is_qtensor
from tony_tpu_torch.observability.metrics import REGISTRY
from tony_tpu_torch.ops.int8_matmul import int8_bmm
from tony_tpu_torch.ops.rmsnorm import rms_norm
from tony_tpu_torch.parallel.mesh import axis_index, axis_size
from tony_tpu_torch.parallel.sharding import constrain, gather_for_use


@dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # "sparse": slot-indexed gathers; "dense": one-hot products
    dispatch_mode: str = "sparse"

    def __post_init__(self):
        super().__post_init__()
        if self.dispatch_mode not in ("sparse", "dense"):
            raise ValueError(
                f"dispatch_mode must be 'sparse' or 'dense', got "
                f"{self.dispatch_mode!r}")

    def num_params(self) -> int:
        """The dense count with the one SwiGLU MLP per layer swapped for
        `n_experts` of them and the router."""
        d, f, L, E = self.dim, self.ffn_dim, self.n_layers, self.n_experts
        return super().num_params() + L * ((E - 1) * 3 * d * f + d * E)

    def active_params(self) -> int:
        """The parameters a token touches: `top_k` of the expert MLPs and
        the router beside the dense rest."""
        d, f, L = self.dim, self.ffn_dim, self.n_layers
        return super().num_params() + L * ((self.top_k - 1) * 3 * d * f
                                           + d * self.n_experts)

    def flops_per_token(self, seq_len=None) -> float:
        """Training FLOPs per token on the active parameters (6 N_active
        plus the attention term): what MFU is reckoned on."""
        s = seq_len or self.max_seq
        return 6.0 * self.active_params() + 12 * self.n_layers * self.dim * s


PRESETS = {
    "moe_tiny": MoEConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, ffn_dim=128, max_seq=128,
                          dtype=torch.float32, remat=False, n_experts=4,
                          top_k=2),
    "mixtral_proxy": MoEConfig(vocab_size=32_000, dim=2048, n_layers=16,
                               n_heads=16, n_kv_heads=8, ffn_dim=4096,
                               max_seq=4096, n_experts=8, top_k=2,
                               xent_chunk=1024),
}


def get_moe_config(name: str, **overrides) -> MoEConfig:
    return replace(PRESETS[name], **overrides)


def is_moe_preset(name: str) -> bool:
    """Whether `name` is an MoE preset: membership in this registry."""
    return name in PRESETS


# health-registry counters of `count_expert_rows`
EXPERT_ROWS_EXECUTED = "tony_moe_expert_rows_executed_total"
EXPERT_ROWS_ROUTED = "tony_moe_expert_rows_routed_total"


def no_drop_capacity_floor(config: MoEConfig) -> float:
    """The least capacity_factor at which no routing overflows a queue:
    all T * top_k choices fit one expert once cf >= n_experts / top_k."""
    return config.n_experts / config.top_k


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def moe_init(config: MoEConfig, generator: torch.Generator) -> Params:
    """`llama_init`'s tree with the dense MLP swapped for the router
    (L, d, E) and the expert banks we_gate/we_up (L, E, d, f) and we_down
    (L, E, f, d), scaled-normal in config.dtype."""
    params = llama_init(config, generator)
    d, f, L, E = config.dim, config.ffn_dim, config.n_layers, config.n_experts

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * scale).to(config.dtype)

    layers = params["layers"]
    for dense_key in ("w_gate", "w_up", "w_down"):
        del layers[dense_key]
    layers["router"] = normal((L, d, E), d ** -0.5)
    layers["we_gate"] = normal((L, E, d, f), d ** -0.5)
    layers["we_up"] = normal((L, E, d, f), d ** -0.5)
    layers["we_down"] = normal((L, E, f, d), f ** -0.5)
    return params


def moe_param_axes(config: MoEConfig) -> Params:
    """`llama_param_axes` with the dense MLP swapped for the router
    ("layers", "embed", None) and the expert banks, whose expert dim is
    the `ep` axis's."""
    axes = llama_param_axes(config)
    layers = dict(axes["layers"])
    for dense_key in ("w_gate", "w_up", "w_down"):
        del layers[dense_key]
    layers["router"] = ("layers", "embed", None)
    layers["we_gate"] = ("layers", "expert", "embed", "mlp")
    layers["we_up"] = ("layers", "expert", "embed", "mlp")
    layers["we_down"] = ("layers", "expert", "mlp", "embed")
    axes["layers"] = layers
    return axes


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _ieee_f32():
    """f32 products on the card in IEEE f32 inside the block, whatever
    the process's TF32 setting (restored after)."""
    matmul = torch.backends.cuda.matmul
    if not matmul.allow_tf32:
        yield
        return
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = True


class _RouterLogits(torch.autograd.Function):
    """x (T, d) f32 @ w (d, E) f32, forward and backward in IEEE f32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _ieee_f32():
            return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _ieee_f32():
            return g @ w.t(), x.t() @ g


def router_logits(xt: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(T, d) tokens, (d, E) router -> (T, E) f32 logits."""
    return _RouterLogits.apply(xt.float(), router.float())


class Routing(NamedTuple):
    probs: torch.Tensor       # (T, E) f32 softmax of the router logits
    gates: torch.Tensor       # (T, E) f32, the top-k renormalised, else 0
    topk_idx: list            # k tensors (T,): the choices, best first
    position: torch.Tensor    # (T, E) int: queue position in each expert
    keep: torch.Tensor        # (T, E) bool: chosen and within capacity
    capacity: int


def route(xt: torch.Tensor, router: torch.Tensor,
          config: MoEConfig) -> Routing:
    """Top-k routing of the tokens xt (T, d) with capacity
    (`tony_tpu/models/moe.py:194-222`)."""
    n_tokens = xt.shape[0]
    E, k = config.n_experts, config.top_k
    capacity = max(1, int(config.capacity_factor * n_tokens * k / E))
    probs = torch.softmax(router_logits(xt, router), dim=-1)
    # one expert at a time, the first index of a tie, as jnp.argmax
    gates = torch.zeros_like(probs)
    masked = probs
    topk_idx = []
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)
        topk_idx.append(idx)
        onehot = F.one_hot(idx, E).to(probs.dtype)
        gates = gates + onehot * probs
        masked = masked * (1.0 - onehot)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    chosen = gates > 0.0
    # the running count down each expert's column, scanned along the
    # contiguous last axis of the (E, T) transpose: on the card a scan
    # down the T rows of an E-column tensor runs on E threads
    position = torch.cumsum(chosen.t().contiguous(), dim=1).t() - 1
    keep = chosen & (position < capacity)
    return Routing(probs, gates, topk_idx, position, keep, capacity)


def aux_loss(r: Routing, config: MoEConfig) -> torch.Tensor:
    """Switch load-balance loss over the choices before capacity; 1.0 for
    perfectly balanced routing."""
    frac_tokens = (r.gates > 0.0).float().mean(dim=0)
    frac_probs = r.probs.mean(dim=0)
    return torch.sum(frac_tokens * frac_probs) * (config.n_experts
                                                  / config.top_k)


# ---------------------------------------------------------------------------
# the expert banks and the dispatch
# ---------------------------------------------------------------------------

def _bank_product(x: torch.Tensor, w) -> torch.Tensor:
    """(E, C, in) x one layer's bank (E, in, out) -> (E, C, out): one
    batched product, an int8 bank's too (`int8_bmm`)."""
    if is_qtensor(w):
        return int8_bmm(x, w)
    return torch.bmm(x, w)


def expert_bank(expert_in: torch.Tensor, layer: Params) -> torch.Tensor:
    """(E, C, D) -> (E, C, D) through each expert's SwiGLU."""
    gate = _bank_product(expert_in, layer["we_gate"])
    up = _bank_product(expert_in, layer["we_up"])
    return _bank_product(F.silu(gate) * up, layer["we_down"])


class _Experts(NamedTuple):
    """The experts this rank's bank runs, [first, first + count), and
    `bank`: their (count, C, D) queues -> every expert's (E, C, D)
    outputs."""
    first: int
    count: int
    bank: Callable[[torch.Tensor], torch.Tensor]


def _all_experts(layer: Params, n_experts: int) -> _Experts:
    return _Experts(0, n_experts, lambda x: expert_bank(x, layer))


def _dense_dispatch(xt: torch.Tensor, r: Routing, dtype: torch.dtype,
                    experts: _Experts) -> torch.Tensor:
    """One-hot dispatch and combine products, (T, E, C) each; the
    dispatch of this rank's experts only."""
    slot = torch.where(r.keep, r.position, 0)
    dispatch = r.keep[..., None] * F.one_hot(slot, r.capacity).to(dtype)
    combine = dispatch * r.gates[..., None].to(dtype)
    own = dispatch[:, experts.first:experts.first + experts.count]
    expert_in = torch.einsum("tec,td->ecd", own, xt)
    return torch.einsum("tec,ecd->td", combine, experts.bank(expert_in))


class _GatherRows(torch.autograd.Function):
    """src[index] by rows, with a backward that gathers too: row j of
    src's gradient is the sum, in the order given, of the output
    gradient's rows inverse[0][j], inverse[1][j], ... (len(index) names
    none: a zero row). A scatter-add backward would add the rows of an
    index taken many times (every empty slot names token 0) one after
    another on one warp, and with atomics in any order."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.inverse = inverse
        return src[index]

    @staticmethod
    def backward(ctx, g):
        ext = torch.cat([g, g.new_zeros((1, *g.shape[1:]))])
        grad = ext[ctx.inverse[0]]
        for inv in ctx.inverse[1:]:
            grad = grad + ext[inv]
        return grad, None, None


def _sparse_dispatch(xt: torch.Tensor, r: Routing, dtype: torch.dtype,
                     experts: _Experts) -> torch.Tensor:
    """Slot-indexed dispatch: (token, choice) -> slot `expert * C + pos`,
    one gather into this rank's banks, one gather of the k choices' rows
    back from every expert's outputs."""
    n_tokens, d = xt.shape
    E, C = r.gates.shape[-1], r.capacity
    k = len(r.topk_idx)
    n_slots = E * C
    sentinel = n_slots                      # dropped choices land here
    device = xt.device
    token_ids = torch.arange(n_tokens, device=device)
    slot_token = torch.zeros(n_slots + 1, dtype=torch.long, device=device)
    slot_valid = torch.zeros(n_slots + 1, dtype=dtype, device=device)
    # slot -> its (choice, token)'s row of the k stacked choices; the
    # empty slots and the sentinel name the zero row k * T
    slot_row = torch.full((n_slots + 1,), k * n_tokens, dtype=torch.long,
                          device=device)
    slots_k = []
    for j, idx in enumerate(r.topk_idx):
        pos_k = r.position.gather(1, idx[:, None])[:, 0]
        keep_k = r.keep.gather(1, idx[:, None])[:, 0]
        slot_k = torch.where(keep_k, idx * C + pos_k, sentinel)
        slots_k.append(slot_k)
        # live slots are unique across the k choices; only the sentinel
        # takes several writes, and it is never read
        slot_token[slot_k] = token_ids
        slot_valid[slot_k] = 1
        slot_row[slot_k] = j * n_tokens + token_ids
    slot_row[sentinel] = k * n_tokens
    lo, n_own = experts.first * C, experts.count * C
    inverse = tuple(slots_k)
    if n_own != n_slots:
        # this rank's slots, renumbered from 0; the others name the zero
        # row n_own of the gather's backward
        inverse = tuple(torch.where((s >= lo) & (s < lo + n_own), s - lo,
                                    n_own) for s in slots_k)
    expert_in = (_GatherRows.apply(xt, slot_token[lo:lo + n_own], inverse)
                 * slot_valid[lo:lo + n_own, None])
    expert_out = experts.bank(expert_in.view(experts.count, C, d))
    flat_out = torch.cat([expert_out.reshape(n_slots, d),
                          expert_out.new_zeros((1, d))])
    picked = _GatherRows.apply(flat_out, torch.cat(slots_k), (slot_row,))
    out = torch.zeros((n_tokens, d), dtype=dtype, device=device)
    for j, idx in enumerate(r.topk_idx):
        gate_k = r.gates.gather(1, idx[:, None])
        rows = picked[j * n_tokens:(j + 1) * n_tokens]
        out = out + gate_k.to(dtype) * rows.to(dtype)
    return out


def moe_mlp(x: torch.Tensor, layer: Params, config: MoEConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss): top-k routing with
    capacity over the B * S tokens, dispatched per config.dispatch_mode.
    A DTensor x (under a mesh) routes the global tokens
    (`_moe_mlp_sharded`)."""
    if isinstance(x, DTensor):
        return _moe_mlp_sharded(x, layer, config)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    r = route(xt, layer["router"], config)
    count_expert_rows(b * s, r.capacity, config)
    out = _dispatch(config)(xt, r, x.dtype,
                            _all_experts(layer, config.n_experts))
    return out.reshape(b, s, d).to(x.dtype), aux_loss(r, config)


def count_expert_rows(n_tokens: int, capacity: int,
                      config: MoEConfig) -> None:
    """Add one call's expert rows to the health registry (`/v1/metrics`),
    from host integers: the rows the banks execute, E * C, and the rows
    routed to them, T * k. Their ratio is the banks' useful share, 1 / cf
    where the capacity divides: a quarter at the serving engine's no-drop
    cf E / k = 4."""
    REGISTRY.counter(EXPERT_ROWS_EXECUTED).inc(config.n_experts * capacity)
    REGISTRY.counter(EXPERT_ROWS_ROUTED).inc(n_tokens * config.top_k)


def _dispatch(config: MoEConfig):
    return (_dense_dispatch if config.dispatch_mode == "dense"
            else _sparse_dispatch)


def _placed(mesh, **by_axis) -> list:
    """One placement per mesh dim: by_axis[name] where given, else
    Replicate()."""
    return [by_axis.get(name, Replicate()) for name in mesh.mesh_dim_names]


def _local_weight(w) -> torch.Tensor:
    """A layer weight with its dp/fsdp shards gathered, as a local tensor
    (its ep and tp shards stay). Every data rank computes the same with
    it, so its gradient is whole on each rank, and the gather's backward
    keeps each rank's own shard of it."""
    w = gather_for_use(w)
    return w.to_local() if isinstance(w, DTensor) else w


def _ep_bank(layer: Params, mesh, first: int, count: int):
    """The bank of this rank's `count` experts from `first`: their SwiGLU
    on their local tp columns, the down product summed over tp, then the
    outputs of every ep rank's experts gathered. The gathered outputs'
    gradient is the same on every ep rank, so the gather's backward keeps
    this rank's experts' rows."""
    tp, ep = axis_size(mesh, "tp") > 1, axis_size(mesh, "ep") > 1
    weights = [_local_weight(layer[k]) for k in ("we_gate", "we_up",
                                                 "we_down")]

    def bank(expert_in: torch.Tensor) -> torch.Tensor:
        gate = _bank_product(expert_in, weights[0])
        up = _bank_product(expert_in, weights[1])
        out = _bank_product(F.silu(gate) * up, weights[2])
        if not (tp or ep):
            return out
        split = {"tp": Partial()} if tp else {}
        if ep:
            split["ep"] = Shard(0)
        return DTensor.from_local(out, mesh, _placed(mesh, **split),
                                  run_check=False).redistribute(
            mesh, _placed(mesh)).to_local()

    return _Experts(first, count, bank)


class _GradSummedOver(torch.autograd.Function):
    """x itself, its gradient summed over the process groups given (each
    rank of them holds a part of it), one all-reduce a group."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


def _grad_summed_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    groups = [mesh.get_group(a) for a in axes if axis_size(mesh, a) > 1]
    return _GradSummedOver.apply(x, groups) if groups else x


def _moe_mlp_sharded(x: DTensor, layer: Params, config: MoEConfig
                     ) -> tuple[DTensor, torch.Tensor]:
    """`moe_mlp` of a DTensor x on its mesh, over the global tokens: x
    gathered whole on every rank (every rank then routes the same T
    tokens, JAX's global order b * S + s), this rank's experts' bank
    (`_ep_bank`), the combine of every token, and this rank's rows of the
    result in x's placements. The aux loss, the same on every rank, is a
    plain tensor."""
    mesh = x.device_mesh
    b, s, d = x.shape
    xt = x.redistribute(mesh, _placed(mesh)).to_local().reshape(b * s, d)
    r = route(xt, _local_weight(layer["router"]), config)
    count_expert_rows(b * s, r.capacity, config)
    ep = axis_size(mesh, "ep")
    count = config.n_experts // ep
    experts = _ep_bank(layer, mesh, axis_index(mesh, "ep") * count, count)
    # the bank's queues read the tokens on each ep rank's experts and on
    # each tp rank's columns: their gradient is summed over both
    xd = _grad_summed_over(xt, mesh, ("ep", "tp"))
    out = _dispatch(config)(xd, r, x.dtype, experts)
    out = DTensor.from_local(out.reshape(b, s, d).to(x.dtype), mesh,
                             _placed(mesh), run_check=False)
    return out.redistribute(mesh, x.placements), aux_loss(r, config)


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------

def _moe_block(config: MoEConfig, cos, sin, x: torch.Tensor,
               layer: Params) -> tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, layer["attn_norm"], config.norm_eps)
    x = x + attention_sublayer(h, layer, config, cos, sin)
    x = constrain(x, ("batch", "seq", None))
    h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    out, aux = moe_mlp(h, layer, config)
    return constrain(x + out, ("batch", "seq", None)), aux


def moe_hidden(params: Params, tokens: torch.Tensor, config: MoEConfig
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (final-normed hidden (B, S, D), the aux losses
    summed over the layers), through `layer_blocks` as `llama_hidden`."""
    cos, sin = rope_tables(config, tokens.shape[1], tokens.device)
    x = embed_lookup(params["embed"], tokens, config)
    run, layers = layer_blocks(params, config,
                               partial(_moe_block, config, cos, sin))
    auxes = []
    for layer in layers:
        x, aux = run(x, layer)
        auxes.append(aux)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return x, torch.stack(auxes).sum()


def moe_forward(params: Params, tokens: torch.Tensor, config: MoEConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) f32, total aux loss)."""
    with torch.inference_mode():
        x, aux = moe_hidden(params, tokens, config)
        return lm_head(x, params["output"]), aux


def moe_loss(params: Params, batch: dict[str, torch.Tensor],
             config: MoEConfig) -> torch.Tensor:
    """Next-token cross entropy plus aux_loss_weight times the aux loss."""
    inputs, targets = unpack_lm_batch(batch)
    x, aux = moe_hidden(params, inputs, config)
    return (_head_loss(x, params, targets, config)
            + config.aux_loss_weight * aux)
