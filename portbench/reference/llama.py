"""The plain reference of a Mistral-family decoder, dense or with a top-k
mixture-of-experts MLP (Mixtral): forward, loss, gradients and the AdamW
update, in float32 with TF32 off, in plain PyTorch. It imports nothing of
the program.

It follows the published model: RMSNorm (x * rsqrt(mean(x^2) + eps) * w),
RoPE in the half-rotation form at `rope_theta`, grouped-query causal
attention, SwiGLU, and for Mixtral a softmax router whose top-k
probabilities are renormalised to gate the experts' outputs. Departures,
each the program's as well: no sliding window (the configurations state
none), and in training the MoE drops a token from an expert whose queue
holds `capacity = max(1, int(cf * T * k / E))` tokens before it (the
configuration's assumed capacity factor), with the Switch aux loss
weighted by `router_aux_loss_coef`.

Weights come in the served layout (`portbench/weights.py`, bf16) and are
widened to float32 a layer at a time, so the whole model never sits on the
card in float32. `precision="fp8"` is the control: every product's two
operands are rounded to fp8 with one scale per tensor, as fp8 training
does (e4m3 forward, the gradients in e5m2), and multiplied in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

# the hybrid fp8 recipe of fp8 training: e4m3 for the forward's operands,
# e5m2 (wider range, one bit less) for the gradients
FP8_FORMATS = {"forward": (torch.float8_e4m3fn, 448.0),
               "gradient": (torch.float8_e5m2, 57344.0)}


def plain_float32() -> None:
    """IEEE float32 products on the card: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q8(x: torch.Tensor, kind: str = "forward") -> torch.Tensor:
    """x rounded to fp8 (`FP8_FORMATS[kind]`) with one scale for the
    tensor, as f32."""
    dtype, largest = FP8_FORMATS[kind]
    scale = x.detach().abs().amax().clamp_min(1e-30) / largest
    return (x / scale).to(dtype).float() * scale


class _Fp8Product(torch.autograd.Function):
    """a @ b with both operands rounded to fp8 e4m3; the backward's
    products take the incoming gradient in e5m2 and the saved operands in
    e4m3."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _q8(a) @ _q8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = _q8(g, "gradient")
        ga = g8 @ _q8(b).transpose(-1, -2)
        gb = _q8(a).transpose(-1, -2) @ g8
        # undo broadcasting over leading dims
        while ga.ndim > a.ndim:
            ga = ga.sum(0)
        while gb.ndim > b.ndim:
            gb = gb.sum(0)
        return ga, gb


def product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8Product.apply(a, b)
    return a @ b


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(cfg: dict, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    hd = head_dim(cfg)
    inv = 1.0 / (float(cfg["rope_theta"])
                 ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=device) / hd))
    ang = torch.outer(torch.arange(n, dtype=torch.float32, device=device),
                      inv)
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """x (B, H, S, hd); pairs (x1, x2) of the two halves rotate."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, None], sin[None, None]
    return torch.cat((x1 * c - x2 * s, x1 * s + x2 * c), dim=-1)


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def attention(q, k, v, precision: str, heads_per_chunk: int = 8):
    """Causal attention, q (B, H, S, hd), k/v (B, Hkv, S, hd), in chunks
    of heads to bound the (S, S) scores held at once."""
    b, h, s, hd = q.shape
    group = h // k.shape[1]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    outs = []
    for h0 in range(0, h, heads_per_chunk):
        h1 = min(h, h0 + heads_per_chunk)
        kv_idx = torch.arange(h0, h1, device=q.device) // group
        kc, vc = k[:, kv_idx], v[:, kv_idx]
        scores = product(q[:, h0:h1] * hd ** -0.5, kc.transpose(-1, -2),
                         precision)
        probs = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
        outs.append(product(probs, vc, precision))
    return torch.cat(outs, dim=1)


def swiglu(h, w_gate, w_up, w_down, precision: str):
    return product(F.silu(product(h, w_gate, precision))
                   * product(h, w_up, precision), w_down, precision)


def moe(h2: torch.Tensor, layer: dict, cfg: dict, precision: str,
        capacity_factor: Optional[float]):
    """(T, D) -> ((T, D), aux loss). capacity_factor None: no token is
    dropped."""
    t = h2.shape[0]
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(product(h2, layer["router"], precision), dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    gates = top_p / top_p.sum(-1, keepdim=True)
    chosen = torch.zeros((t, e), dtype=torch.bool, device=h2.device)
    chosen.scatter_(1, top_i, True)
    keep = chosen
    if capacity_factor is not None:
        capacity = max(1, int(capacity_factor * t * k / e))
        position = torch.cumsum(chosen.long(), dim=0) - 1
        keep = chosen & (position < capacity)
    out = torch.zeros_like(h2)
    for j in range(e):
        rows = torch.nonzero(keep[:, j], as_tuple=True)[0]
        if rows.numel() == 0:
            continue
        gate = (gates * (top_i == j)).sum(-1)[rows, None]
        y = swiglu(h2[rows], layer["we_gate"][j], layer["we_up"][j],
                   layer["we_down"][j], precision)
        out = out.index_add(0, rows, gate * y)
    aux = (chosen.float().mean(0) * probs.mean(0)).sum() * (e / k)
    return out, aux


def block(x: torch.Tensor, layer: dict, cfg: dict, cos, sin, precision: str,
          capacity_factor: Optional[float] = None):
    """One decoder layer on x (B, S, D) f32 -> (x', aux loss or None)."""
    b, s, d = x.shape
    nh, nkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   head_dim(cfg))
    eps = cfg["rms_norm_eps"]
    h = rms_norm(x, layer["attn_norm"], eps)
    q = product(h, layer["wq"], precision).view(b, s, nh, hd).transpose(1, 2)
    kk = product(h, layer["wk"], precision).view(b, s, nkv, hd).transpose(1, 2)
    v = product(h, layer["wv"], precision).view(b, s, nkv, hd).transpose(1, 2)
    a = attention(rope(q, cos, sin), rope(kk, cos, sin), v, precision)
    x = x + product(a.transpose(1, 2).reshape(b, s, nh * hd), layer["wo"],
                    precision)
    h = rms_norm(x, layer["mlp_norm"], eps)
    if cfg.get("num_local_experts"):
        out, aux = moe(h.reshape(b * s, d), layer, cfg, precision,
                       capacity_factor)
        return x + out.view(b, s, d), aux
    return x + swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"],
                      precision), None


def layer_f32(params: dict, i: int) -> dict:
    """Layer i's weights widened to float32."""
    return {name: w[i].to(torch.float32, copy=True)
            for name, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# serving: logits of the positions that produced served tokens
# ---------------------------------------------------------------------------

@torch.no_grad()
def logits_at(cfg: dict, params: dict, seqs: list, rows: list,
              precision: str = "f32") -> list:
    """For each token sequence seqs[i] (1-D long on the device), the f32
    logits (len(rows[i]), V) at positions rows[i], from the full forward
    over the sequence: layer by layer over every sequence."""
    device = params["embed"].device
    xs = [params["embed"][s].float()[None] for s in seqs]
    n_max = max(s.numel() for s in seqs)
    cos, sin = rope_tables(cfg, n_max, device)
    for i in range(cfg["num_hidden_layers"]):
        layer = layer_f32(params, i)
        for j, x in enumerate(xs):
            n = x.shape[1]
            xs[j] = block(x, layer, cfg, cos[:n], sin[:n], precision)[0]
        del layer
    out_w = params["output"].float()
    norm = params["final_norm"].float()
    return [product(rms_norm(x[0, r], norm, cfg["rms_norm_eps"]), out_w,
                    precision) for x, r in zip(xs, rows)]


# ---------------------------------------------------------------------------
# training: loss and gradients, layer by layer, and AdamW
# ---------------------------------------------------------------------------

def _head_loss(x_last, params, targets, cfg, precision, chunk: int = 4096):
    """Mean cross entropy of the final-normed head over (B, S) targets,
    and its gradients: (loss, dx_last, {'final_norm', 'output'} grads)."""
    b, s, d = x_last.shape
    x = x_last.detach().reshape(b * s, d).requires_grad_()
    # copies: an f32 leaf's .float() is the leaf itself, whose .grad
    # would carry over into the next step
    norm = params["final_norm"].to(torch.float32, copy=True).requires_grad_()
    out_w = params["output"].to(torch.float32, copy=True).requires_grad_()
    t = targets.reshape(-1)
    total = torch.zeros((), device=x.device)
    for r0 in range(0, b * s, chunk):
        r1 = min(b * s, r0 + chunk)
        logits = product(rms_norm(x[r0:r1], norm, cfg["rms_norm_eps"]),
                         out_w, precision)
        loss = F.cross_entropy(logits, t[r0:r1].long(), reduction="sum")
        (loss / (b * s)).backward()
        total = total + loss.detach()
    return (total / (b * s), x.grad.view(b, s, d),
            {"final_norm": norm.grad, "output": out_w.grad})


def loss_and_grads(cfg: dict, params: dict, tokens: torch.Tensor,
                   precision: str = "f32",
                   capacity_factor: Optional[float] = None,
                   on_layer_grads: Optional[Callable] = None,
                   weights: Optional[Callable] = None):
    """One batch {'tokens': (B, S + 1)}: (loss, grads of embed, final_norm
    and output). Each layer's gradients go to on_layer_grads(i, grads)
    as soon as that layer's backward is done (the layer's f32 grads,
    which it may keep). `weights(i)` gives layer i's f32 weights (default:
    the bf16 params widened)."""
    weights = weights or (lambda i: layer_f32(params, i))
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    b, s = inputs.shape
    L = cfg["num_hidden_layers"]
    cos, sin = rope_tables(cfg, s, tokens.device)
    aux_w = float(cfg.get("router_aux_loss_coef", 0.0))
    xs = [params["embed"][inputs].float()]
    aux_total = torch.zeros((), device=tokens.device)
    with torch.no_grad():
        for i in range(L):
            x, aux = block(xs[-1], weights(i), cfg, cos, sin, precision,
                           capacity_factor)
            xs.append(x)
            if aux is not None:
                aux_total = aux_total + aux
    loss, dx, top = _head_loss(xs.pop(), params, targets, cfg, precision)
    for i in reversed(range(L)):
        x = xs.pop().requires_grad_()
        layer = {k: w.requires_grad_() for k, w in weights(i).items()}
        y, aux = block(x, layer, cfg, cos, sin, precision, capacity_factor)
        if aux is not None:
            torch.autograd.backward([y, aux * aux_w],
                                    [dx, torch.ones_like(aux)])
        else:
            y.backward(dx)
        dx = x.grad
        if on_layer_grads is not None:
            on_layer_grads(i, {k: w.grad for k, w in layer.items()})
        del x, layer, y
    d = cfg["hidden_size"]
    g_embed = torch.zeros((cfg["vocab_size"], d), device=tokens.device)
    g_embed.index_add_(0, inputs.reshape(-1), dx.reshape(-1, d))
    top["embed"] = g_embed
    return loss + aux_w * aux_total, top


def warmup_cosine(init: float, peak: float, warmup: int, decay: int,
                  end: float = 0.0):
    """optax.warmup_cosine_decay_schedule's value at update n."""
    alpha = 0.0 if peak == 0.0 else end / peak

    def lr(n: int) -> float:
        if n < warmup:
            return init + (peak - init) * max(n, 0) / warmup
        t = min(n - warmup, decay - warmup)
        return peak * ((1 - alpha) * 0.5
                       * (1 + math.cos(math.pi * t / (decay - warmup)))
                       + alpha)
    return lr


def follow_two_steps(cfg: dict, params: dict, batches: list, opt: dict,
                     precision: str = "f32",
                     capacity_factor: Optional[float] = None) -> dict:
    """The first two AdamW steps from `params` (bf16, served layout) on
    batches[0] and batches[1], with the update
    p <- p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps) on every leaf.
    The first update's learning rate must be 0 (a warmup from 0), so the
    second step's loss and gradients are at the initial weights and only
    the first gradient is kept between the steps. The parameters are held
    in the configuration's dtype, as the program holds them: the update
    is computed in float32 and the updated parameter stored in that dtype
    (bf16 for the weights, f32 for the norms), so an update under half a
    bf16 step leaves a weight as it was on both sides.

    Returns {"loss": [l1, l2], "grad_norm": {leaf: |g1|},
    "change_norm": {leaf: |p2 - p0|}} (leaf paths as `weights.leaf_paths`;
    a stacked layer leaf's norm is over all its layers)."""
    lr = opt["lr"]
    if lr(0) != 0.0:
        raise ValueError("the reference follows a first update of lr 0 only")
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    g1: dict = {}
    sq1: dict = {}

    def keep_first(i, grads):
        for name, g in grads.items():
            g1.setdefault(name, [None] * cfg["num_hidden_layers"])[i] = g
            sq1[name] = sq1.get(name, 0.0) + float(g.double().pow(2).sum())

    loss1, top1 = loss_and_grads(cfg, params, batches[0], precision,
                                 capacity_factor, keep_first)
    grad_norm = {f"layers/{k}": math.sqrt(v) for k, v in sq1.items()}
    for k, g in top1.items():
        grad_norm[k] = float(g.double().norm())
    change_sq: dict = {}
    step_lr = lr(1)
    c1, c2 = 1 - b1 ** 2, 1 - b2 ** 2

    def adam_change(g_first, g_second, stored):
        """The second update, computed in f32 and stored in the
        parameter's own dtype: the change as the stored values see it."""
        w0 = stored.float()
        m = b1 * (1 - b1) * g_first + (1 - b1) * g_second
        v = b2 * (1 - b2) * g_first.pow(2) + (1 - b2) * g_second.pow(2)
        upd = (m / c1) / ((v / c2).sqrt() + eps)
        w2 = w0 - step_lr * (upd + wd * w0)
        return w2.to(stored.dtype).float() - w0

    def update_layer(i, grads):
        for name, g in grads.items():
            first = g1[name][i]
            g1[name][i] = None
            d = adam_change(first, g, params["layers"][name][i])
            change_sq[name] = change_sq.get(name, 0.0) + float(
                d.double().pow(2).sum())

    loss2, top2 = loss_and_grads(cfg, params, batches[1], precision,
                                 capacity_factor, update_layer)
    change_norm = {f"layers/{k}": math.sqrt(v) for k, v in change_sq.items()}
    for k in top2:
        d = adam_change(top1[k], top2[k], params[k])
        change_norm[k] = float(d.detach().double().norm())
    return {"loss": [float(loss1), float(loss2)], "grad_norm": grad_norm,
            "change_norm": change_norm}
