"""Optimizers and learning-rate schedules, as the JAX package builds them
with optax.

An optimizer here is a recipe: `init(params)` builds its state over the
parameter tree's leaves, and the state's `step()` applies one update in
place from each leaf's `.grad` (where optax returned new parameters and
the JAX step donated the old buffers).

- `sgd(lr)`: `optax.sgd(lr)`, p -= lr * g.
- `adamw(schedule, weight_decay)`: `optax.adamw(schedule,
  weight_decay=...)`, as `torch.optim.AdamW` (the same update:
  p -= lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p), with the
  decay on every leaf, norms included, and the moments in the parameter
  dtype) and a `LambdaLR` that gives, at the n-th update (n from 0),
  the schedule's value at count n.
- `warmup_cosine_decay_schedule`: optax's, value for value.

`OptState.tree()` gives the state in optax's leaf layout, the layout a
checkpoint holds (`train/checkpoint.py` flattens it as `jax.tree` does),
and `OptState.load_tree()` takes it back:
- `adamw`: `(ScaleByAdamState(count, mu, nu), EmptyState(),
  ScaleByScheduleState(count))`, the counts int32 scalars (the number of
  updates applied), mu and nu trees like the parameters' and in their
  dtypes (torch's `exp_avg` and `exp_avg_sq`). Loading sets torch's
  per-parameter `step` and the `LambdaLR` position to the count, so a
  resumed run goes on with the schedule where it stopped.
- `sgd`: `(EmptyState(), EmptyState())`, no leaves.
"""

from __future__ import annotations

import math
from collections import namedtuple
from typing import Callable, Iterable

import torch

# optax's state types, field for field: a checkpoint flattens them by
# field, in this order
ScaleByAdamState = namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
EmptyState = namedtuple("EmptyState", [])
ScaleByScheduleState = namedtuple("ScaleByScheduleState", ["count"])


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of nested dicts and lists (ResNet's stages of blocks),
    in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """`fn` over the leaves of nested dicts and lists, keeping their
    keys and order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


@torch.no_grad()
def copy_into(dst, src) -> None:
    """Copy every leaf of `src` into the same leaf of `dst`, in place
    (a leaf that is already the same tensor is left alone)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine from peak_value to end_value
    over decay_steps - warmup_steps (decay_steps counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if warmup_steps <= 0 or cosine_steps <= 0:
        raise ValueError(f"warmup_steps ({warmup_steps}) and decay_steps - "
                         f"warmup_steps ({cosine_steps}) must be positive")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class OptState:
    """A torch optimizer over the parameter leaves and, optionally, its
    scheduler. `count` is the number of updates applied; `kind` ("adamw",
    "sgd" or "") names the optax layout of `tree()`."""

    def __init__(self, optimizer: torch.optim.Optimizer, scheduler=None,
                 kind: str = "", params=None):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.kind = kind
        self.params = params
        self.count = 0
        if kind == "adamw":
            self._init_adam_state()

    def _init_adam_state(self) -> None:
        """Adam's state up front, as torch makes it at the first step (a
        host scalar `step`, zero moments), so the state has its whole
        layout before any update."""
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                self.optimizer.state[p] = {
                    "step": torch.tensor(0.0),
                    "exp_avg": torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(
                        p, memory_format=torch.preserve_format)}

    @torch.no_grad()
    def step(self, grads=None) -> None:
        """One update from each leaf's `.grad`, or from `grads` (one per
        leaf, such as the f32 mean of a gradient-accumulated step), cast
        into `.grad` in the parameter's dtype."""
        if grads is not None:
            for p, g in zip(tree_leaves(self.params), grads):
                p.grad = g.to(p.dtype)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.count += 1

    def tree(self):
        """The state in optax's leaf layout (module docstring): mu and nu
        are the live moment tensors, the counts new int32 scalars."""
        if self.kind == "sgd":
            return (EmptyState(), EmptyState())
        if self.kind != "adamw":
            raise NotImplementedError(
                "no optax layout for a custom Optimizer; use adamw or sgd")
        state = self.optimizer.state
        count = torch.tensor(self.count, dtype=torch.int32)
        return (ScaleByAdamState(
                    count,
                    tree_map(lambda p: state[p]["exp_avg"], self.params),
                    tree_map(lambda p: state[p]["exp_avg_sq"], self.params)),
                EmptyState(), ScaleByScheduleState(count.clone()))

    @torch.no_grad()
    def load_tree(self, tree) -> None:
        """Take the state back from `tree()`'s layout (as restored from a
        checkpoint of either package): the moments, the update count, each
        parameter's torch `step` and the learning-rate schedule's
        position."""
        if self.kind == "sgd":
            return
        adam, _, schedule = tree
        counts = {int(adam.count), int(schedule.count)}
        if len(counts) != 1:
            raise ValueError(f"adam and schedule counts differ: {counts}")
        state = self.optimizer.state
        copy_into(tree_map(lambda p: state[p]["exp_avg"], self.params),
                  adam.mu)
        copy_into(tree_map(lambda p: state[p]["exp_avg_sq"], self.params),
                  adam.nu)
        self.count = count = counts.pop()
        for p_state in state.values():
            p_state["step"].fill_(float(count))
        # LambdaLR's position: what `count` scheduler steps leave behind
        sched = self.scheduler
        sched.last_epoch = count
        lrs = [base * fn(count)
               for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs


class Optimizer:
    """`init(params) -> OptState`, with `make(leaves) -> (optimizer,
    scheduler)`; `kind` names its optax layout. The counterpart of an
    optax GradientTransformation, and what `TrainerConfig.optimizer`
    takes."""

    def __init__(self, make: Callable[[list], tuple], kind: str = ""):
        self._make = make
        self.kind = kind

    def init(self, params) -> OptState:
        leaves = tree_leaves(params)
        if not all(p.requires_grad for p in leaves):
            raise ValueError("every parameter leaf must require grad")
        return OptState(*self._make(leaves), kind=self.kind, params=params)


def sgd(learning_rate: float) -> Optimizer:
    return Optimizer(lambda leaves: (
        torch.optim.SGD(leaves, lr=learning_rate), None), kind="sgd")


def adamw(schedule: Callable[[int], float], weight_decay: float = 1e-4,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
          ) -> Optimizer:
    """optax.adamw (whose default weight_decay is 1e-4; torch's is 1e-2)
    with the learning rate a schedule of the update count."""

    def make(leaves: Iterable[torch.Tensor]):
        opt = torch.optim.AdamW(leaves, lr=1.0, betas=(b1, b2), eps=eps,
                                weight_decay=weight_decay)
        # base lr 1.0: the scheduler's factor is the rate itself
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)

    return Optimizer(make, kind="adamw")
