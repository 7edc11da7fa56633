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
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


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
    """A torch optimizer over the leaves and, optionally, its scheduler.
    `count` is the number of updates applied."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 scheduler=None):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.count += 1


class Optimizer:
    """`init(params) -> OptState`, with `make(leaves) -> (optimizer,
    scheduler)`."""

    def __init__(self, make: Callable[[list], tuple]):
        self._make = make

    def init(self, params) -> OptState:
        leaves = tree_leaves(params)
        if not all(p.requires_grad for p in leaves):
            raise ValueError("every parameter leaf must require grad")
        return OptState(*self._make(leaves))


def sgd(learning_rate: float) -> Optimizer:
    return Optimizer(lambda leaves: (
        torch.optim.SGD(leaves, lr=learning_rate), None))


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

    return Optimizer(make)
