"""The train step: forward, backward and one optimizer update.

Counterpart of `tony_tpu/train/step.py` on one device. There is no `jit`
(PyTorch runs eagerly) and no dp*fsdp shard check (one device). Parameters
and optimizer state update in place, where the JAX step donated their
buffers; `train_step` still returns (params, opt_state, loss) so it reads
like the JAX one. The loss stays a device tensor: nothing in the step
reads it on the host.

`grad_accum > 1` splits every batch leaf's leading dim into `grad_accum`
STRIDED microbatches (microbatch i = rows i, i + grad_accum, ...), runs
forward and backward on each in turn (peak activation memory is one
microbatch's), sums the gradients in f32, and applies one update with the
mean. The loss is the mean over microbatches. The f32 mean goes to the
optimizer as it is, `opt_state.step(grads)`: a plain one casts it to the
parameter dtype, and an f32 master (`train/precision.py`) takes it
unrounded.

`make_eval_step` is the loss alone, under `torch.no_grad()`.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from tony_tpu_torch.train.optim import Optimizer, OptState, tree_leaves


class AnnotatedStep:
    """Runs each call of the step inside a
    `torch.profiler.record_function("train_step")` range whose argument is
    the step counter, so a trace attributes host stalls to the step they
    delayed. A resuming trainer re-seats `step_num`."""

    def __init__(self, fn: Callable, name: str = "train_step",
                 step_num: int = 0):
        self._fn = fn
        self._name = name
        self.step_num = step_num

    def __call__(self, *args, **kwargs):
        with torch.profiler.record_function(self._name,
                                            args=str(self.step_num)):
            out = self._fn(*args, **kwargs)
        self.step_num += 1
        return out


def split_microbatches(batch: dict, grad_accum: int) -> list[dict]:
    """The strided split of every leaf's leading dim into `grad_accum`
    microbatches. Raises when a leading dim does not divide."""
    parts = {}
    for key, leaf in batch.items():
        b = leaf.shape[0]
        if b % grad_accum != 0:
            raise ValueError(f"batch dim {b} not divisible by grad_accum="
                             f"{grad_accum}")
        parts[key] = leaf.reshape((b // grad_accum, grad_accum)
                                  + tuple(leaf.shape[1:])).transpose(0, 1)
    return [{key: part[i] for key, part in parts.items()}
            for i in range(grad_accum)]


def make_train_step(loss_fn: Callable[..., torch.Tensor],
                    optimizer: Optimizer, grad_accum: int = 1,
                    annotate: bool = False) -> Callable:
    """loss_fn(params, batch) -> scalar tensor. Returns
    train_step(params, opt_state, batch) -> (params, opt_state, loss),
    with opt_state from `optimizer.init(params)`."""

    def backward(params: Any, batch: Any) -> torch.Tensor:
        loss = loss_fn(params, batch)
        loss.backward()
        return loss.detach()

    def train_step(params: Any, opt_state: OptState, batch: Any):
        leaves = tree_leaves(params)
        grads = None
        if grad_accum <= 1:
            loss = backward(params, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
            for micro in split_microbatches(batch, grad_accum):
                loss_sum += backward(params, micro).float()
                for a, p in zip(acc, leaves):
                    a.add_(p.grad)
                    p.grad = None
            loss = loss_sum / grad_accum
            grads = [a.div_(grad_accum) for a in acc]
        opt_state.step(grads)
        for p in leaves:
            p.grad = None
        return params, opt_state, loss

    return AnnotatedStep(train_step) if annotate else train_step


def make_eval_step(loss_fn: Callable[..., torch.Tensor]) -> Callable:
    """eval_step(params, batch) -> the loss, with no graph built."""

    def eval_step(params: Any, batch: Any) -> torch.Tensor:
        with torch.no_grad():
            return loss_fn(params, batch)

    return eval_step
