"""Mixed precision: f32 master weights for bf16 models.

Counterpart of `tony_tpu/train/precision.py`. bf16 keeps about 8 bits of
mantissa: once `lr * update` drops below a parameter's bf16 ulp, the sum
rounds back to the parameter and training stalls. `with_f32_master(opt)`
keeps an f32 master copy of every parameter and runs the inner optimizer
over it (so Adam's moments are f32 too):

- each update casts the gradients to f32, or takes the f32 mean of a
  gradient-accumulated step as it is (`make_train_step` hands it over
  unrounded), and applies the inner optimizer to the master;
- then each parameter becomes exactly `master.to(param.dtype)`, copied in
  place (where the JAX version emits `cast(master') - param` as the
  update, so `apply_updates` lands on the cast).

Its state flattens as the JAX one's `{"inner": ..., "master": ...}`.
Memory: 4 bytes per parameter for the master, the inner optimizer's state
in f32, and the f32 gradients of one update.
"""

from __future__ import annotations

from typing import Optional

import torch

from tony_tpu_torch.train.optim import (
    Optimizer, copy_into, tree_leaves, tree_map,
)


class MasterOptState:
    """The state of `with_f32_master(inner)` over `params`."""

    def __init__(self, inner: Optimizer, params):
        self.params = params
        with torch.no_grad():
            self.master = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True)
                .requires_grad_(), params)
        self.inner = inner.init(self.master)

    @property
    def count(self) -> int:
        return self.inner.count

    @torch.no_grad()
    def step(self, grads: Optional[list] = None) -> None:
        """One update: `grads` (f32, one per parameter leaf) or each
        parameter's `.grad`, cast to f32, into the master's `.grad`; the
        inner update; each parameter set to its cast master. A parameter's
        own `.grad` is released as soon as it has been cast."""
        params = tree_leaves(self.params)
        masters = tree_leaves(self.master)
        for i, (m, p) in enumerate(zip(masters, params)):
            g = p.grad if grads is None else grads[i]
            m.grad = g.to(torch.float32)
            p.grad = None
        self.inner.step()
        for m, p in zip(masters, params):
            p.copy_(m)
            m.grad = None

    def tree(self):
        return {"inner": self.inner.tree(), "master": self.master}

    def load_tree(self, tree) -> None:
        """Restore the master and the inner state; the parameters are
        restored beside them and equal the cast master already."""
        copy_into(self.master, tree["master"])
        self.inner.load_tree(tree["inner"])


class _WithF32Master(Optimizer):
    def __init__(self, inner: Optimizer):
        super().__init__(make=None, kind=f"f32_master({inner.kind})")
        self.inner = inner

    def init(self, params) -> MasterOptState:
        if not all(p.requires_grad for p in tree_leaves(params)):
            raise ValueError("every parameter leaf must require grad")
        return MasterOptState(self.inner, params)


def with_f32_master(opt: Optimizer) -> Optimizer:
    """Wrap `opt` to accumulate its updates in an f32 master copy."""
    return _WithF32Master(opt)
