"""Faults planted under the timed path, for the tests and the chip runs
that show the comparison catches them. A run of the benchmark plants
none; the serving process plants the one named by PORTBENCH_FAULT, which
only those tests and runs set.

- `unchanged_state`: the train step leaves parameters and optimizer state
  as they were;
- `half_batch`: the loss is the mean over the first half of the batch's
  rows;
- `altered_token`: every token the engine samples is replaced by the next
  id.
"""

from __future__ import annotations

import os

ENV = "PORTBENCH_FAULT"


def wrap_loss(loss_fn, fault: str):
    if fault != "half_batch":
        return loss_fn

    def half(params, batch):
        return loss_fn(params, {k: v[: v.shape[0] // 2]
                                for k, v in batch.items()})
    return half


def after_setup(trainer, fault: str) -> None:
    if fault == "unchanged_state":
        trainer.opt_state.step = lambda grads=None: None


def install_serving(vocab: int) -> None:
    if os.environ.get(ENV) != "altered_token":
        return
    from tony_tpu_torch.serve import engine

    sample = engine._sample

    def altered(*args, **kwargs):
        return (sample(*args, **kwargs) + 1) % vocab
    engine._sample = altered
