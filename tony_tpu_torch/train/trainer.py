"""Trainer: the single-device training loop.

Counterpart of the core of `tony_tpu/train/trainer.py`: `TrainerConfig`
keeps its field names and defaults, and `Trainer.setup()`/`run()` keep its
hot loop: prefetch, step, `log_every`, and one-interval-latent loss
logging (the loss stays on the device between updates; at each log
boundary the PREVIOUS boundary's loss is read, by when the device is
`log_every` steps past it). `metrics_history` also carries tokens/s over
each log interval and, on a card whose peak is known, MFU from
`flops_per_token`.

The optimizer is the JAX Trainer's default, `adamw` under
`warmup_cosine_decay_schedule(0, lr, max(1, warmup_steps),
max(num_steps, warmup_steps + 1))` with the Trainer's weight decay.

Not in this slice (ROADMAP queue 1 item 2): checkpointing and resume,
held-out evaluation, f32 master weights, a custom optimizer, the profiler
server, the metrics reporter, the goodput ledger and SIGTERM/emergency
checkpointing. The first five are TrainerConfig fields and raise
NotImplementedError when set; the last four have no switch here.
Sharded parameters wait for the parallel slice.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import torch

from tony_tpu_torch.device import peak_flops, resolve_device
from tony_tpu_torch.train.data import PrefetchIterator, global_batch_iterator
from tony_tpu_torch.train.optim import (
    adamw, tree_leaves, warmup_cosine_decay_schedule,
)
from tony_tpu_torch.train.step import make_train_step

LOG = logging.getLogger(__name__)

UNPORTED = "the port's trainer slice (ROADMAP queue 1 item 2)"


@dataclass
class TrainerConfig:
    num_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 0            # 0 = only at the end
    checkpoint_dir: str = ""             # "" = no checkpointing
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.01
    seed: int = 0
    optimizer: Optional[Any] = None
    grad_accum: int = 1
    master_weights: bool = False
    eval_every: int = 0
    eval_batches: int = 1
    # depth of the background prefetch queue. None = TONY_PREFETCH_DEPTH
    # env (default 2); 0 = synchronous transfer on the caller's thread
    prefetch_depth: Optional[int] = None
    # training FLOPs per token for MFU (the model config's
    # flops_per_token(seq); 0 = MFU not reported)
    flops_per_token: float = 0.0
    checkpoint_keep: Optional[int] = None
    extra: dict = field(default_factory=dict)


def tokens_in_batch(batch) -> int:
    """Token count of one batch: B * S of its 'inputs' or 'tokens'."""
    for key in ("inputs", "tokens"):
        arr = batch.get(key) if isinstance(batch, dict) else None
        shape = getattr(arr, "shape", None)
        if shape and len(shape) >= 2:
            return int(shape[0]) * int(shape[1])
    return 0


def _refuse_unported(cfg: TrainerConfig) -> None:
    asked = [name for name, value in (
        ("checkpoint_dir", cfg.checkpoint_dir),
        ("checkpoint_every", cfg.checkpoint_every),
        ("checkpoint_keep", cfg.checkpoint_keep is not None),
        ("eval_every", cfg.eval_every),
        ("master_weights", cfg.master_weights),
        ("optimizer", cfg.optimizer is not None)) if value]
    if asked:
        raise NotImplementedError(
            f"TrainerConfig {', '.join(asked)}: not in this slice; they "
            f"arrive with {UNPORTED}")


class Trainer:
    """loss_fn(params, batch) -> scalar; init_fn(generator) -> params on
    the generator's device; data_iter yields host batches (numpy)."""

    def __init__(self, loss_fn: Callable[[Any, Any], torch.Tensor],
                 init_fn: Callable[[torch.Generator], Any],
                 data_iter: Iterator[Any], config: TrainerConfig,
                 device: torch.device | str = "cuda"):
        self.loss_fn = loss_fn
        self.init_fn = init_fn
        self.data_iter = data_iter
        self.config = config
        self.device_name = device
        self.device: Optional[torch.device] = None
        self.step = 0
        self.params = None
        self.opt_state = None
        self.last_loss: Optional[float] = None
        self.metrics_history: list[dict] = []
        self._global_data_iter = None

    # ------------------------------------------------------------------
    def setup(self) -> None:
        cfg = self.config
        _refuse_unported(cfg)
        self.device = resolve_device(str(self.device_name))
        schedule = warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, max(1, cfg.warmup_steps),
            max(cfg.num_steps, cfg.warmup_steps + 1))
        self.optimizer = adamw(schedule, weight_decay=cfg.weight_decay)
        self.train_step = make_train_step(
            self.loss_fn, self.optimizer, grad_accum=cfg.grad_accum,
            annotate=True)
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        with torch.no_grad():
            params = self.init_fn(generator)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        self.params = params
        self.opt_state = self.optimizer.init(params)
        self.train_step.step_num = self.step
        # a second setup() carries the old prefetcher's undelivered
        # batches into the new one: they were already pulled from the
        # shared data_iter
        old = self._global_data_iter
        carry: list = list(getattr(self, "_carry", ()))
        if isinstance(old, PrefetchIterator):
            old.close()
            carry = old.leftover + carry
        depth = cfg.prefetch_depth
        if depth is None:
            depth = int(os.environ.get("TONY_PREFETCH_DEPTH", "2"))
        if depth > 0:
            self._carry = []
            self._global_data_iter = PrefetchIterator(
                self.data_iter, self.device, depth=depth, initial=carry)
        else:
            self._carry = carry

            def _sync_with_carry():
                while self._carry:
                    yield self._carry.pop(0)
                yield from global_batch_iterator(self.data_iter,
                                                 self.device)

            self._global_data_iter = _sync_with_carry()

    # ------------------------------------------------------------------
    def run(self) -> float:
        """Train to num_steps; returns the final loss."""
        if self.params is None:
            self.setup()
        it = self._global_data_iter
        if (isinstance(it, PrefetchIterator) and it.closed
                and self.step < self.config.num_steps):
            # a num_steps-bump re-run resumes the source stream from the
            # closed iterator's leftovers
            self._global_data_iter = PrefetchIterator(
                self.data_iter, self.device, depth=it.depth,
                initial=it.leftover)
        cfg = self.config
        peak = peak_flops(self.device)
        loss = None
        pending = None      # (step, device loss, elapsed_s, interval)
        tokens_per_batch = 0
        t0 = time.monotonic()
        last_t, last_step = t0, self.step

        def _flush(p) -> None:
            step, dev_loss, dt, interval = p
            loss_f = float(dev_loss)
            self.last_loss = loss_f
            entry = {"step": step, "loss": loss_f, "elapsed_s": dt}
            entry.update(interval)
            self.metrics_history.append(entry)
            LOG.info("step %d loss %.4f (%.1fs)", step, loss_f, dt)

        try:
            while self.step < cfg.num_steps:
                batch = next(self._global_data_iter)
                self.params, self.opt_state, loss = self.train_step(
                    self.params, self.opt_state, batch)
                self.step += 1
                if not tokens_per_batch:
                    tokens_per_batch = tokens_in_batch(batch)
                if cfg.log_every and self.step % cfg.log_every == 0:
                    if pending is not None:
                        _flush(pending)
                    now = time.monotonic()
                    interval = {}
                    if tokens_per_batch and now > last_t:
                        # host time between boundaries: in steady state
                        # the device is a fixed lag behind, so this is
                        # the achieved rate
                        tok_s = (tokens_per_batch * (self.step - last_step)
                                 / (now - last_t))
                        interval["tokens_per_s"] = tok_s
                        if peak and cfg.flops_per_token > 0:
                            interval["mfu_pct"] = (100.0 * tok_s
                                                   * cfg.flops_per_token
                                                   / peak)
                    last_t, last_step = now, self.step
                    pending = (self.step, loss, now - t0, interval)
            if pending is not None:
                _flush(pending)
                pending = None
            if loss is not None:
                self.last_loss = float(loss)
        finally:
            if pending is not None:
                try:
                    _flush(pending)
                except Exception:  # noqa: BLE001 — the real error wins
                    LOG.debug("could not flush pending log boundary",
                              exc_info=True)
            if isinstance(self._global_data_iter, PrefetchIterator):
                self._global_data_iter.close()
        return self.last_loss
