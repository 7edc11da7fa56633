"""Trainer: the single-device training loop and its state lifecycle.

Counterpart of `tony_tpu/train/trainer.py`: `TrainerConfig` keeps its
field names and defaults, and `Trainer.setup()`/`run()` keep its hot loop:
prefetch, step, `log_every`, and one-interval-latent loss logging (the
loss stays on the device between updates; at each log boundary the
PREVIOUS boundary's loss is read, by when the device is `log_every` steps
past it). `metrics_history` also carries tokens/s over each log interval
and, on a card whose peak is known, MFU from `flops_per_token`.

The state lifecycle is the JAX Trainer's:
- **Resume**: `setup()` restores the latest committed step under
  `checkpoint_dir` (written by this package or by the JAX one) into the
  freshly built parameters and optimizer state, in place, and pins that
  step against retention GC while it is the only rollback target.
- **Checkpoints**: every `checkpoint_every` steps through
  `AsyncCheckpointer` (synchronous snapshot, file IO on a thread), and a
  final synchronous one at the end; `checkpoint_keep` (else the
  TONY_CHECKPOINT_KEEP env, else 3) committed steps are kept.
- **Held-out eval**: every `eval_every` steps, the mean loss over a fixed
  set of `eval_batches` batches from `eval_data_iter`, drawn once and kept
  across a re-`setup()`, the losses summed on the device and read once.
- **Precision and optimizer**: `optimizer` (an `Optimizer`, the
  counterpart of an optax transformation) else the JAX Trainer's default,
  `adamw` under `warmup_cosine_decay_schedule(0, lr, max(1,
  warmup_steps), max(num_steps, warmup_steps + 1))`; `master_weights`
  wraps it in `with_f32_master`.
- **Preemption**: SIGTERM raises `TrainerPreempted` in the main thread,
  at a step boundary: the step updates parameters and moments in place
  over many Python statements, so a SIGTERM that lands inside it is held
  until the update is whole. `run()` then commits one emergency checkpoint
  (after the in-flight async save, skipped when the step is already
  committed) and exits `EXIT_PREEMPTED`. Any other error mid-run also gets
  the emergency save, and is re-raised: the save never masks it. An error
  that escapes the step itself may have left it half applied, so that
  state is never committed: the last committed step stands.

Reports to the orchestrator, as the JAX Trainer makes them (each a no-op
outside it):
- **Spans**: `trainer_setup`, `first_step` (step 1's dispatch),
  `checkpoint_save` and `checkpoint_restore`, parented under the
  executor's ``TONY_PARENT_SPAN``.
- **Goodput**: one `GoodputLedger` per process, seeded from
  ``TONY_GOODPUT_SEED``: init, compile (step 1), train_step, input_stall
  (the prefetcher's `stall_s`, carved out of train_step at log
  boundaries), eval, checkpoint save and restore, then idle.
- **Metrics**: at each log boundary `TRAIN_STEP_TIME_MS` (eval and
  checkpoint time taken out), `TRAIN_TOKENS_PER_SEC_PER_CHIP`,
  `TRAIN_MFU_PCT`, the card's memory and the goodput gauges go to the
  non-blocking `TpuMetricsReporter`; a final push when the run ends.
- **Profile capture** on request (`ProfileCapture`), and the chaos step
  delay ``TONY_TRAINER_STEP_DELAY_MS``.
- **The TensorBoard port**: on the chief (``IS_CHIEF``, default "true")
  with ``TB_PORT`` set, `setup()` serves the profiler page there
  (`ProfilerServer`: status, a capture on request, its Chrome trace); a
  port it cannot bind is logged and training goes on. `run()` stops it.
- **Kernel build cache**: `setup()` first points the kernel builds at
  ``$TONY_JAX_CACHE_DIR`` (`maybe_enable_compile_cache`), so a later task
  loads the kernels an earlier one compiled.
- **Checkpoint directories** are local (or NFS) paths or ``gs://``
  locations (with ``gsutil`` or ``gcloud`` on PATH).
- **A gang of ranks** (`setup()`): the rendezvous from the executor's env
  (`parallel/distributed.py`; nccl on a card, gloo on the CPU), then
  `mesh_from_env`, then the parameters built from the seeded generator on
  every rank and sharded by `param_axes` (replicated without it), then
  the optimizer state built over the shards, so f32 masters and Adam
  moments are sharded as their parameters are (`opt_state_specs`
  checks it). Each rank's batch is its shard of the global batch.
  Metrics, goodput, spans and the profiler run on every rank; only rank
  0 logs the step line. A world of one with no TPU_MESH_SHAPE builds no
  process group and runs on plain tensors.
"""

from __future__ import annotations

import itertools
import logging
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Iterator, Optional

import torch
from torch.distributed.tensor import DTensor

from tony_tpu_torch import constants as C
from tony_tpu_torch.device import peak_flops, resolve_device
from tony_tpu_torch.observability.perf import (
    GoodputLedger, ProfileCapture, mfu_pct, tokens_in_batch,
)
from tony_tpu_torch.observability.profiler_server import ProfilerServer
from tony_tpu_torch.observability.trace import SpanRecorder
from tony_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed, rank, world_size,
)
from tony_tpu_torch.parallel.mesh import mesh_from_env
from tony_tpu_torch.parallel.sharding import (
    is_placements, opt_state_specs, replicated, shard_pytree, tree_paths,
)
from tony_tpu_torch.train.checkpoint import (
    AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint,
    trainer_state,
)
from tony_tpu_torch.train.data import (
    PrefetchIterator, global_batch_iterator, hand_over,
)
from tony_tpu_torch.train.optim import (
    Optimizer, adamw, tree_leaves, tree_map, warmup_cosine_decay_schedule,
)
from tony_tpu_torch.train.precision import with_f32_master
from tony_tpu_torch.train.metrics import TpuMetricsReporter
from tony_tpu_torch.train.step import make_eval_step, make_train_step

LOG = logging.getLogger(__name__)


def _task_id(env) -> str:
    """"<job>:<index>" of the executor's task, "" outside it."""
    if not env.get(C.JOB_NAME):
        return ""
    return f"{env[C.JOB_NAME]}:{env.get(C.TASK_INDEX, '0')}"


class TrainerPreempted(BaseException):
    """Raised by the Trainer's SIGTERM handler in the main thread. A
    BaseException, so user code's `except Exception` cannot swallow the
    drain; run() turns it into an emergency checkpoint and
    SystemExit(EXIT_PREEMPTED)."""


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
    optimizer: Optional[Optimizer] = None
    grad_accum: int = 1
    # f32 master weights for bf16 params (train/precision.py)
    master_weights: bool = False
    # held-out eval every N steps over eval_batches batches (0 = none;
    # needs eval_data_iter on the Trainer)
    eval_every: int = 0
    eval_batches: int = 1
    # depth of the background prefetch queue. None = TONY_PREFETCH_DEPTH
    # env (default 2); 0 = synchronous transfer on the caller's thread
    prefetch_depth: Optional[int] = None
    # training FLOPs per token for MFU (the model config's
    # flops_per_token(seq); 0 = MFU not reported)
    flops_per_token: float = 0.0
    # committed steps kept after each commit (never the restored one).
    # None = the TONY_CHECKPOINT_KEEP env (default 3); 0 = keep all
    checkpoint_keep: Optional[int] = None
    extra: dict = field(default_factory=dict)


class Trainer:
    """loss_fn(params, batch) -> scalar; init_fn(generator) -> params on
    the generator's device; data_iter (and eval_data_iter) yield host
    batches (numpy); param_axes: the params' logical axes (the JAX
    Trainer's), which shard them under a mesh. loss_takes_mesh: the loss
    also takes `mesh=` (a pipelined loss), which is known only after the
    rendezvous, so `setup()` binds it (None without a mesh)."""

    def __init__(self, loss_fn: Callable[[Any, Any], torch.Tensor],
                 init_fn: Callable[[torch.Generator], Any],
                 data_iter: Iterator[Any], config: TrainerConfig,
                 device: torch.device | str = "cuda",
                 eval_data_iter: Optional[Iterator[Any]] = None,
                 param_axes: Any = None, loss_takes_mesh: bool = False):
        self.loss_fn = loss_fn
        self.loss_takes_mesh = loss_takes_mesh
        self.init_fn = init_fn
        self.param_axes = param_axes
        self.mesh = None
        self.data_iter = data_iter
        self.eval_data_iter = eval_data_iter
        self.last_eval_loss: Optional[float] = None
        self.config = config
        self.device_name = device
        self.device: Optional[torch.device] = None
        self.step = 0
        self.params = None
        self.opt_state = None
        self.last_loss: Optional[float] = None
        self.metrics_history: list[dict] = []
        self._global_data_iter = None
        self._eval_set: Optional[list] = None
        self._checkpointer: Optional[AsyncCheckpointer] = None
        # the step this run restored from, pinned against retention GC
        self._restore_pinned: Optional[int] = None
        # set by the SIGTERM-driven emergency path
        self.preempted = False
        # True while a train step runs (and after one that raised): its
        # in-place update may be part way
        self._updating = False
        # a SIGTERM that arrived mid-step, raised at the step's end
        self._preempt_requested = False
        self.ledger: Optional[GoodputLedger] = None
        self._tracer: Optional[SpanRecorder] = None
        self._metrics_reporter: Optional[TpuMetricsReporter] = None
        self._profile: Optional[ProfileCapture] = None
        self._profiler_server: Optional[ProfilerServer] = None
        self._tokens_per_batch = 0
        self._last_stall_s = 0.0
        self._test_step_delay_s = 0.0

    # ------------------------------------------------------------------
    def setup(self) -> None:
        # armed first: a SIGTERM during setup or restore still drains
        self._install_sigterm_handler()
        # spans parent under the executor's user_process span and ride
        # the reporter's queue: the hot loop never gains an RPC
        env = os.environ
        self._tracer = SpanRecorder.from_env(
            env, task_id=_task_id(env),
            attempt=int(env.get(C.TASK_ATTEMPT, "0") or 0))
        # one ledger per process: a re-setup() keeps its clock
        if self.ledger is None:
            self.ledger = GoodputLedger.from_env(env)
        else:
            self.ledger.transition("init")
        setup_span = self._tracer.start("trainer_setup")
        try:
            self._setup_inner()
        except BaseException:
            self._tracer.end(setup_span, "ERROR")
            raise
        self._tracer.end(setup_span, attrs={"resumed_step": self.step})
        self._flush_spans()

    def _flush_spans(self) -> None:
        tracer, reporter = self._tracer, self._metrics_reporter
        if tracer is not None and reporter is not None and tracer.enabled:
            reporter.report_spans(tracer.drain())

    def _setup_inner(self) -> None:
        # the kernel build cache ($TONY_JAX_CACHE_DIR), before anything
        # below can load a kernel
        from tony_tpu_torch.utils.compilecache import (
            maybe_enable_compile_cache,
        )
        maybe_enable_compile_cache()
        if self._metrics_reporter is not None:
            self._metrics_reporter.close()
        self._metrics_reporter = TpuMetricsReporter()
        # the request file is polled at log boundaries; the artifact
        # rides the metrics RPC back to the AM
        self._profile = ProfileCapture(
            cwd=os.getcwd(),
            publish=self._metrics_reporter.report_profile_done)
        self._maybe_start_profiler()
        self._last_stall_s = 0.0
        # chaos seam: a fixed per-step host sleep (a steady straggler)
        self._test_step_delay_s = float(
            os.environ.get(C.TRAINER_STEP_DELAY_MS, "0") or 0) / 1000.0
        cfg = self.config
        self.device = resolve_device(str(self.device_name))
        if maybe_initialize_distributed(self.device):
            self.mesh = mesh_from_env(self.device.type)
            LOG.info("mesh: %s over %d ranks (rank %d)",
                     dict(zip(self.mesh.mesh_dim_names, self.mesh.shape)),
                     self.mesh.size(), rank())
        if cfg.optimizer is not None:
            self.optimizer = cfg.optimizer
        else:
            schedule = warmup_cosine_decay_schedule(
                0.0, cfg.learning_rate, max(1, cfg.warmup_steps),
                max(cfg.num_steps, cfg.warmup_steps + 1))
            self.optimizer = adamw(schedule, weight_decay=cfg.weight_decay)
        if cfg.master_weights:
            self.optimizer = with_f32_master(self.optimizer)
        # bound into a local, never back onto self.loss_fn: a second
        # setup() would stack a second mesh= onto the bound partial
        loss_fn = self.loss_fn
        if self.loss_takes_mesh:
            loss_fn = partial(loss_fn, mesh=self.mesh)
        self.train_step = make_train_step(loss_fn, self.optimizer,
                                          grad_accum=cfg.grad_accum)
        resume = (latest_step(cfg.checkpoint_dir)
                  if cfg.checkpoint_dir else None)
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        with torch.no_grad():
            params = self.init_fn(generator)
            if self.mesh is not None:
                params = self._shard(params)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        self.params = params
        self.opt_state = self.optimizer.init(params)
        if self.mesh is not None:
            self._check_opt_state_sharded()
            LOG.info("params: %d DTensor leaves on the mesh",
                     sum(isinstance(p, DTensor) for p in tree_leaves(params)))
        self._updating = False
        # a state with no optax layout (a custom Optimizer) cannot be
        # saved: refuse now, not at the first save
        template = self._state(step=0) if cfg.checkpoint_dir else None
        if resume is not None:
            LOG.info("resuming from checkpoint step %d", resume)
            self._restore_pinned = resume
            self.ledger.transition("checkpoint_restore")
            # in place into the state just built: leaf by leaf, on the
            # device, mmap-backed reads
            with self._tracer.span("checkpoint_restore",
                                   attrs={"step": resume}):
                state = restore_checkpoint(cfg.checkpoint_dir, resume,
                                           template=template)
            self.ledger.transition("init")
            self.opt_state.load_tree(state["opt_state"])
            self.step = int(state["step"])
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
                self.data_iter, self.device, depth=depth, initial=carry,
                mesh=self.mesh)
        else:
            self._carry = carry

            def _sync_with_carry():
                while self._carry:
                    yield hand_over(self._carry.pop(0))
                yield from global_batch_iterator(self.data_iter,
                                                 self.device, self.mesh)

            self._global_data_iter = _sync_with_carry()
        if cfg.eval_every and self.eval_data_iter is not None:
            self.eval_step = make_eval_step(loss_fn)
            # a FIXED held-out set, drawn once: eval losses compare across
            # steps and across resumes, and a re-setup() must not draw the
            # next batches of the partly consumed iterator. islice caps the
            # pull at exactly n.
            if self._eval_set is None:
                n = max(1, cfg.eval_batches)
                with PrefetchIterator(
                        itertools.islice(self.eval_data_iter, n),
                        self.device, depth=n, mesh=self.mesh) as stream:
                    self._eval_set = [next(stream) for _ in range(n)]

    def _shard(self, params):
        """The full parameters every rank built from the seed, as DTensors
        on the mesh: placed by `param_axes`, else replicated."""
        if self.param_axes is None:
            return tree_map(lambda p: replicated(p, self.mesh), params)
        return shard_pytree(params, self.param_axes, self.mesh)

    def _check_opt_state_sharded(self) -> None:
        """Every optimizer-state leaf that mirrors a parameter (f32 master,
        Adam moments) carries that parameter's placements: sharded where
        it is, never replicated."""
        try:
            tree = self.opt_state.tree()
        except NotImplementedError:        # a custom Optimizer
            return
        specs = opt_state_specs(tree, tree_map(lambda p: tuple(
            p.placements), self.params))
        for (path, leaf), (_, spec) in zip(
                tree_paths(tree), tree_paths(specs, is_placements)):
            if spec is not None and tuple(leaf.placements) != spec:
                raise RuntimeError(
                    f"optimizer state {'/'.join(path)} is placed "
                    f"{leaf.placements}, its parameter {spec}")

    def _state(self, step: Optional[int] = None) -> dict:
        """What a checkpoint holds, as the JAX Trainer saves it."""
        return trainer_state(self.params, self.opt_state.tree(),
                             self.step if step is None else step)

    def _perf_metrics(self) -> list[dict]:
        """Log-boundary accounting (never per step): carve the
        prefetcher's fresh stall seconds out of train_step, and return
        the goodput gauges plus the interval's step time, tokens/s and
        MFU for the metrics push. Reads shapes and host clocks only."""
        now = time.monotonic()
        snap = getattr(self._global_data_iter, "stall_snapshot", None)
        if snap is not None:
            stall_s, _ = snap()
            if stall_s > self._last_stall_s:
                self.ledger.carve("input_stall",
                                  stall_s - self._last_stall_s,
                                  source="train_step")
            self._last_stall_s = stall_s
        phases = self.ledger.snapshot()["phases"]
        out = self.ledger.metrics()
        prev_t = getattr(self, "_perf_t0", None)
        prev_step = getattr(self, "_perf_step0", self.step)
        if prev_t is not None and self.step > prev_step and now > prev_t:
            dt = now - prev_t
            d_steps = self.step - prev_step
            # step time leaves out the interval's eval and checkpoint
            # time; throughput stays on the wall (stalls included)
            prev_phases = getattr(self, "_perf_phases0", {})
            overhead = sum(
                phases.get(p, 0.0) - prev_phases.get(p, 0.0)
                for p in ("eval", "checkpoint_save", "checkpoint_restore"))
            step_dt = max(dt - max(0.0, overhead), 1e-9)
            out.append({"name": "TRAIN_STEP_TIME_MS",
                        "value": round(1000.0 * step_dt / d_steps, 3)})
            if self._tokens_per_batch:
                # the batch is the global one: each rank drives one card
                tok_s = (self._tokens_per_batch * d_steps / dt
                         / world_size())
                out.append({"name": "TRAIN_TOKENS_PER_SEC_PER_CHIP",
                            "value": round(tok_s, 2)})
                if self.config.flops_per_token > 0:
                    out.append({"name": "TRAIN_MFU_PCT",
                                "value": round(mfu_pct(
                                    tok_s, self.config.flops_per_token,
                                    self.device), 3)})
        self._perf_t0, self._perf_step0 = now, self.step
        self._perf_phases0 = phases
        return out

    def _evaluate(self) -> float:
        """Mean loss over the fixed held-out set (params only). The losses
        add up on the device; one host read at the end."""
        total = None
        for batch in self._eval_set:
            loss = self.eval_step(self.params, batch).float()
            total = loss if total is None else total + loss
        return float(total) / len(self._eval_set)

    # ------------------------------------------------------------------
    def run(self) -> float:
        """Train to num_steps; returns the final loss."""
        if self.params is None:
            self.setup()
        self._install_sigterm_handler()
        if self.ledger is None or self._metrics_reporter is None:
            # state injected by hand (setup() skipped): account from here
            self.ledger = self.ledger or GoodputLedger(phase="init")
            self._metrics_reporter = TpuMetricsReporter()
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
        self._preempt_requested = False
        loss = None
        pending = None      # (step, device loss, elapsed_s, interval)
        tracer, profile = self._tracer, self._profile
        # step 1's dispatch builds every kernel and allocator pool it
        # touches: the compile phase, in the first_step span
        first_span = (tracer.start("first_step")
                      if tracer is not None and self.step < cfg.num_steps
                      else None)
        if self.step < cfg.num_steps:
            self.ledger.transition("compile" if first_span is not None
                                   else "train_step")
        t0 = time.monotonic()
        last_t, last_step = t0, self.step

        def _flush(p) -> None:
            step, dev_loss, dt, interval = p
            loss_f = float(dev_loss)
            self.last_loss = loss_f
            entry = {"step": step, "loss": loss_f, "elapsed_s": dt}
            entry.update(interval)
            self.metrics_history.append(entry)
            if rank() == 0:
                # %.9g: the loss's f32 value exactly
                LOG.info("step %d loss %.9g (%.4fs)", step, loss_f, dt)

        try:
            while self.step < cfg.num_steps:
                batch = next(self._global_data_iter)
                self._updating = True
                self.params, self.opt_state, loss = self.train_step(
                    self.params, self.opt_state, batch)
                self.step += 1
                self._updating = False
                if self._preempt_requested:
                    raise TrainerPreempted()
                if self._test_step_delay_s:
                    time.sleep(self._test_step_delay_s)
                if profile is not None and profile.active:
                    profile.on_step()
                if not self._tokens_per_batch:
                    self._tokens_per_batch = tokens_in_batch(batch)
                if first_span is not None:
                    tracer.end(first_span, attrs={"step": self.step})
                    first_span = None
                    self._flush_spans()
                    self.ledger.transition("train_step")
                if cfg.log_every and self.step % cfg.log_every == 0:
                    if pending is not None:
                        _flush(pending)
                    now = time.monotonic()
                    interval = {}
                    tokens_per_batch = self._tokens_per_batch
                    if tokens_per_batch and now > last_t:
                        # host time between boundaries: in steady state
                        # the device is a fixed lag behind, so this is
                        # the achieved rate, per card
                        tok_s = (tokens_per_batch * (self.step - last_step)
                                 / (now - last_t) / world_size())
                        interval["tokens_per_s"] = tok_s
                        if peak and cfg.flops_per_token > 0:
                            interval["mfu_pct"] = (100.0 * tok_s
                                                   * cfg.flops_per_token
                                                   / peak)
                    last_t, last_step = now, self.step
                    pending = (self.step, loss, now - t0, interval)
                    perf = self._perf_metrics()
                    self._metrics_reporter.report(extra=perf)
                    if rank() == 0:
                        # the MFU gauge as pushed (%r: the float exactly),
                        # so the AM's series can be held against the log
                        for m in perf:
                            if m["name"] == "TRAIN_MFU_PCT":
                                LOG.info("step %d TRAIN_MFU_PCT %r",
                                         self.step, m["value"])
                    if profile is not None:
                        profile.poll()
                if (cfg.eval_every and self.eval_data_iter is not None
                        and self.step % cfg.eval_every == 0):
                    self.ledger.transition("eval")
                    self.last_eval_loss = self._evaluate()
                    self.ledger.transition("train_step")
                    self.metrics_history.append(
                        {"step": self.step, "eval_loss": self.last_eval_loss})
                    LOG.info("step %d eval_loss %.4f", self.step,
                             self.last_eval_loss)
                if (cfg.checkpoint_dir and cfg.checkpoint_every
                        and self.step % cfg.checkpoint_every == 0):
                    self._checkpoint()
            if pending is not None:
                _flush(pending)
                pending = None
            if loss is not None:    # the loop may not run on exact resume
                self.last_loss = float(loss)
            if cfg.checkpoint_dir and loss is not None:
                self._checkpoint(final=True)
            elif self._checkpointer is not None:
                self._checkpointer.close()
                self._checkpointer = None
        except BaseException as e:
            # the SIGTERM drain and any unhandled error mid-run: commit the
            # current step on the way out, then exit EXIT_PREEMPTED or
            # re-raise
            preempting = isinstance(e, TrainerPreempted)
            self._emergency_checkpoint(
                reason="preemption" if preempting else type(e).__name__)
            if preempting:
                self.preempted = True
                LOG.warning("preempted at step %d — emergency checkpoint "
                            "committed; exiting %d", self.step,
                            C.EXIT_PREEMPTED)
                raise SystemExit(C.EXIT_PREEMPTED) from e
            raise
        finally:
            if pending is not None:
                try:
                    _flush(pending)
                except Exception:  # noqa: BLE001 — the real error wins
                    LOG.debug("could not flush pending log boundary",
                              exc_info=True)
            if isinstance(self._global_data_iter, PrefetchIterator):
                self._global_data_iter.close()
            if first_span is not None:      # failed before step 1 ended
                tracer.end(first_span, "ERROR")
            self._flush_spans()
            if self._profiler_server is not None:
                self._profiler_server.stop()
                self._profiler_server = None
            # close the books: the rest is idle, and the final ledger
            # ships with the last push (never masking the real error)
            try:
                self.ledger.transition("idle")
                self._metrics_reporter.report(extra=self._perf_metrics())
            except Exception:  # noqa: BLE001
                LOG.debug("final goodput report failed", exc_info=True)
            self._metrics_reporter.close()
        return self.last_loss

    # ------------------------------------------------------------------
    def _maybe_start_profiler(self) -> None:
        """Serve the profiler page on the TB port the executor reserved
        and registered with the AM, on the chief only; a second setup()
        keeps the running server. A failure is logged: profiling must
        never stop training."""
        env = os.environ
        port = env.get(C.TB_PORT)
        if (not port or env.get(C.IS_CHIEF, "true") != "true"
                or self._profiler_server is not None):
            return
        try:
            self._profiler_server = ProfilerServer(
                int(port), lambda: self._profile, task=_task_id(env))
            LOG.info("profiler server on port %s", port)
        except Exception:  # noqa: BLE001 — profiling never stops training
            LOG.exception("could not start profiler server")

    def _checkpoint_keep(self) -> int:
        """Retention count: config wins, else TONY_CHECKPOINT_KEEP, else
        3."""
        keep = self.config.checkpoint_keep
        if keep is None:
            try:
                keep = int(os.environ.get(C.CHECKPOINT_KEEP, "") or 3)
            except ValueError:
                keep = 3
        return max(0, keep)

    def _install_sigterm_handler(self) -> None:
        """SIGTERM raises TrainerPreempted in the main thread (handlers
        install only there; elsewhere the process default stays)."""
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except (ValueError, OSError):
            LOG.debug("could not install SIGTERM handler", exc_info=True)

    def _on_sigterm(self, signum, frame) -> None:
        LOG.warning("SIGTERM — draining for emergency checkpoint at step %d",
                    self.step)
        if self._updating:
            # mid-step: the loop raises once the update is whole
            self._preempt_requested = True
            return
        raise TrainerPreempted()

    def _emergency_checkpoint(self, reason: str = "") -> None:
        """One synchronous save of the current state: wait out the
        in-flight async write, then commit this step unless it is on disk
        already. Every failure is logged and swallowed: this runs on the
        way out and must never mask the original error. A step that raised
        part way may have updated some tensors and not others: that state
        is not committed."""
        cfg = self.config
        if not cfg.checkpoint_dir or self.params is None or self.step <= 0:
            return
        try:
            if self._checkpointer is not None:
                try:
                    self._checkpointer.wait()
                except Exception:  # noqa: BLE001 — a prior async failure
                    LOG.exception("in-flight async checkpoint failed "
                                  "during emergency drain")
            if self._updating:
                LOG.error("step %d raised part way through its update; "
                          "not committing that state (the last committed "
                          "step stands)", self.step + 1)
                return
            if latest_step(cfg.checkpoint_dir) == self.step:
                LOG.info("emergency checkpoint: step %d already committed",
                         self.step)
                return
            if self.ledger is not None:
                self.ledger.transition("checkpoint_save")
            save_checkpoint(cfg.checkpoint_dir, self.step, self._state(),
                            keep=self._checkpoint_keep(),
                            pinned=self._restore_pinned)
            if self.ledger is not None:
                self.ledger.transition("idle")
            LOG.warning("emergency checkpoint committed at step %d (%s)",
                        self.step, reason or "unhandled error")
        except BaseException:  # noqa: BLE001 — never mask the real error
            LOG.exception("emergency checkpoint failed")

    def _checkpoint(self, final: bool = False) -> None:
        """Cadence saves are async (the snapshot is synchronous, the file
        IO overlaps the next steps); the final one commits before it
        returns. A final save of a step the cadence just saved waits for
        that commit instead of writing the step again."""
        if self._checkpointer is None:
            self._checkpointer = AsyncCheckpointer(
                self.config.checkpoint_dir, keep=self._checkpoint_keep(),
                pinned=self._restore_pinned)
        tracer, ledger = self._tracer, self.ledger
        span = (tracer.start("checkpoint_save",
                             attrs={"step": self.step, "final": final})
                if tracer is not None else None)
        prev_phase = ledger.phase if ledger is not None else ""
        if ledger is not None:
            ledger.transition("checkpoint_save")
        if not (final and self._checkpointer.last_step == self.step):
            self._checkpointer.save(self.step, self._state())
        if final:
            self._checkpointer.close()
            self._checkpointer = None
        # the async file IO runs on past this by design: only the
        # snapshot (and the final commit) is checkpoint time
        if ledger is not None:
            ledger.transition(prev_phase or "train_step")
        if span is not None:
            tracer.end(span)
            self._flush_spans()
        LOG.info("checkpointed step %d%s", self.step,
                 " (final)" if final else " (async)")
