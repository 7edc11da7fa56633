"""A training cell: the port's `Trainer`, built as `python -m
tony_tpu_torch.train` builds it (its default AdamW under the warmup-cosine
schedule, its prefetching input pipeline, no checkpoint, no AM), on the
configuration file's model and the mix's batches.

Set-up builds the Trainer, runs its first two steps through `run()` (the
first builds every kernel and allocator pool the step touches; they are
also the steps the reference follows) and reads the program's numbers for
the comparison. The window hands the same Trainer `n` more steps, one
`run()`, with `n` the window's length over the second step's time. A
traced run (--trace 1) traces its last `trace_steps` steps in a run() of
their own.
"""

from __future__ import annotations

import gc
import time
from functools import partial

import numpy as np
import torch

from portbench import compare, faults, traffic as tr, weights
from portbench.program import port_config
from portbench.reference import llama as reference
from portbench.trace import traced


def _leaf_tensors(params: dict) -> dict:
    return {p: weights.get_leaf(params, p) for p in weights.leaf_paths(params)}


def _norm_of_diff(a: torch.Tensor, b=None, rows: int = 1 << 24) -> float:
    """|a - b| (b a tensor, a number or None), in f32 slices of the leading
    dim, summed in f64: no full-size temporary beside the program's
    state."""
    step = max(1, rows // max(1, a[0].numel()))
    total = 0.0
    with torch.no_grad():
        for i in range(0, a.shape[0], step):
            d = a[i:i + step].float()
            if isinstance(b, torch.Tensor):
                d = d - b[i:i + step].float()
            elif b is not None:
                d = d - b
            total += float(d.double().pow(2).sum())
    return total ** 0.5


def _mu_norms(trainer, b1: float) -> dict:
    """|first gradient| per leaf from Adam's first moment after one step."""
    state = trainer.opt_state.optimizer.state
    return {p: _norm_of_diff(state[t]["exp_avg"]) / (1 - b1)
            for p, t in _leaf_tensors(trainer.params).items()}


def _change_norms(trainer, cfg: dict, seed: int) -> dict:
    """|p - p0| per leaf, p0 drawn again one leaf at a time; the norms' p0
    are ones."""
    live = _leaf_tensors(trainer.params)
    out = {}
    with torch.no_grad():
        for path, p0 in weights.drawn_leaves(cfg, seed, live["embed"].device):
            out[path] = _norm_of_diff(live[path], p0)
            del p0
        for path, t in live.items():
            if path not in out:
                out[path] = _norm_of_diff(t, 1.0)
    return out


def build_trainer(cfg: dict, mix: dict, seed: int, device: str,
                  fault: str = ""):
    """(the Trainer, the port's config) for one run, set up."""
    from tony_tpu_torch.models.llama import llama_loss, llama_param_axes
    from tony_tpu_torch.models.moe import moe_loss, moe_param_axes
    from tony_tpu_torch.train.trainer import Trainer, TrainerConfig

    config = port_config(cfg, remat=True, remat_policy=mix["remat_policy"],
                         xent_chunk=int(mix["xent_chunk"]))
    moe = bool(cfg.get("num_local_experts"))
    opt = mix["optimizer"]
    loss_fn = partial(moe_loss if moe else llama_loss, config=config)
    trainer = Trainer(
        loss_fn=faults.wrap_loss(loss_fn, fault),
        init_fn=lambda g: weights.make_params(cfg, seed, g.device),
        data_iter=tr.train_batches(mix, seed, cfg["vocab_size"]),
        config=TrainerConfig(num_steps=int(mix["schedule_steps"]),
                             log_every=int(mix["log_every"]),
                             learning_rate=opt["lr"],
                             warmup_steps=int(opt["warmup_steps"]),
                             weight_decay=opt["weight_decay"],
                             flops_per_token=config.flops_per_token(
                                 int(mix["seq"]))),
        device=device,
        param_axes=(moe_param_axes if moe else llama_param_axes)(config))
    trainer.setup()
    faults.after_setup(trainer, fault)
    return trainer, config


def first_two_steps(trainer, cfg: dict, mix: dict, seed: int):
    """Steps 1 and 2 through `run()`, and the program's numbers for the
    comparison: (prog, the second step's seconds, the readings' seconds)."""
    reading_s = 0.0
    trainer.config.num_steps = 1
    trainer.run()
    losses = [trainer.last_loss]
    t = time.monotonic()
    grad_norm = _mu_norms(trainer, mix["optimizer"]["b1"])
    reading_s += time.monotonic() - t
    trainer.config.num_steps = 2
    t = time.monotonic()
    trainer.run()
    step_s = time.monotonic() - t
    losses.append(trainer.last_loss)
    t = time.monotonic()
    change_norm = _change_norms(trainer, cfg, seed)
    reading_s += time.monotonic() - t
    return ({"loss": losses, "grad_norm": grad_norm,
             "change_norm": change_norm}, step_s, reading_s)


def free(trainer) -> torch.device:
    """Drop the program's state (the reference runs after); its device."""
    dev = trainer.device
    trainer.params = trainer.opt_state = trainer.train_step = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dev


def reference_steps(cfg: dict, mix: dict, seed: int, dev, config,
                    precision: str = "f32") -> dict:
    """The reference's two steps from the seed's weights and batches."""
    opt = mix["optimizer"]
    reference.plain_float32()
    params0 = weights.make_params(cfg, seed, dev)
    batches = [torch.from_numpy(b["tokens"]).long().to(dev)
               for b in tr.first_batches(mix, seed, cfg["vocab_size"], 2)]
    lr = reference.warmup_cosine(0.0, opt["lr"], opt["warmup_steps"],
                                 max(int(mix["schedule_steps"]),
                                     opt["warmup_steps"] + 1))
    moe = bool(cfg.get("num_local_experts"))
    out = reference.follow_two_steps(
        cfg, params0, batches,
        {"lr": lr, "b1": opt["b1"], "b2": opt["b2"], "eps": opt["eps"],
         "weight_decay": opt["weight_decay"]}, precision=precision,
        capacity_factor=config.capacity_factor if moe else None)
    del params0, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device: str, t_start: float, fault: str = "",
        files: tuple = (), control: bool = False) -> dict:
    trainer, config = build_trainer(cfg, mix, seed, device, fault)
    prog, step_s, reading_s = first_two_steps(trainer, cfg, mix, seed)
    n = max(2, round(seconds / step_s))
    k = min(n - 1, int(mix["trace_steps"])) if trace else 0
    setup_s = time.monotonic() - t_start - reading_s
    stall_s, tr_box = 0.0, {}
    t0 = time.monotonic()
    trainer.config.num_steps = 2 + n - k
    trainer.run()
    stall_s += trainer._global_data_iter.stall_snapshot()[0]
    if k:
        with traced(tr_box):
            trainer.config.num_steps = 2 + n
            trainer.run()
        stall_s += trainer._global_data_iter.stall_snapshot()[0]
    window_s = time.monotonic() - t0
    final = trainer.last_loss
    on_card = trainer.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    dev = free(trainer)
    del trainer
    ref = reference_steps(cfg, mix, seed, dev, config)
    ctrl = None
    if control:         # the reference in fp8, in the program's place
        ctrl = compare.training_readings(
            reference_steps(cfg, mix, seed, dev, config, "fp8"), ref)
    batch, seq = int(mix["batch"]), int(mix["seq"])
    return {
        "setup_s": setup_s, "window_s": window_s, "peak_bytes": peak,
        "attempted": n, "failed": 0 if np.isfinite(final) else n,
        "readings": compare.training_readings(prog, ref),
        "control_readings": ctrl,
        "trace": tr_box or None,
        "counters": {"steps": n, "tokens_per_step": batch * seq,
                     "batch": batch, "seq": seq, "stall_s": stall_s,
                     "traced_steps": k},
    }
