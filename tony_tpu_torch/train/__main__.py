"""Training entry point: ``python -m tony_tpu_torch.train``.

Counterpart of ``examples/llama-pretrain/pretrain.py`` on one device: it
builds the config from a preset, a `Trainer` running
``make_train_step(llama_loss, adamw)`` (``moe_loss`` and ``moe_init`` for
an MoE preset, ``moe_tiny`` or ``mixtral_proxy``, whose MFU is reckoned on
the active parameters) on `synthetic_tokens` (or, with ``--data``, on
random windows of a raw int32 token shard), trains, and prints ``final
loss X``.

The flags are the JAX script's, plus ``--device`` (default ``cuda``;
``--device cpu`` runs the plain PyTorch versions of the kernels) and
``--log-every``. ``--checkpoint-dir`` (a directory or a ``gs://``
location) resumes from the latest step there and checkpoints at the end
(and every ``--checkpoint-every`` steps);
``--eval-every`` scores a fixed held-out batch from the same source as
training with a disjoint seed, as the JAX script does: shard windows with
seed ``1_000_000 + process_index`` (training uses ``process_index``), or
``synthetic_tokens`` with seed 1. ``--master-weights`` keeps f32 masters.
A SIGTERM commits an emergency checkpoint and exits 12.

Run as a TonY task (``--executes`` a script that calls this module), it
logs structured JSON lines, runs the sampling profiler, and its Trainer
reports spans, goodput and step metrics to the AM, keeps its kernel builds
under ``$TONY_JAX_CACHE_DIR`` and, on the chief, serves on-demand profiles
on ``TB_PORT``; outside the orchestrator those are no-ops. ``--pp-micro`` and ``--pp-virtual``
raise NotImplementedError (the parallel slice).
"""

from __future__ import annotations

import argparse
import os
import sys
from functools import partial

DATA_SEED = 0
EVAL_SEED = 1
# a shard's held-out windows: seed offset from the training stream's
SHARD_EVAL_SEED = 1_000_000


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tony_tpu_torch.train")
    p.add_argument("--config", default="tiny",
                   help="preset: tiny|bench_350m|llama3_1b_proxy|"
                        "llama3_8b|llama3_70b|moe_tiny|mixtral_proxy")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda or cpu)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=0,
                   help="0 = the preset's max_seq")
    p.add_argument("--n-layers", type=int, default=0,
                   help="override the preset's layer count (0 = preset)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatch gradient-accumulation steps")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=0,
                   help="held-out eval cadence in steps (0 = off)")
    p.add_argument("--master-weights", action="store_true",
                   help="f32 master copy for bf16 params")
    p.add_argument("--checkpoint-dir", default="",
                   help="checkpoint directory: resume from its latest "
                        "step, save at the end")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint cadence in steps (0 = only at the "
                        "end)")
    p.add_argument("--data", default="",
                   help="raw int32 token shard (write_token_file); "
                        "default: synthetic tokens")
    p.add_argument("--pp-micro", type=int, default=0,
                   help="pipeline microbatches (not yet ported)")
    p.add_argument("--pp-virtual", type=int, default=1,
                   help="virtual pipeline stages (not yet ported)")
    return p


def _refuse_unported(args) -> None:
    """Raise NotImplementedError for every flag this slice does not port."""
    unported = [
        (args.pp_micro > 0, "--pp-micro", "the parallel slice"),
        (args.pp_virtual != 1, "--pp-virtual", "the parallel slice"),
    ]
    for hit, what, slice_name in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to tony_tpu_torch yet; it arrives "
                f"with {slice_name} (ROADMAP.md, queue 1)")


def _streams(args, seq: int, vocab_size: int, process_index: int):
    """(training stream, held-out stream or None), from the shard with
    pretrain.py's seeds or from synthetic_tokens."""
    from tony_tpu_torch.train.data import synthetic_tokens
    from tony_tpu_torch.train.native_data import token_batches

    if args.data:
        train = token_batches(args.data, args.batch_size, seq,
                              seed=process_index)
        held = (token_batches(args.data, args.batch_size, seq,
                              seed=SHARD_EVAL_SEED + process_index)
                if args.eval_every else None)
        return train, held
    train = synthetic_tokens(args.batch_size, seq, vocab_size,
                             seed=DATA_SEED, process_index=process_index)
    held = (synthetic_tokens(args.batch_size, seq, vocab_size,
                             seed=EVAL_SEED, process_index=process_index)
            if args.eval_every else None)
    return train, held


def build_trainer(args):
    """The Trainer the entry point runs, and its model config."""
    from tony_tpu_torch.models.llama import get_config, llama_init, llama_loss
    from tony_tpu_torch.models.moe import (
        get_moe_config, is_moe_preset, moe_init, moe_loss,
    )
    from tony_tpu_torch.train.trainer import Trainer, TrainerConfig

    _refuse_unported(args)
    overrides = {"n_layers": args.n_layers} if args.n_layers else {}
    if is_moe_preset(args.config):
        config = get_moe_config(args.config, **overrides)
        init_fn, loss_fn = moe_init, moe_loss
    else:
        config = get_config(args.config, **overrides)
        init_fn, loss_fn = llama_init, llama_loss
    seq = args.seq_len or config.max_seq
    process_index = int(os.environ.get("RANK", "0"))
    data_iter, eval_iter = _streams(args, seq, config.vocab_size,
                                    process_index)
    trainer = Trainer(
        loss_fn=partial(loss_fn, config=config),
        init_fn=partial(init_fn, config),
        data_iter=data_iter,
        config=TrainerConfig(num_steps=args.steps, log_every=args.log_every,
                             checkpoint_dir=args.checkpoint_dir,
                             checkpoint_every=args.checkpoint_every,
                             grad_accum=args.grad_accum,
                             eval_every=args.eval_every,
                             master_weights=args.master_weights,
                             # an MoE config's counts active parameters
                             flops_per_token=config.flops_per_token(seq)),
        device=args.device,
        # held-out batches from a disjoint seed of the same source
        eval_data_iter=eval_iter)
    return trainer, config


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    trainer, _ = build_trainer(args)
    final_loss = trainer.run()
    print(f"final loss {final_loss:.4f}")
    return 0


if __name__ == "__main__":
    from tony_tpu_torch.observability.profiler import (
        install_task_observability,
    )
    install_task_observability("train")
    sys.exit(main())
