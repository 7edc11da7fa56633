"""Training entry point: ``python -m tony_tpu_torch.train``.

Counterpart of ``examples/llama-pretrain/pretrain.py`` on one device: it
builds the Llama config from a preset, a `Trainer` running
``make_train_step(llama_loss, adamw)`` on `synthetic_tokens`, trains, and
prints ``final loss X``.

The flags are the JAX script's, plus ``--device`` (default ``cuda``;
``--device cpu`` runs the plain PyTorch versions of the kernels). Flags
for what this slice does not port raise NotImplementedError naming the
slice that brings it: ``--data`` (a token shard, with the data slice),
``--checkpoint-dir``, ``--checkpoint-every``, ``--eval-every`` and
``--master-weights`` (the trainer slice), ``--pp-micro`` and
``--pp-virtual`` (the parallel slice). MoE presets raise in `get_config`.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from functools import partial

DATA_SEED = 0


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tony_tpu_torch.train")
    p.add_argument("--config", default="tiny",
                   help="preset: tiny|bench_350m|llama3_1b_proxy|"
                        "llama3_8b|llama3_70b")
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
                   help="held-out eval cadence (not yet ported)")
    p.add_argument("--master-weights", action="store_true",
                   help="f32 master copy for bf16 params (not yet ported)")
    p.add_argument("--checkpoint-dir", default="",
                   help="checkpoint directory (not yet ported)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint cadence (not yet ported)")
    p.add_argument("--data", default="",
                   help="raw int32 token shard (not yet ported)")
    p.add_argument("--pp-micro", type=int, default=0,
                   help="pipeline microbatches (not yet ported)")
    p.add_argument("--pp-virtual", type=int, default=1,
                   help="virtual pipeline stages (not yet ported)")
    return p


def _refuse_unported(args) -> None:
    """Raise NotImplementedError for every flag this slice does not port."""
    unported = [
        (bool(args.data), "--data", "the data slice (a token shard in the "
                                    "repository)"),
        (bool(args.checkpoint_dir), "--checkpoint-dir", "the trainer slice"),
        (args.checkpoint_every > 0, "--checkpoint-every",
         "the trainer slice"),
        (args.eval_every > 0, "--eval-every", "the trainer slice"),
        (args.master_weights, "--master-weights", "the trainer slice"),
        (args.pp_micro > 0, "--pp-micro", "the parallel slice"),
        (args.pp_virtual != 1, "--pp-virtual", "the parallel slice"),
    ]
    for hit, what, slice_name in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to tony_tpu_torch yet; it arrives "
                f"with {slice_name} (ROADMAP.md, queue 1)")


def build_trainer(args):
    """The Trainer the entry point runs, and its model config."""
    from tony_tpu_torch.models.llama import get_config, llama_init, llama_loss
    from tony_tpu_torch.train.data import synthetic_tokens
    from tony_tpu_torch.train.trainer import Trainer, TrainerConfig

    _refuse_unported(args)
    overrides = {"n_layers": args.n_layers} if args.n_layers else {}
    config = get_config(args.config, **overrides)
    seq = args.seq_len or config.max_seq
    process_index = int(os.environ.get("RANK", "0"))
    trainer = Trainer(
        loss_fn=partial(llama_loss, config=config),
        init_fn=partial(llama_init, config),
        data_iter=synthetic_tokens(args.batch_size, seq, config.vocab_size,
                                   seed=DATA_SEED,
                                   process_index=process_index),
        config=TrainerConfig(num_steps=args.steps, log_every=args.log_every,
                             grad_accum=args.grad_accum,
                             flops_per_token=config.flops_per_token(seq)),
        device=args.device)
    return trainer, config


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    trainer, _ = build_trainer(args)
    final_loss = trainer.run()
    print(f"final loss {final_loss:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
