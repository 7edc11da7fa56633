"""Long-context Llama pretraining with the sequence split over ``sp``: the
port of ``examples/longcontext-ring/pretrain_long.py``.

The sequence axis is sharded over the mesh's ``sp`` axis and attention
runs as the ring (`parallel/ring.py`: K/V chunks travel around the sp
ranks, each visit one flash launch on the chunk, so a rank's attention
memory is O(S / sp x D) whatever the context) or, with ``--sp-mode
ulysses``, as Ulysses (`parallel/ulysses.py`: two all-to-alls, whole
sequences of H / sp heads). On a mesh without sp (or an sp of 1) the
model runs the flash kernels on the whole sequence
(`models/llama.py` `_attention_dispatch`).

``--seq-len`` sets the context: ``max_seq`` follows it, so the RoPE
tables span it, and ``rope_orig_max_seq`` stays the preset's window, so
``--rope-scaling F`` (the Llama-3.1 rescale) anchors to the window the
model was, or would be, pretrained at. The ``seq % sp`` fit is checked
from the env before any parameter exists.

    python -m tony_tpu_torch.examples.pretrain_long --config tiny \\
        --seq-len 256 --steps 3 --device cpu

As a TonY gang (framework ``pytorch`` or ``jax``) every rank joins one
process group from the rendezvous env the executor renders and trains on
the mesh of ``TPU_MESH_SHAPE`` / ``TPU_MESH_AXES`` (``fsdp,sp`` for
instance). The flags are the JAX script's plus ``--device`` (default
``cuda``). One difference: the JAX script seeds each process's token
stream by its process id, and the port by the rank's (dp, fsdp)
coordinate, as `python -m tony_tpu_torch.train` does: the ranks that
hold the parts of one sequence must draw the same rows. In a world of one
both seeds are 0.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from functools import partial

if __package__ in (None, ""):
    sys.path.insert(0, os.environ.get(
        "TONY_REPO_ROOT",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")))


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tony_tpu_torch.examples."
                                          "pretrain_long")
    parser.add_argument("--config", default="tiny")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--seq-len", type=int, default=0,
                        help="global context length; 0 = preset max_seq")
    parser.add_argument("--sp-mode", default="ring",
                        choices=("ring", "ulysses"))
    parser.add_argument("--rope-scaling", type=float, default=0.0,
                        help="Llama-3.1-style RoPE rescale factor for "
                             "contexts beyond the preset's max_seq (0=off)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda or cpu)")
    return parser


def long_config(args):
    """(the model config, the global sequence length) the flags ask for:
    the JAX script's overrides of the preset."""
    from tony_tpu_torch.models.llama import get_config

    base = get_config(args.config, sp_mode=args.sp_mode)
    seq = args.seq_len or base.max_seq
    overrides = dict(sp_mode=args.sp_mode)
    if args.seq_len:
        overrides.update(max_seq=seq, rope_orig_max_seq=base.max_seq)
    if args.rope_scaling:
        overrides.update(rope_scaling_factor=args.rope_scaling)
    return get_config(args.config, **overrides), seq


def main(argv=None) -> int:
    import torch.distributed as dist

    from tony_tpu_torch.device import resolve_device
    from tony_tpu_torch.models.llama import (
        llama_init, llama_loss, llama_param_axes,
    )
    from tony_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed, rank, world_size,
    )
    from tony_tpu_torch.parallel.mesh import data_index, plan_from_env
    from tony_tpu_torch.train.data import synthetic_tokens
    from tony_tpu_torch.train.trainer import Trainer, TrainerConfig

    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    config, seq = long_config(args)

    # validate the seq/sp fit from the rendered env BEFORE any parameter
    # exists: the mesh `mesh_from_env` builds in the Trainer's setup
    owned = not dist.is_initialized()
    maybe_initialize_distributed(device)
    world = world_size()
    sp = plan_from_env(world)[0].shape.get("sp", 1)
    if seq % max(sp, 1) != 0:
        raise SystemExit(f"--seq-len {seq} must divide by sp={sp}")
    process_index = data_index(world, rank()) if world > 1 else rank()

    trainer = Trainer(
        loss_fn=partial(llama_loss, config=config),
        init_fn=partial(llama_init, config),
        data_iter=synthetic_tokens(args.batch_size, seq, config.vocab_size,
                                   process_index=process_index),
        config=TrainerConfig(num_steps=args.steps, log_every=10),
        device=device, param_axes=llama_param_axes(config))
    try:
        final_loss = trainer.run()
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    print(f"final loss {final_loss:.4f} (seq={seq}, sp_mode={args.sp_mode})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
