"""Generate from a Llama (or MoE) preset: the port of
``examples/llama-generate/generate_demo.py``.

Restores the params of ``--checkpoint-dir``'s latest step (a checkpoint of
either package) or takes a random init from a fixed seed, then runs the
KV-cache decode loop (`models/generate.py`) or, with ``--draft-config``,
lossless greedy speculative decoding (`models/speculative.py`), prints the
token ids of each sample and ``GENERATE_OK``. Prompts are synthetic token
ids; `generate_text` handles real tokenizers.

    python -m tony_tpu_torch.examples.generate_demo --config tiny \\
        --draft-config tiny --gamma 4 --device cpu

The flags are the JAX script's plus ``--device`` (default ``cuda``). An
MoE preset (``moe_tiny``, ``mixtral_proxy``) is served at no-drop
capacity, so incremental decode equals the training forward.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.environ.get(
        "TONY_REPO_ROOT",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")))

# the seeds of the JAX script's PRNG keys: target, prompt, sampling, draft
INIT_SEED, PROMPT_SEED, SAMPLE_SEED, DRAFT_SEED = 0, 1, 2, 3


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tony_tpu_torch.examples."
                                          "generate_demo")
    parser.add_argument("--config", default="tiny")
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--prompt-len", type=int, default=8)
    parser.add_argument("--max-new", type=int, default=16)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--top-p", type=float, default=1.0,
                        help="nucleus sampling mass (<1.0 truncates the "
                             "tail; composes with --top-k)")
    parser.add_argument("--quant", default="", choices=("", "int8"),
                        help="int8 = weight-only quantized decode")
    parser.add_argument("--quant-cache", action="store_true",
                        help="per-row int8 KV cache")
    parser.add_argument("--draft-config", default="",
                        help="smaller preset (same vocab) to drive "
                             "lossless greedy speculative decoding; the "
                             "draft's weights are a random init")
    parser.add_argument("--gamma", type=int, default=4,
                        help="drafted tokens per speculative round")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda or cpu)")
    return parser


def _model(name: str, device, seed: int):
    """(config, params) of a dense or MoE preset, random from `seed`; an
    MoE preset at no-drop capacity."""
    import torch

    from tony_tpu_torch.models.llama import get_config, llama_init
    from tony_tpu_torch.models.moe import (
        get_moe_config, is_moe_preset, moe_init,
    )
    if is_moe_preset(name):
        base = get_moe_config(name)
        config = get_moe_config(name, capacity_factor=max(
            base.capacity_factor, base.n_experts / base.top_k))
        init = moe_init
    else:
        config, init = get_config(name), llama_init
    generator = torch.Generator(device=device).manual_seed(seed)
    with torch.inference_mode():
        return config, init(config, generator)


def run(argv=None) -> dict:
    """The demo: prints the samples and GENERATE_OK. Returns {"tokens",
    "prompt", "params", "config", "draft_params", "draft_config",
    "stats"} (the draft entries None without --draft-config)."""
    import torch

    from tony_tpu_torch.device import resolve_device
    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.utils.compilecache import maybe_enable_compile_cache

    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    maybe_enable_compile_cache()
    config, params = _model(args.config, device, INIT_SEED)
    if args.checkpoint_dir:
        from tony_tpu_torch.models.convert import empty_params
        from tony_tpu_torch.train.checkpoint import (
            latest_step, restore_params,
        )
        step = latest_step(args.checkpoint_dir)
        if step is None:
            raise SystemExit(
                f"no checkpoint found in {args.checkpoint_dir}")
        # the params alone, whatever optimizer state lies beside them
        params = restore_params(args.checkpoint_dir, step,
                                empty_params(config, device))
        print(f"restored checkpoint step {step}")
    if args.quant == "int8":
        from tony_tpu_torch.models.quant import (
            quantize_params, quantized_bytes,
        )
        with torch.inference_mode():
            params = quantize_params(params)
        now, full = quantized_bytes(params)
        print(f"int8 weight-only: {now / 1e6:.1f} MB streamed per token "
              f"vs {full / 1e6:.1f} MB bf16")
    gen = torch.Generator(device=device).manual_seed(PROMPT_SEED)
    prompt = torch.randint(0, config.vocab_size,
                           (args.batch_size, args.prompt_len),
                           generator=gen, device=device)
    if args.quant_cache:
        print("int8 KV cache: per-row scales, half the cache bytes/step")
    draft_config = draft = None
    stats: dict = {}
    if args.draft_config:
        from tony_tpu_torch.models.speculative import speculative_generate
        if args.temperature > 0:
            raise SystemExit("speculative decoding is greedy-only")
        draft_config, draft = _model(args.draft_config, device, DRAFT_SEED)
        print(f"speculative: draft={args.draft_config} gamma={args.gamma} "
              f"(lossless greedy)")
        toks = speculative_generate(params, draft, config, draft_config,
                                    prompt, args.max_new, gamma=args.gamma,
                                    quant_cache=args.quant_cache,
                                    stats=stats)
        print(f"speculative: {stats['rounds']} rounds, "
              f"{stats['accepted']} drafted tokens accepted")
    else:
        sampler = torch.Generator(device=device).manual_seed(SAMPLE_SEED)
        toks = generate(params, config, prompt, args.max_new,
                        temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, generator=sampler,
                        quant_cache=args.quant_cache)
    for i, row in enumerate(toks.tolist()):
        print(f"sample {i}: {row}")
    print("GENERATE_OK")
    return {"tokens": toks, "prompt": prompt, "params": params,
            "config": config, "draft_params": draft,
            "draft_config": draft_config, "stats": stats}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
