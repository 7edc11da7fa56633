"""The control, kept at a size a test run holds: the reference computed in
fp8 in the program's place reads farther from the f32 reference than the
bf16 program does, on at least one number, by three times or more. The
cells' own readings at full size are in PERF.md and come from
`portbench/calibrate.py` on the card."""

import pytest
import torch

from portbench import compare, traffic as tr, weights
from portbench.reference import llama as ref
from pb_tiny import DENSE, LIMITS, MOE, TRAIN, run


def _ref_steps(cfg, seed, precision):
    params = weights.make_params(cfg, seed, "cpu")
    batches = [torch.from_numpy(b["tokens"]).long()
               for b in tr.first_batches(TRAIN, seed, cfg["vocab_size"], 2)]
    opt = TRAIN["optimizer"]
    lr = ref.warmup_cosine(0.0, opt["lr"], opt["warmup_steps"], 100)
    return ref.follow_two_steps(
        cfg, params, batches,
        {"lr": lr, "b1": opt["b1"], "b2": opt["b2"], "eps": opt["eps"],
         "weight_decay": opt["weight_decay"]}, precision=precision,
        capacity_factor=1.25 if cfg.get("num_local_experts") else None)


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40])
def test_training_control_reads_farther_than_the_program(tmp_path, seed):
    program = run(tmp_path, "train", seed=seed)
    prog = {k: v["value"] for k, v in program["checks"].items()}
    f32 = _ref_steps(DENSE, seed, "f32")
    low = compare.training_readings(_ref_steps(DENSE, seed, "fp8"), f32)
    assert any(low[k] >= 3 * prog[k] for k in ("loss_rel", "grad_gap"))


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_serving_control_reads_farther_than_the_program(seed):
    cfg = MOE
    params = weights.make_params(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    seqs = [torch.randint(0, cfg["vocab_size"], (n,), generator=g)
            for n in (40, 64)]
    rows = [torch.arange(10, s.numel()) for s in seqs]
    f32 = ref.logits_at(cfg, params, seqs, rows)
    low = ref.logits_at(cfg, params, seqs, rows, precision="fp8")
    ctrl = max(g for a, b in zip(f32, low)
               for g in compare.served_gaps(a, b.argmax(-1).tolist()))
    assert ctrl > 0.05


@pytest.mark.parametrize("workload", ["train", "closed"])
def test_the_control_in_the_programs_place_is_not_correct(tmp_path,
                                                          workload):
    """The control goes through the run's own comparison, by the cell's
    limits, and comes out not correct. At this size the MoE's fp8 control
    serves the f32 reference's tokens (its mean gap reads 0), so the
    open-loop cells' control is run on the card
    (`calibrate.py --control-runs`, readings in PERF.md)."""
    out = run(tmp_path, workload, limits=LIMITS[workload], control=True)
    assert not out["correct"], out["checks"]
    program = compare.checks(out["readings"], LIMITS[workload])
    assert compare.passed(program), program
