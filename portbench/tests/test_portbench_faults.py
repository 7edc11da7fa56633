"""The comparison catches the faults a cell can have: a run of the
harness with the chip check skipped and the timed path broken underneath
comes out not correct, and the same run unbroken comes out correct, by
the tiny cells' limits (`pb_tiny.LIMITS`, with the readings they were set
from)."""

import pytest

from pb_tiny import LIMITS, run


def test_train_unbroken_is_correct(tmp_path):
    out = run(tmp_path, "train", limits=LIMITS["train"])
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault,caught_by", [
    ("unchanged_state", "change_gap"),
    ("half_batch", "grad_gap"),
])
def test_train_fault_is_caught(tmp_path, fault, caught_by):
    out = run(tmp_path, "train", fault=fault, limits=LIMITS["train"])
    assert not out["correct"]
    c = out["checks"][caught_by]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("workload", ["open", "closed"])
def test_serve_unbroken_is_correct(tmp_path, workload):
    out = run(tmp_path, workload, limits=LIMITS[workload])
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


@pytest.mark.parametrize("workload", ["open", "closed"])
def test_serve_altered_token_is_caught(tmp_path, workload):
    out = run(tmp_path, workload, fault="altered_token",
              limits=LIMITS[workload])
    assert not out["correct"], out["checks"]
