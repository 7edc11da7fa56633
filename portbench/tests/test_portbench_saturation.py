"""An open-loop mix offered `above_capacity`: its backlog is cut at the
window's close (cut requests are not failures), the run reports what it
was offered beside what it served, and a run whose engine was not
saturated fails."""

import pytest

from pb_tiny import LIMITS, SATURATED, bench, run


def test_the_backlog_is_cut_at_the_close_and_not_failed(tmp_path):
    out = run(tmp_path, "saturated", limits=LIMITS["saturated"])
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    load = out["load"]
    assert load["served_share"] <= 0.8
    first, last = load["queue_wait_quarters_s"]
    assert last > first
    assert out["metrics"]["prompt_tokens_per_s"]["value"] == pytest.approx(
        load["prompt_tokens_per_s"])
    assert out["attempted"] == pytest.approx(2.0 * SATURATED["rate_per_s"])


def test_a_run_below_capacity_fails(tmp_path):
    with pytest.raises(RuntimeError, match="not saturated"):
        run(tmp_path, "low", limits=LIMITS["saturated"])


def test_the_traced_steps_note_the_prompts_they_admit(tmp_path):
    import json
    import os
    import time

    from portbench import serve_cell

    b = bench(str(tmp_path))
    files = (os.path.join(tmp_path, "configs", "moe.json"),
             os.path.join(tmp_path, "traffic", "saturated.json"))
    cfg, mix = (json.load(open(f)) for f in files)
    res = serve_cell.run(b["workloads"][0], cfg, mix, 11, 2.0, True, "cpu",
                         time.monotonic(), files=files, check=False)
    admitted = res["trace"]["admitted_prompts"]
    sent = {len(r.req.prompt) for r in res["records"]}
    assert admitted and set(admitted) <= sent
    # the counters cover the window's part before the trace
    assert res["counters"]["admitted_prompts"]
