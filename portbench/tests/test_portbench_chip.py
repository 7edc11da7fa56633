"""On the card: the tiny cells through the whole harness, traced, so the
trace's reduction meets real device events (kernels by name, busy time,
the flash kernels' bounds). Run there with
`python3 -m pytest portbench/tests -q -m chip`."""

import pytest

from pb_tiny import bench


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["train", "open", "closed"])
def test_tiny_cells_traced_on_the_card(card, tmp_path, workload):
    import os
    import time

    from portbench.run import run_cell
    b = bench(tmp_path)
    out = run_cell(b, workload, 2**31 + 99, 3.0, True, device="cuda",
                   t_start=time.monotonic(), root=str(tmp_path),
                   traffic_dir=os.path.join(tmp_path, "traffic"),
                   limits={})
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["busy_s"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert out["breakdown"]["device_ops"]
