#!/usr/bin/env python3
"""What NVML and /proc show of CUDA processes on this machine.

The executor's card reader (`tony_tpu_torch/executor/cuda_metrics.py`)
attributes cards to a task's processes by the pids NVML lists, and falls
back to what /proc shows of them where NVML's pids are in another pid
namespace. This prints, for three child processes (one holding a context
with 1 GiB, one with 3 GiB, one that only initialises CUDA), the entries
NVML lists on each card and the /dev/nvidia* files each child maps, and
whether NVML's pids are the children's. Run it on the card:

    python3 tools/nvml_probe.py

It needs torch with CUDA (in the children only) and `libnvidia-ml.so.1`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

HOLDER = ("import sys, time, torch\n"
          "x = torch.empty(int(sys.argv[1]) << 30, dtype=torch.uint8,"
          " device='cuda')\n"
          "torch.cuda.synchronize()\n"
          "print('ready', flush=True)\n"
          "time.sleep(30)\n")
INIT_ONLY = ("import time, torch\n"
             "torch.cuda.init()\n"
             "print('ready', flush=True)\n"
             "time.sleep(30)\n")


def main() -> int:
    from tony_tpu_torch.executor.cuda_metrics import (
        NvmlReader, mapped_devices,
    )

    reader = NvmlReader()
    before = reader.sample()
    print("cards:", [(d.index, f"/dev/nvidia{d.minor}",
                      round(d.memory_total / 2**30, 1)) for d in before])
    print("NVML entries before the children:",
          [d.processes for d in before])
    children = {
        "holder 1 GiB": [sys.executable, "-c", HOLDER, "1"],
        "holder 3 GiB": [sys.executable, "-c", HOLDER, "3"],
        "cuInit only": [sys.executable, "-c", INIT_ONLY]}
    procs = {}
    try:
        for name, cmd in children.items():
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           text=True)
        for proc in procs.values():
            proc.stdout.readline()
        time.sleep(1.0)
        after = reader.sample()
        pids = {proc.pid for proc in procs.values()}
        for d in after:
            print(f"card {d.index}: NVML entries (pid, GiB) "
                  f"{[(p, None if u is None else round(u / 2**30, 3)) for p, u in d.processes]}"
                  f"; utilization {d.utilization_pct}%")
            print(f"card {d.index}: NVML pids that are the children's: "
                  f"{sorted(pids & {p for p, _ in d.processes})}")
        for name, proc in procs.items():
            print(f"{name} (pid {proc.pid}) maps "
                  f"{sorted(mapped_devices(proc.pid))}")
        print(f"this process (NVML only, pid {os.getpid()}) maps "
              f"{sorted(mapped_devices(os.getpid()))}")
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait(timeout=30)
        reader.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
