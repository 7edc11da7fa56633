#!/usr/bin/env python3
"""Run `python -m tony_tpu_torch.train` as a gang of local ranks, one per
card, and print its losses and step time.

    python3 tools/gang_run.py --nproc 4 --mesh-shape 2,2 --mesh-axes fsdp,tp \
        -- --config llama3_1b_proxy --batch-size 4 --seq-len 4096 --steps 5

Each rank is a process with the env TonY's pytorch runtime renders
(WORLD, RANK, INIT_METHOD on a free local port) plus TPU_MESH_SHAPE and
TPU_MESH_AXES, so the ranks rendezvous and train exactly as a gang of
TonY workers would; rank r takes card r. `--nproc 1` with no mesh runs
the plain single-card path for comparison. The arguments after `--` go
to the entry point (`--log-every 1` is added). A rank that exits
non-zero, or a gang past `--timeout` seconds, ends every rank and the
script exits non-zero.

Prints the card's name and power limit (nvidia-smi), rank 0's step
losses (the f32 values exactly), its median step interval over steps 3
to the last (the Trainer's log boundaries: in steady state the host
waits one step of device time between two), and, last, one JSON object
with the same numbers, each rank's logged kernel launches and each
rank's peak device memory.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

STEP = re.compile(r"step (\d+) loss (\S+) \((\S+)s\)")
LAUNCHES = re.compile(r"kernel launches (\{.*\})")
PEAK = re.compile(r"peak device memory (\S+) GiB")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_gang(nproc: int, mesh_shape: str, mesh_axes: str, train_args,
             timeout: float) -> dict:
    """Start the ranks, wait for all of them, parse rank 0's step lines."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = dict(os.environ, PYTHONPATH=repo, TONY_LOG_PLAIN="1")
    if nproc > 1 or mesh_shape:
        base.update(WORLD=str(nproc),
                    INIT_METHOD=f"tcp://127.0.0.1:{_free_port()}")
    if mesh_shape:
        base.update(TPU_MESH_SHAPE=mesh_shape, TPU_MESH_AXES=mesh_axes)
    cmd = [sys.executable, "-m", "tony_tpu_torch.train", *train_args,
           "--log-every", "1"]
    # each rank's output to its own file: no rank blocks on a full pipe
    logs = [tempfile.TemporaryFile("w+") for _ in range(nproc)]
    procs = [subprocess.Popen(cmd, cwd=repo, env=dict(base, RANK=str(r)),
                              stdout=subprocess.DEVNULL, stderr=log,
                              text=True)
             for r, log in enumerate(logs)]
    t0 = time.monotonic()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.monotonic() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t0
    errs = []
    for log in logs:
        log.seek(0)
        errs.append(log.read())
        log.close()
    outs = [("", e) for e in errs]
    bad = [(r, p.returncode, e[-2000:]) for r, (p, e) in
           enumerate(zip(procs, errs)) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks failed: {bad}")
    steps = [m for m in map(STEP.search, outs[0][1].splitlines()) if m]
    elapsed = [float(m.group(3)) for m in steps]
    gaps = sorted(b - a for a, b in zip(elapsed[1:], elapsed[2:]))
    return {"nproc": nproc, "mesh": {"shape": mesh_shape,
                                     "axes": mesh_axes},
            "losses": [m.group(2) for m in steps],
            "median_step_s": (round(gaps[len(gaps) // 2], 4) if gaps
                              else None),
            "wall_s": round(wall, 1),
            "launches": [json.loads(m.group(1)) for _, err in outs
                         for m in [LAUNCHES.search(err)] if m],
            "peak_gib": [float(m.group(1)) for _, err in outs
                         for m in [PEAK.search(err)] if m]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--mesh-shape", default="")
    ap.add_argument("--mesh-axes", default="")
    ap.add_argument("--timeout", type=float, default=900.0)
    opts = ap.parse_args(argv[:split])
    result = run_gang(opts.nproc, opts.mesh_shape, opts.mesh_axes,
                      argv[split + 1:], opts.timeout)
    result["card"] = _smi()
    print(f"gang: {result['card']}; {opts.nproc} ranks, mesh "
          f"{opts.mesh_axes or '-'}={opts.mesh_shape or '-'}: losses "
          f"{result['losses']}, median step {result['median_step_s']} s, "
          f"wall {result['wall_s']} s, peak GiB {result['peak_gib']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
