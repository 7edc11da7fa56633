"""Print a finished job's time-accounting table from its history dir: the
port of ``tools/goodput_report.py``.

Reads `goodput.json` (the AM's flush of every task's goodput ledger and
the job-level aggregate, `observability/perf.py`) and prints where the
job's wall clock went, per task and phase, with the job's goodput. The
table text and the ``--json`` dump are the JAX tool's, byte for byte.

    python -m tony_tpu_torch.tools.goodput_report <history_dir | app_dir> \\
        [--json]

Takes either the per-app history dir itself or an app dir holding a
``history/<app_id>`` subtree (the local backend's layout). Exits 1 when
no `goodput.json` lies under the path. It imports no torch, jax or grpc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.environ.get(
        "TONY_REPO_ROOT",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")))

from tony_tpu_torch import constants as C  # noqa: E402
from tony_tpu_torch.events.history import read_goodput_file  # noqa: E402


def find_history_dir(path: str) -> str:
    """Resolve an app dir or history base down to the dir that holds
    goodput.json (the first one a sorted walk finds)."""
    if os.path.isfile(os.path.join(path, C.GOODPUT_FILE)):
        return path
    for dirpath, _, files in sorted(os.walk(path)):
        if C.GOODPUT_FILE in files:
            return dirpath
    return path


def format_report(goodput: dict) -> str:
    """The time-accounting table for one job's goodput dict
    (`aggregate_goodput`'s shape)."""
    tasks = goodput.get("tasks") or {}
    job = goodput.get("job") or {}
    lines = []
    header = f"{'task':<16} {'phase':<20} {'seconds':>10} {'% wall':>8}"
    lines.append(header)
    lines.append("-" * len(header))
    for task_id, entry in sorted(tasks.items()):
        wall = float(entry.get("wall_s") or 0.0)
        phases = entry.get("phases") or {}
        for phase, secs in sorted(phases.items(), key=lambda kv: -kv[1]):
            if secs <= 0:
                continue
            pct = 100.0 * secs / wall if wall > 0 else 0.0
            lines.append(f"{task_id:<16} {phase:<20} {secs:>10.3f} "
                         f"{pct:>7.1f}%")
        lines.append(f"{task_id:<16} {'= wall':<20} {wall:>10.3f} "
                     f"{'100.0%':>8}")
        mfu = entry.get("mfu_pct")
        if mfu is not None:
            lines.append(f"{task_id:<16} {'mfu':<20} {mfu:>9.2f}%")
        lines.append("")
    if job:
        lines.append(
            f"job goodput: {job.get('goodput_pct', 0)}% "
            f"({job.get('productive_s', 0)}s productive / "
            f"{job.get('wall_s', 0)}s wall, "
            f"{job.get('relaunch_downtime_s', 0)}s relaunch downtime)")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="goodput_report")
    parser.add_argument("path", help="history dir (or app dir above it)")
    parser.add_argument("--json", action="store_true",
                        help="dump the raw goodput dict instead of the "
                             "table")
    args = parser.parse_args(argv)
    hist = find_history_dir(args.path)
    goodput = read_goodput_file(hist)
    if not goodput:
        print(f"no {C.GOODPUT_FILE} under {args.path}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(goodput, indent=1, sort_keys=True))
    else:
        print(format_report(goodput))
    return 0


if __name__ == "__main__":
    sys.exit(main())
