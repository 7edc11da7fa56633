"""The AM's half of fleet observability: the jobstate summary and its
publishing.

The port's copy of the writer half of `tony_tpu/observability/fleet.py`.
Every AM folds its job into one compact, heartbeat-stamped summary
(`job_summary`): identity (app, queue, user), gang shape, chip occupancy
and the job-level health gauges. With a staging location configured the
AM republishes it every `tony.fleet.publish-interval-ms` as
`<location>/<app_id>/fleet/jobstate.json` (`publish_job_state`), and it
lands in the history as `jobstate.json` at the end of every job, where
the JAX package's registry, ledger and portal read it (the schema is
theirs). The readers (registry, ledger, quota view, fleet `/metrics`)
are not in the port.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

from tony_tpu_torch import constants as C

# where each AM publishes its summary inside its staging namespace
JOBSTATE_KEY = f"{C.FLEET_DIR_NAME}/{C.JOBSTATE_FILE}"

# the gang step-time spread gauges _check_stragglers refreshes each
# closed window (the JAX package's fleet /metrics names)
STEP_TIME_GAUGES = {
    "p50": "tony_job_step_time_p50_ms",
    "p95": "tony_job_step_time_p95_ms",
    "p99": "tony_job_step_time_p99_ms",
}


def job_summary(app_id: str, user: str, queue: str, state: str, *,
                gang_width: int = 0, requested_chips: int = 0,
                allocated_chips: int = 0, started_ms: int = 0,
                goodput_pct: Optional[float] = None,
                mfu_pct: Optional[float] = None,
                straggler_count: int = 0,
                alerts_firing: int = 0,
                serving_tokens_per_sec: Optional[float] = None,
                preemptions: int = 0,
                resizes: int = 0,
                requested_width: Optional[int] = None,
                elastic_job: str = "",
                elastic_width: int = 0,
                elastic_chips_per_task: int = 0,
                elastic_min_width: int = 0,
                elastic_max_width: int = 0,
                elastic_min_chips: int = 0,
                priority: int = 0,
                am_addr: str = "",
                gauges: Optional[dict] = None,
                heartbeat_ms: Optional[int] = None) -> dict:
    """The one jobstate schema (writer: AM; readers: registry, ledger,
    portal, CLI). Compact by design — a 1k-job fleet scan must stay
    cheap — and heartbeat-stamped so staleness is a property of the
    entry, not of file mtimes a GCS round-trip can't see."""
    return {
        "app_id": app_id,
        "user": user,
        "queue": queue or "default",
        "state": state,
        "gang_width": int(gang_width),
        # elastic width surface: requested_width diverges from
        # gang_width while a resize is in flight (the fleet table and
        # `cli top` render "cur>req"); elastic_* name the resizable
        # jobtype and the floor/ceiling the arbiter's offer/reclaim
        # verdicts respect (elastic_job == "" means not elastic)
        "requested_width": int(requested_width if requested_width
                               is not None else gang_width),
        "resizes": int(resizes),
        "elastic_job": elastic_job,
        # the ELASTIC jobtype's own shape (gang_width spans every
        # tracked jobtype — reclaim arithmetic must never blend a
        # serving replica's chips into a worker slice's size)
        "elastic_width": int(elastic_width),
        "elastic_chips_per_task": int(elastic_chips_per_task),
        "elastic_min_width": int(elastic_min_width),
        "elastic_max_width": int(elastic_max_width),
        "elastic_min_chips": int(elastic_min_chips),
        "requested_chips": int(requested_chips),
        "allocated_chips": int(allocated_chips),
        "started_ms": int(started_ms),
        "heartbeat_ms": int(heartbeat_ms if heartbeat_ms is not None
                            else time.time() * 1000),
        "goodput_pct": goodput_pct,
        "mfu_pct": mfu_pct,
        "straggler_count": int(straggler_count),
        "alerts_firing": int(alerts_firing),
        "serving_tokens_per_sec": serving_tokens_per_sec,
        # arbitration surface: the admission arbiter reads victim
        # priority from the registry entry and reaches the AM's control
        # plane at am_addr to deliver request_preemption
        "preemptions": int(preemptions),
        "priority": int(priority),
        "am_addr": am_addr,
        "gauges": dict(gauges or {}),
    }


def chips_of(summary: dict) -> int:
    """The chip count a summary occupies: allocated when containers are
    live, else the requested ask (pre-allocation, and terminal summaries
    whose containers already exited — the reservation the quota was
    charged for)."""
    return int(summary.get("allocated_chips") or 0) \
        or int(summary.get("requested_chips") or 0)


def publish_job_state(store, summary: dict, scratch_dir: str) -> str:
    """AM-side: atomically publish one summary as this app's
    `fleet/jobstate.json` (tmp-file + store.put — the put itself is the
    store's atomicity problem). Returns the published URI."""
    fd, tmp = tempfile.mkstemp(prefix="jobstate-", suffix=".json",
                               dir=scratch_dir or None)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
        return store.put(tmp, JOBSTATE_KEY)
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass
