"""History-file naming + job metadata + observability sidecar files.

The port's copy of `tony_tpu/events/history.py`: the same file names
and sidecar files.

Equivalent of the reference's util/HistoryFileUtils.java:12-32 filename codec
and models/JobMetadata.java:35-45: final history files are named
`<appId>-<started>-<completed>-<user>-<STATUS>.jhist`; in-flight files are
`<appId>-<started>-<user>.jhist.inprogress`.

The observability subsystem flushes two sidecar files into the same
per-app history dir (so they travel with the jhist through the portal's
mover and the staging-store publish): `spans.json` (lifecycle spans,
the portal waterfall's source) and `metrics.json` (per-gauge timeseries,
served as /jobs/:id/metrics.json).
"""

from __future__ import annotations

import getpass
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any

from tony_tpu_torch import constants as C


@dataclass
class JobMetadata:
    application_id: str
    started: int = 0           # epoch ms
    completed: int = 0         # epoch ms
    user: str = field(default_factory=getpass.getuser)
    status: str = "RUNNING"


def inprogress_file_name(md: JobMetadata) -> str:
    return f"{md.application_id}-{md.started}-{md.user}.{C.HISTORY_INPROGRESS_SUFFIX}"


def history_file_name(md: JobMetadata) -> str:
    """reference: HistoryFileUtils.generateFileName (HistoryFileUtils.java:12-32)."""
    return (f"{md.application_id}-{md.started}-{md.completed}-{md.user}"
            f"-{md.status}.{C.HISTORY_SUFFIX}")


# Anchored on the numeric timestamp fields so hyphenated usernames parse
# correctly (app ids use underscores, so the non-greedy app group is safe).
_FINAL_RE = re.compile(
    r"^(?P<app>.+?)-(?P<started>\d+)-(?P<completed>\d+)-(?P<user>.+)"
    r"-(?P<status>[A-Z_]+)\." + re.escape(C.HISTORY_SUFFIX) + r"$")
_INPROGRESS_RE = re.compile(
    r"^(?P<app>.+?)-(?P<started>\d+)-(?P<user>.+)\."
    + re.escape(C.HISTORY_INPROGRESS_SUFFIX) + r"$")


def write_json_atomic(path: str, obj: Any) -> None:
    """Tmp-write + rename JSON — the one atomic-write helper (sidecar
    files here, the AM's am.json, the executor's profile-request relay
    file all go through it so a crash-safety fix lands everywhere)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


_write_json_atomic = write_json_atomic


def _read_json(path: str, default: Any) -> Any:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return default


def write_spans_file(history_dir: str, spans: list[dict]) -> None:
    _write_json_atomic(os.path.join(history_dir, C.SPANS_FILE), spans)


def read_spans_file(history_dir: str) -> list[dict]:
    out = _read_json(os.path.join(history_dir, C.SPANS_FILE), [])
    return out if isinstance(out, list) else []


def write_metrics_file(history_dir: str, series: dict) -> None:
    """series: {"<task_type>:<index>": {metric_name: [[ts_ms, value],…]}}."""
    _write_json_atomic(os.path.join(history_dir, C.METRICS_FILE), series)


def read_metrics_file(history_dir: str) -> dict:
    out = _read_json(os.path.join(history_dir, C.METRICS_FILE), {})
    return out if isinstance(out, dict) else {}


def write_goodput_file(history_dir: str, goodput: dict) -> None:
    """goodput: observability.perf.aggregate_goodput's shape — per-task
    phase accounting + the job-level goodput_pct."""
    _write_json_atomic(os.path.join(history_dir, C.GOODPUT_FILE), goodput)


def write_diagnostics_file(history_dir: str, diagnostics: dict) -> None:
    """diagnostics: the AM's root-cause bundle — {app_id, status,
    first_failure, failures[], ...} with redacted tail excerpts (see
    ApplicationMaster._assemble_diagnostics)."""
    _write_json_atomic(os.path.join(history_dir, C.DIAGNOSTICS_FILE),
                       diagnostics)


def read_diagnostics_file(history_dir: str) -> dict:
    out = _read_json(os.path.join(history_dir, C.DIAGNOSTICS_FILE), {})
    return out if isinstance(out, dict) else {}


def read_goodput_file(history_dir: str) -> dict:
    out = _read_json(os.path.join(history_dir, C.GOODPUT_FILE), {})
    return out if isinstance(out, dict) else {}


def write_jobstate_file(history_dir: str, summary: dict) -> None:
    """summary: observability.fleet.job_summary's shape — the compact
    heartbeat-stamped cross-job registry entry. The terminal copy lands
    in history so the fleet ledger's final accounting can outlive the
    staging store's live entry."""
    _write_json_atomic(os.path.join(history_dir, C.JOBSTATE_FILE), summary)


def read_jobstate_file(history_dir: str) -> dict:
    out = _read_json(os.path.join(history_dir, C.JOBSTATE_FILE), {})
    return out if isinstance(out, dict) else {}


def write_skew_file(history_dir: str, skew: dict) -> None:
    """skew: observability.skew.SkewTracker.bundle's shape — gang sketch
    summaries per signal, the tasks x windows step-time heatmap, startup
    values, latched stragglers + detection log."""
    _write_json_atomic(os.path.join(history_dir, C.SKEW_FILE), skew)


def read_skew_file(history_dir: str) -> dict:
    out = _read_json(os.path.join(history_dir, C.SKEW_FILE), {})
    return out if isinstance(out, dict) else {}


def write_alerts_file(history_dir: str, alerts: dict) -> None:
    """alerts: observability.alerts.AlertEngine.bundle's shape —
    currently-firing alerts + the bounded transition log. Refreshed on
    every transition (not just at finish) so the portal's sidecar
    fallback tracks a RUNNING job's alert state."""
    _write_json_atomic(os.path.join(history_dir, C.ALERTS_FILE), alerts)


def read_alerts_file(history_dir: str) -> dict:
    out = _read_json(os.path.join(history_dir, C.ALERTS_FILE), {})
    return out if isinstance(out, dict) else {}


def write_serving_traces_file(history_dir: str,
                              traces: list[dict]) -> None:
    """traces: tail-sampled per-request serving traces (observability/
    reqtrace.py record shape — {trace_id, process, kept_reason,
    duration_ms, hops[]}), already redacted at drain; re-redacted here
    so the history flush is an egress in its own right."""
    from tony_tpu_torch.observability.reqtrace import redact_traces
    _write_json_atomic(os.path.join(history_dir, C.SERVING_TRACES_FILE),
                       redact_traces(traces))


def read_serving_traces_file(history_dir: str) -> list:
    out = _read_json(os.path.join(history_dir, C.SERVING_TRACES_FILE), [])
    return out if isinstance(out, list) else []


def write_profile_file(history_dir: str, folded: str) -> None:
    """folded: the sampling profiler's collapsed-stack text
    (observability/profiler.py FoldTable.folded — one
    "thread;frame;... count" line per distinct stack, flamegraph.pl
    format). Redacted at flush: like the serving-traces sidecar, the
    history write is an egress in its own right. Tmp+rename for the same
    crash-atomicity as the JSON sidecars."""
    from tony_tpu_torch.observability.logs import redact
    path = os.path.join(history_dir, C.PROFILE_FOLDED_FILE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(redact(str(folded)))
    os.replace(tmp, path)


def read_profile_file(history_dir: str) -> str:
    try:
        with open(os.path.join(history_dir, C.PROFILE_FOLDED_FILE),
                  "r", encoding="utf-8") as f:
            return f.read()
    except OSError:
        return ""


def parse_history_file_name(name: str) -> JobMetadata:
    """Parse either a final or an in-progress history file name back into
    JobMetadata (reference: JobMetadata constructor parsing,
    models/JobMetadata.java:35-45)."""
    m = _INPROGRESS_RE.match(name)
    if m:
        return JobMetadata(application_id=m.group("app"),
                           started=int(m.group("started")),
                           user=m.group("user"), status="RUNNING")
    m = _FINAL_RE.match(name)
    if m:
        return JobMetadata(application_id=m.group("app"),
                           started=int(m.group("started")),
                           completed=int(m.group("completed")),
                           user=m.group("user"), status=m.group("status"))
    raise ValueError(f"not a history file name: {name!r}")
