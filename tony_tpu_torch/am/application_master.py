"""ApplicationMaster: per-job controller process.

The port's copy of `tony_tpu/am/application_master.py`. It launches
`python -m tony_tpu_torch.executor` in every container and, for the
serving jobtype, `python -m tony_tpu_torch.serve` unless
`tony.serving.command` says otherwise; its events, metric names, files
and RPC surface are the JAX AM's, and so are its backends (local, warm
pool, remote) and its live jobstate publishing into a staging store. The
alert engine and the replica autoscaler (with the arbiter it asks) are
not in the port yet: a job whose configuration turns one on ends FAILED
with a message naming the key (`unported_feature`), before any container
launches.

Equivalent of the reference's ApplicationMaster.java (tony-core, 1218 LoC):

- `init`/`prepare` — read the frozen conf, start the control-plane +
  metrics RPC server, start the cluster backend, announce the AM address
  (ApplicationMaster.java:214-281,391-475).
- session retry loop — build a TonySession, schedule via TaskScheduler,
  monitor; on failure with retries left, stop this session's containers,
  bump the session id, and go again (ApplicationMaster.java:311-386,558-574).
- allocation handling — match containers to tasks by unique priority,
  render executor env, launch (`RMCallbackHandler`/`ContainerLauncher`,
  ApplicationMaster.java:1002-1073,1078-1156).
- heartbeat liveliness, registration timeout, untracked-failure detection,
  client stop signal — the monitor loop conditions of
  ApplicationMaster.java:580-658.
- Avro-equivalent event history (ApplicationMaster.java:330-384 wiring).

Fault-injection env hooks (TEST_AM_CRASH, TEST_WORKER_TERMINATION,
TEST_TASK_COMPLETION_NOTIFICATION_DELAYED) are compiled in, exactly like the
reference (ApplicationMaster.java:337-342,1028-1037,1204-1215).
"""

from __future__ import annotations

import json
import logging
import os
import random
import sys
import threading
import time
from typing import Any, Optional

from tony_tpu_torch import constants as C
from tony_tpu_torch.cluster import (
    Container, LocalClusterBackend, backend_from_conf,
)
from tony_tpu_torch.cluster.backend import ClusterBackend
from tony_tpu_torch.cluster.docker import docker_env
from tony_tpu_torch.conf import TonyConfiguration, keys as K
from tony_tpu_torch.am import journal as J
from tony_tpu_torch.events.handler import EventHandler
from tony_tpu_torch.events.history import JobMetadata
from tony_tpu_torch.events.schema import (
    AmRecoveryCompleted, AmRecoveryStarted,
    ApplicationFinished, ApplicationInited,
    DiagnosticsReady, Event, EventType, Preempted, PreemptionRequested,
    ProcessStallCleared, ProcessStallDetected,
    ProfileCaptured, Resumed, RollingUpdateCompleted, RollingUpdateStarted,
    ServingEndpointRegistered, ServingMigrated, SloViolation,
    StragglerCleared,
    StragglerDetected, TaskFinished, TaskRelaunched, TaskStarted,
)
from tony_tpu_torch.am.liveliness import LivelinessMonitor, auto_liveliness_shards
from tony_tpu_torch.rpc.service import (
    ClusterServiceHandler, MetricsServiceHandler, auto_rpc_workers, serve,
)
from tony_tpu_torch.session.scheduler import ResourceRequestor, TaskScheduler
from tony_tpu_torch.session.session import FinalStatus, Task, TonySession
from tony_tpu_torch.session.requests import JobContainerRequest
from tony_tpu_torch.utils.common import (
    current_host, equal_jitter_backoff_sec, framework_pythonpath,
)
from tony_tpu_torch.utils.shell import execute_shell

LOG = logging.getLogger(__name__)


def session_retry_backoff_sec(app_id: str, attempt: int, base_ms: int,
                              max_ms: int) -> float:
    """Capped equal-jitter exponential backoff before whole-session retry
    `attempt` (1-based). Deterministic for a given (app_id, attempt) so a
    replayed application backs off identically. The reference relaunched
    immediately (ApplicationMaster.java:311-386); at TPU-pod gang widths an
    immediate rebuild against a still-broken substrate just burns the
    retry budget."""
    if attempt <= 0:
        return 0.0
    rng = random.Random(f"{app_id}:session-retry:{attempt}")
    return equal_jitter_backoff_sec(base_ms / 1000.0, max_ms / 1000.0,
                                    attempt - 1, rng)


# Features of the JAX AM that the port does not have yet, each behind a
# switch that is off by default: the alert engine's rules and the replica
# autoscaler (and the arbiter it asks).
# the thresholds that give the JAX AM's engine_from_conf a rule, each read
# with the getter it uses
_ALERT_RULE_KEYS = (
    (K.ALERTS_STEP_REGRESSION_PCT, "get_float"),
    (K.SLO_STEP_TIME_REGRESSION_PCT, "get_float"),
    (K.ALERTS_GOODPUT_FLOOR_PCT, "get_float"),
    (K.SLO_GOODPUT_FLOOR_PCT, "get_float"),
    (K.ALERTS_MFU_FLOOR_PCT, "get_float"),
    (K.ALERTS_TTFT_P95_SLO_MS, "get_time_ms"),
    (K.ALERTS_QUEUE_DEPTH_SLO, "get_int"),
    (K.ALERTS_REJECT_RATE_BUDGET_PCT, "get_float"),
)


def unported_feature(conf: TonyConfiguration) -> Optional[str]:
    """The refusal that names the first key of `conf` that turns on a
    feature the port's AM lacks, or None. Such a job ends FAILED with this
    message instead of running with the feature silently missing."""
    def refused(key: str, value: Any, feature: str) -> str:
        return (f"{key}={value} needs {feature}, which the port's AM "
                "does not have yet")

    if conf.get_bool(K.ALERTS_ENABLED, True):
        for key, getter in _ALERT_RULE_KEYS:
            if getattr(conf, getter)(key, 0) > 0:
                return refused(key, conf.get(key), "the alert engine")
        if conf.get_strings(K.ALERTS_RULES):
            return refused(K.ALERTS_RULES, conf.get(K.ALERTS_RULES),
                           "the alert engine")
    if conf.get_bool(K.AUTOSCALER_ENABLED, False):
        from tony_tpu_torch.session.requests import parse_container_requests
        if C.SERVING_JOB_NAME in parse_container_requests(conf):
            return refused(K.AUTOSCALER_ENABLED, "true",
                           "the replica autoscaler")
    return None


class MetricsStore(MetricsServiceHandler):
    """AM-side metrics map (rpc/impl/MetricsRpcServer.java:22-56 equivalent):
    {task_type: {index: [metric dicts]}} holding the latest sample — plus,
    per merged gauge, a bounded ring-buffer timeseries
    (tony.metrics.history-points; observability.metrics.TimeSeries) so the
    portal serves step-time/tokens-per-sec/HBM/TTFT *trajectories* instead
    of last-write values, and a Prometheus rendering of the latest gauges
    for the AM's /metrics scrape endpoint.

    Wedge detection: a task whose TPU duty cycle stays
    ~0 across `low_util_intervals` consecutive updates while it keeps
    heartbeating is almost certainly stalled (deadlocked input pipeline,
    hung collective, wedged runtime) — exactly the failure mode a liveness
    monitor alone cannot see. The condition is surfaced via
    `low_utilization_tasks` (the AM logs it and the client status/TaskInfo
    path can display it); it never kills the task on its own."""

    LOW_UTIL_PCT = 1.0

    def __init__(self, low_util_intervals: int = 24,
                 history_points: int = 512):
        self._metrics: dict[str, dict[int, list[dict]]] = {}  # guarded-by: _lock
        self._low_util_count: dict[tuple[str, int], int] = {}  # guarded-by: _lock
        self._low_util_flagged: set[tuple[str, int]] = set()  # guarded-by: _lock
        self._had_util: set[tuple[str, int]] = set()  # guarded-by: _lock
        self._low_util_intervals = low_util_intervals
        self._history_points = history_points
        # (task_type, index) -> {metric name: TimeSeries}
        self._series: dict[tuple[str, int], dict] = {}  # guarded-by: _lock
        # last task attempt a push arrived from (Prometheus label)
        self._attempts: dict[tuple[str, int], int] = {}  # guarded-by: _lock
        # spans piggybacked on metrics pushes land here (the AM wires its
        # SpanStore.add in); None drops them (standalone store in tests)
        self.span_sink = None
        # profile-capture completions (update_metrics `profile_done`
        # field) are forwarded here; the AM wires _on_profile_captured
        self.profile_sink = None
        # tail-sampled serving request traces (update_metrics
        # `serving_traces` field, observability/reqtrace.py) accumulate
        # here, bounded, for the serving_traces.json history flush
        self._serving_traces: list[dict] = []  # guarded-by: _lock
        self._serving_traces_max = 1024
        # cross-task skew analytics (observability/skew.py): every
        # numeric gauge push is offered to this sink (the SkewTracker's
        # observe_metric — unwatched names are a single dict miss), so
        # the straggler analyzer never re-reads the O(width x points)
        # trajectories above; None drops them (standalone store in tests)
        self.skew_sink = None
        self._lock = threading.Lock()

    def update_metrics(self, req: dict) -> dict:
        task_type, index = req["task_type"], int(req["index"])
        metrics = req.get("metrics", [])
        now_ms = int(time.time() * 1000)
        numeric: list[tuple[str, float]] = []
        with self._lock:
            # MERGE by metric name, don't replace the list: one task slot
            # has several pushers at once (executor TaskMonitor: memory/
            # duty; in-process reporters: trainer HBM, serving TTFT/
            # throughput) and whole-list replacement had the last writer
            # clobbering every other source's gauges. Wedge detection
            # still runs on the RAW incoming sample so its
            # stopped-reporting-duty dynamics are unchanged.
            cur = self._metrics.setdefault(task_type, {}).setdefault(
                index, [])
            by_name = {m.get("name"): i for i, m in enumerate(cur)}
            series = self._series.setdefault((task_type, index), {})
            for m in metrics:
                name = m.get("name")
                at = by_name.get(name)
                if at is None:
                    cur.append(m)
                else:
                    cur[at] = m
                value = m.get("value")
                if name and isinstance(value, (int, float)):
                    ts = series.get(name)
                    if ts is None:
                        from tony_tpu_torch.observability.metrics import TimeSeries
                        ts = series[name] = TimeSeries(self._history_points)
                    ts.append(now_ms, float(value))
                    numeric.append((name, float(value)))
            attempt = req.get("attempt")
            if attempt is not None and int(attempt) >= 0:
                self._attempts[(task_type, index)] = int(attempt)
            # span-only pushes (metrics=[]) are trace transport, not a
            # metrics interval — counting them as a missing-duty sample
            # would inflate the wedge counter during legitimately busy
            # phases (checkpoint, re-rendezvous) that emit spans
            if metrics:
                self._track_utilization(task_type, index, metrics)
        spans = req.get("spans")
        sink = self.span_sink
        if spans and sink is not None:
            sink(spans)
        traces = req.get("serving_traces")
        if traces:
            with self._lock:
                self._serving_traces.extend(
                    t for t in traces if isinstance(t, dict))
                # bounded like the per-process buffers: keep the NEWEST
                if len(self._serving_traces) > self._serving_traces_max:
                    del self._serving_traces[
                        :len(self._serving_traces)
                        - self._serving_traces_max]
        # outside the store lock (the tracker has its own): fold watched
        # gauges into the skew windows
        skew_sink = self.skew_sink
        if numeric and skew_sink is not None:
            task_id = f"{task_type}:{index}"
            for name, value in numeric:
                skew_sink(task_id, name, value)
        profile_done = req.get("profile_done")
        psink = self.profile_sink
        if isinstance(profile_done, dict) and psink is not None:
            psink(task_type, index, profile_done)
        return {}

    def serving_traces(self) -> list[dict]:
        """The accumulated tail-sampled request traces (already redacted
        at each replica's drain) — the serving_traces.json source."""
        with self._lock:
            return list(self._serving_traces)

    # holds: _lock (only update_metrics calls this, under the store lock)
    def _track_utilization(self, task_type: str, index: int,
                           metrics: list[dict]) -> None:
        # TPU_UTILIZATION is the LAST sample — tracking the monotonic MAX
        # would never flag a task that ran healthy before wedging
        duty = next((m.get("value") for m in metrics
                     if m.get("name") == "TPU_UTILIZATION"), None)
        key = (task_type, index)
        if duty is None:
            # a task that REPORTED duty before and stopped is the hardest
            # wedge (runtime hung so hard the metrics daemon is silent);
            # count those intervals as idle. Tasks that never had a
            # utilization source are not judged at all.
            if key not in self._had_util:
                return
            duty = 0.0
        else:
            self._had_util.add(key)
        if duty >= self.LOW_UTIL_PCT:
            self._low_util_count.pop(key, None)
            self._low_util_flagged.discard(key)
            return
        count = self._low_util_count.get(key, 0) + 1
        self._low_util_count[key] = count
        if count >= self._low_util_intervals and \
                key not in self._low_util_flagged:
            self._low_util_flagged.add(key)
            LOG.warning(
                "task %s:%d TPU duty cycle ~0%% for %d consecutive metric "
                "intervals while heartbeating — training is likely wedged "
                "(stalled input pipeline / hung collective)",
                task_type, index, count)

    def low_utilization_tasks(self) -> list[str]:
        """task ids currently flagged as heartbeating-but-idle."""
        with self._lock:
            return sorted(f"{t}:{i}" for t, i in self._low_util_flagged)

    def clear_utilization_state(self, task_type: str, index: int) -> None:
        """Drop wedge-detection state when a task completes: a finished
        task must not stay flagged forever, and a relaunched attempt with
        the same type:index starts clean. Latest metrics stay (the
        TASK_FINISHED event reads them)."""
        key = (task_type, index)
        with self._lock:
            self._low_util_count.pop(key, None)
            self._low_util_flagged.discard(key)
            self._had_util.discard(key)

    def get_metrics(self, task_type: str, index: int) -> list[dict]:
        # copied DICTS, not a shallow list copy: the stored metric dicts
        # must not alias into callers (a caller mutating a returned metric
        # — e.g. event post-processing — was corrupting the store)
        with self._lock:
            return [dict(m)
                    for m in self._metrics.get(task_type, {}).get(index, [])]

    def get_history(self, task_type: str, index: int) -> dict[str, list]:
        """{metric name: [[ts_ms, value], ...]} for one task slot."""
        with self._lock:
            series = dict(self._series.get((task_type, index), {}))
        return {name: ts.to_list() for name, ts in sorted(series.items())}

    def drop_perf_gauges(self, task_type: str, index: int) -> None:
        """Remove the GOODPUT_*/TRAIN_* latest values for one slot (the
        AM archives them at a relaunch; the successor process pushes a
        fresh ledger). Timeseries history stays — trajectories across
        the relaunch are still honest, only the latest-value merge view
        must not double-count the archived epoch."""
        with self._lock:
            cur = self._metrics.get(task_type, {}).get(index)
            if cur is not None:
                cur[:] = [m for m in cur
                          if not str(m.get("name", "")).startswith(
                              ("GOODPUT_", "TRAIN_"))]

    def latest_gauges(self) -> dict[str, dict[str, float]]:
        """Every slot's latest numeric gauges, keyed "<task_type>:<index>"
        — the goodput aggregation's input (observability/perf.py reads
        the GOODPUT_*/TRAIN_* families out of it)."""
        with self._lock:
            rows = [(t, i, list(ms))
                    for t, per_index in self._metrics.items()
                    for i, ms in per_index.items()]
        out: dict[str, dict[str, float]] = {}
        for task_type, index, metrics in rows:
            gauges = {m["name"]: float(m["value"]) for m in metrics
                      if m.get("name")
                      and isinstance(m.get("value"), (int, float))}
            if gauges:
                out[f"{task_type}:{index}"] = gauges
        return out

    def attempts(self) -> dict[str, int]:
        """Latest attempt a push arrived from, keyed "<type>:<index>" —
        the SLO watchdog's / alert engine's attempt-aware baseline
        input."""
        with self._lock:
            return {f"{t}:{i}": a for (t, i), a in self._attempts.items()}

    def metric_histories(self, metric_name: str) -> dict[str, list]:
        """One metric's trajectory across every task slot, keyed
        "<task_type>:<index>" — the SLO watchdog's step-time input."""
        with self._lock:
            keys = list(self._series)
        out: dict[str, list] = {}
        for t, i in sorted(keys):
            series = self.get_history(t, i).get(metric_name)
            if series:
                out[f"{t}:{i}"] = series
        return out

    def timeseries_dict(self) -> dict[str, dict[str, list]]:
        """Every slot's gauge trajectories, keyed "<task_type>:<index>" —
        the shape flushed into history as metrics.json and served by the
        portal's /jobs/:id/metrics.json."""
        with self._lock:
            keys = list(self._series)
        return {f"{t}:{i}": self.get_history(t, i) for t, i in sorted(keys)}

    def prometheus_families(self, app_id: str = "") -> list[dict]:
        """Latest gauges as Prometheus families with
        {app_id, task_type, index, attempt} labels (AM /metrics)."""
        from tony_tpu_torch.observability.prometheus import task_metric_name
        with self._lock:
            rows = [(t, i, list(ms))
                    for t, per_index in self._metrics.items()
                    for i, ms in per_index.items()]
            attempts = dict(self._attempts)
        families: dict[str, dict] = {}
        for task_type, index, metrics in rows:
            labels = {"app_id": app_id, "task_type": task_type,
                      "index": str(index),
                      "attempt": str(attempts.get((task_type, index), 0))}
            for m in metrics:
                value = m.get("value")
                if not m.get("name") or not isinstance(value, (int, float)):
                    continue
                name = task_metric_name(m["name"])
                fam = families.setdefault(
                    name, {"name": name, "type": "gauge", "help": "",
                           "samples": []})
                fam["samples"].append((labels, float(value)))
        return [families[k] for k in sorted(families)]


class ApplicationMaster(ClusterServiceHandler):
    def __init__(self, conf: TonyConfiguration, app_id: str, app_dir: str,
                 backend: Optional[ClusterBackend] = None):
        self.conf = conf
        self.app_id = app_id
        self.app_dir = os.path.abspath(app_dir)
        # a refused job never launches a container, so it needs no backend
        # of the kind it asked for
        self._unported = unported_feature(conf)
        self.backend = backend or (
            LocalClusterBackend(app_id=app_id) if self._unported
            else backend_from_conf(conf, app_id))
        self.session: Optional[TonySession] = None
        self.scheduler: Optional[TaskScheduler] = None
        self.metrics_store = MetricsStore(
            low_util_intervals=conf.get_int(K.TASK_LOW_UTIL_INTERVALS, 24),
            history_points=conf.get_int(K.METRICS_HISTORY_POINTS, 512))
        # observability: lifecycle spans (trace_id = app_id). The AM
        # records its own phase boundaries straight into the store;
        # executor/trainer spans arrive piggybacked on metrics pushes.
        from tony_tpu_torch.observability.trace import SpanRecorder, SpanStore
        self._trace_enabled = conf.get_bool(K.TRACE_ENABLED, True)
        self.span_store = SpanStore(conf.get_int(K.TRACE_MAX_SPANS, 2048))
        self.tracer = SpanRecorder(
            trace_id=app_id,
            sink=self.span_store.add if self._trace_enabled else
            (lambda spans: None))
        if self._trace_enabled:
            self.metrics_store.span_sink = self.span_store.add
        # goodput / profiling / SLO (observability/perf.py)
        from tony_tpu_torch.observability.perf import SloWatchdog
        self._goodput_enabled = conf.get_bool(K.GOODPUT_ENABLED, True)
        self._profiling_enabled = conf.get_bool(K.PROFILING_ENABLED, True)
        # task_id -> {"id", "num_steps", "state": pending|sent|done}
        self._profile_requests: dict[str, dict] = {}
        self._profiles_captured: set[str] = set()
        self.metrics_store.profile_sink = self._on_profile_captured
        # relaunch downtime: per-slot clock from the relaunch decision to
        # the re-completed gang barrier; counts AGAINST job goodput
        self._relaunch_pending_since: dict[str, float] = {}  # guarded-by: _lock
        self._relaunch_downtime_s = 0.0
        # checkpoint-then-evict preemption (cluster/arbiter.py's
        # eviction edge): set once by request_preemption — {reason,
        # grace_ms, deadline (monotonic), requested (monotonic),
        # requested_by}; the drain ask rides every heartbeat response
        # from then on and the application finishes PREEMPTED
        self._preemption: Optional[dict] = None
        self._preempt_forced = False
        self._preempt_event_emitted = False
        # resume lineage: a re-admitted application inherits its
        # predecessor's preemption count and prices the eviction→now gap
        # into the goodput ledger as preemption downtime
        self._preempt_count = conf.get_int(K.APPLICATION_PREEMPT_COUNT, 0)
        self._resumed_from = conf.get_str(K.APPLICATION_RESUMED_FROM, "")
        preempted_at_ms = conf.get_int(K.APPLICATION_PREEMPTED_AT_MS, 0)
        self._preemption_downtime_s = (
            max(0.0, time.time() * 1000 - preempted_at_ms) / 1000.0
            if preempted_at_ms > 0 else 0.0)
        # dead attempts' final GOODPUT_*/TRAIN_* gauges, archived at the
        # relaunch decision — the replacement's pushes overwrite the
        # MetricsStore slot, and a killed attempt's hour of training must
        # not vanish from the job's wall/productive accounting
        self._goodput_archive: dict[str, dict[str, float]] = {}  # guarded-by: _lock
        self.slo = SloWatchdog(
            step_regression_pct=conf.get_int(
                K.SLO_STEP_TIME_REGRESSION_PCT, 0),
            goodput_floor_pct=conf.get_int(K.SLO_GOODPUT_FLOOR_PCT, 0))
        # rule-driven alerting (the JAX package's observability/alerts.py)
        # is not in the port: a configuration with a live rule is refused
        # at the start (unported_feature), so the tony.slo.* watchdog
        # above is the only alerting path and it keeps its thresholds
        # cross-task skew analytics + straggler detection
        # (observability/skew.py): the MetricsStore offers every numeric
        # gauge to the tracker's windowed sketches (O(buckets) per
        # signal-window, independent of gang width); the analyzer runs on
        # the monitor-loop cadence next to _check_slo. Remediation
        # (tony.straggler.relaunch-after-windows > 0) routes a persistent
        # steady-state straggler through the task-attempt relaunch
        # machinery — attempt-fenced, budget-counted, downtime attributed
        # like any other relaunch.
        self._straggler_enabled = conf.get_bool(K.STRAGGLER_ENABLED, True)
        self._straggler_window_ms = conf.get_time_ms(
            K.STRAGGLER_WINDOW_MS, 15_000)
        self._build_skew_state()
        # fleet registry (observability/fleet.py): with a staging
        # location configured, a compact heartbeat-stamped jobstate.json
        # summary is republished at tony.fleet.publish-interval-ms —
        # the live cross-job view rides the store, not a new RPC
        self._fleet_store = None     # built in prepare()
        self._fleet_interval_s = conf.get_time_ms(
            K.FLEET_PUBLISH_INTERVAL_MS, 5000) / 1000.0
        self._fleet_last_publish = 0.0
        # last closed window's gang step-time spread (set by
        # _check_stragglers; mirrored into the jobstate gauges so the
        # fleet /metrics carries the same numbers as the AM /metrics)
        self._step_time_quantiles: dict[str, float] = {}
        # live logs + failure diagnostics (observability/logs.py):
        # executors gossip their TaskLogService address on heartbeats
        # (task_id -> (attempt, "host:port"), attempt-fenced so a zombie
        # can't hijack the replacement's tail); every observed task
        # failure becomes one attempt-fenced record — the raw material of
        # the diagnostics.json root-cause bundle a failed job flushes
        self._log_tail_bytes = conf.get_int(K.LOGS_TAIL_BYTES, 65536)
        self._log_chunk_bytes = conf.get_int(K.LOGS_CHUNK_BYTES, 32768)
        self._diag_lines = conf.get_int(K.LOGS_DIAGNOSTICS_LINES, 200)
        self._log_addrs: dict[str, tuple[int, str]] = {}  # guarded-by: _lock
        # wedge autopsy (observability/profiler.py): when liveliness
        # expiry / the registration deadline / recovery settle declares a
        # task suspect, its executor's redacted all-thread stack dump is
        # pulled over the SAME token-authed log service and folded into
        # diagnostics.json — task_id -> {attempt, generated_ms,
        # blocking_frame, threads}. _remote_stalls latches the
        # PROCESS_STALL_DETECTED event per task so the history carries
        # exactly one detect/clear pair per wedge, never a storm.
        self._task_stacks: dict[str, dict] = {}  # guarded-by: _lock
        self._remote_stalls: dict[str, dict] = {}  # guarded-by: _lock
        # in-process continuous profiler + stall watchdog, handed over by
        # __main__ (or a harness) via adopt_profiler — the AM flushes the
        # collapsed-stack profile into history at finish and serves it
        # live over get_profile
        self._profiler = None
        self._stall_watchdog = None
        # follow-mode polls arrive every ~500 ms per follower: reuse ONE
        # channel per (task, attempt, addr) instead of a fresh TCP+HTTP/2
        # handshake per chunk; displaced entries are closed
        self._log_clients: dict[str, tuple[int, str, object]] = {}  # guarded-by: _lock
        # (task_id, attempt) -> failure record; first observer wins (one
        # crash has up to three observers — result RPC, completion
        # callback, heartbeat expiry — and the executor's own redacted
        # report is the best evidence, so it is recorded before the
        # relaunch decision runs)
        self._failure_records: dict[tuple[str, int], dict] = {}  # guarded-by: _lock
        self._root_span = None
        self._rendezvous_span = None
        # (task_id, attempt) -> open task span (allocation → completion)
        self._task_spans: dict[tuple[str, int], object] = {}
        self._metrics_http = None
        self._session_id = 0
        self._rpc_server = None
        self.rpc_port = 0
        self.host = current_host()
        # monitor-loop condition flags (ApplicationMaster.java fields)
        self._client_signal_stop = threading.Event()
        self._killed_by_client = False
        self._task_missed_hb = False
        self._untracked_task_failed = False
        self._unsatisfiable_request: Optional[str] = None
        self._registration_deadline: Optional[float] = None
        self._preprocess_exit_code = 0
        self._preprocess_finished = False
        self._model_params: Optional[str] = None
        self._single_node = conf.get_bool(K.APPLICATION_SINGLE_NODE, False)
        # container bookkeeping: container_id -> (task, session_id at launch)
        self._launched: dict[str, tuple[Task, int]] = {}  # guarded-by: _lock
        self._finished_containers: set[str] = set()  # guarded-by: _lock
        self._session_containers: dict[int, list[str]] = {}  # guarded-by: _lock
        # task-attempt fault tolerance: cumulative tracked-task failures
        # across attempts AND sessions (feeds the
        # tony.application.max-total-task-failures circuit breaker)
        self._total_task_failures = 0  # guarded-by: _lock
        self._alloc_timeout_ms = conf.get_time_ms(
            K.CONTAINER_ALLOCATION_TIMEOUT, 15 * 60 * 1000)
        self._lock = threading.RLock()
        self._tb_url = ""  # guarded-by: _lock
        # serving endpoints announced via register_serving_endpoint:
        # task_id -> {"url", "generation", "draining"} (serve/ subsystem;
        # surfaced in task infos — the fleet router's endpoint-set source
        # — and as SERVING_ENDPOINT_REGISTERED history events). generation
        # is the weights rollout epoch; draining means "stop new sends,
        # in-flight finishes" (relaunch/preemption/scale-down ahead).
        self._serving_endpoints: dict[str, dict] = {}  # guarded-by: _lock
        # serving-fleet lifecycle: the AM-side weights epoch new
        # registrations are stamped with (request_rolling_update bumps
        # it) and the in-flight rollout state machine (one replica at a
        # time; advanced by _check_rolling_update on the monitor
        # cadence). The replica autoscaler is not in the port: a
        # configuration that enables it is refused at the start.
        self._weights_generation = 0  # guarded-by: _lock
        self._rolling: Optional[dict] = None  # guarded-by: _lock
        self._wake = threading.Event()   # kick the monitor loop early
        # elastic gang resize (cluster/elastic.py): grow/shrink the
        # RUNNING training gang in place — quiesce → in-place emergency
        # checkpoint → membership change behind a generation bump →
        # survivors re-rendezvous via spec diffs → reshard-restore.
        # Always constructed (cheap); tony.elastic.enabled gates every
        # trigger inside it.
        from tony_tpu_torch.cluster.elastic import ElasticCoordinator
        self.elastic = ElasticCoordinator(self)
        # timings (reference cadences, TonyConfigurationKeys.java:143-150)
        self._hb_interval_ms = conf.get_time_ms(K.TASK_HEARTBEAT_INTERVAL_MS, 1000)
        self._max_missed_hb = conf.get_int(K.TASK_MAX_MISSED_HEARTBEATS, 25)
        self._monitor_interval = conf.get_time_ms(K.AM_MONITOR_INTERVAL_MS, 5000) / 1000.0
        # control-plane sizing scales with gang width (coalesced control
        # plane): liveliness shards so 1 s pings never
        # contend with the expiry scan, and (in prepare) the RPC handler
        # pool so width heartbeats don't queue behind a fixed 16 threads
        try:
            from tony_tpu_torch.session.requests import parse_container_requests
            self._gang_width = sum(
                r.num_instances
                for r in parse_container_requests(conf).values())
        except Exception:  # noqa: BLE001 — sizing must not block AM boot
            self._gang_width = 0
        shards = conf.get_int(K.AM_LIVELINESS_SHARDS, 0)
        if shards <= 0:
            shards = auto_liveliness_shards(self._gang_width)
        self.hb_monitor = LivelinessMonitor(
            self._hb_interval_ms, self._max_missed_hb,
            self._on_task_deemed_dead, shards=shards)
        if self._straggler_enabled:
            # heartbeat lag is one of the skew signals (ms, per ping)
            self.hb_monitor.lag_sink = (
                lambda task_id, lag_sec: self.skew_tracker.observe(
                    task_id, "heartbeat_lag_ms", lag_sec * 1000.0))
        # event history → per-app subdir of the intermediate dir; the
        # portal's mover later relocates finished apps into finished/y/M/d
        # (reference: tony.history.intermediate + setupJobDir,
        # ApplicationMaster.java:454-460)
        hist_base = conf.get_str(K.HISTORY_INTERMEDIATE) or os.path.join(
            self.app_dir, C.HISTORY_DIR_NAME)
        self.history_dir = os.path.join(hist_base, app_id)
        # AM crash survivability (am/journal.py + am/supervisor.py): a
        # supervised restart sets TONY_AM_ATTEMPT > 0; a journal left in
        # the app dir means the predecessor died mid-lifecycle — replay
        # it and ADOPT the still-running gang instead of relaunching it
        self._am_attempt = int(os.environ.get(C.AM_ATTEMPT, "0") or 0)
        journal_enabled = conf.get_bool(K.AM_JOURNAL_ENABLED, True)
        self.journal = J.ControlPlaneJournal(
            self.app_dir, am_attempt=self._am_attempt,
            snapshot_every=conf.get_int(K.AM_JOURNAL_SNAPSHOT_EVERY, 256),
            enabled=journal_enabled)
        self._recovering = (self._am_attempt > 0 and journal_enabled
                            and J.has_journal(self.app_dir))
        # adoption barrier: {pending, adopted, deadline, started,
        # replayed, pre_downtime_ms} while a recovery is in flight
        self._recovery: Optional[dict] = None  # guarded-by: _lock
        self._recovery_settle_ms = conf.get_time_ms(
            K.AM_RECOVERY_SETTLE_MS, 30_000)
        # control-plane downtime: the am_downtime goodput phase — wall
        # clock with no AM alive (crash → journal replay) plus the
        # adoption barrier window, priced against job goodput like
        # relaunch/preemption/resize downtime
        self._am_downtime_s = 0.0
        self._last_clock_rec: dict = {}
        self.metadata = JobMetadata(application_id=app_id,
                                    started=int(time.time() * 1000))
        self.event_handler = EventHandler(self.history_dir, self.metadata,
                                          resume=self._am_attempt > 0)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def prepare(self) -> None:
        """Start RPC + backend and announce the AM address
        (ApplicationMaster.prepare, ApplicationMaster.java:391-475)."""
        # security: require the client-minted app secret on every RPC
        # (reference secret-manager wiring, ApplicationMaster.java:432-452)
        self._auth_token = None
        if self.conf.get_bool(K.APPLICATION_SECURITY_ENABLED, False):
            from tony_tpu_torch.security import read_token_file
            self._auth_token = read_token_file(self.app_dir)
            if not self._auth_token:
                raise RuntimeError(
                    "security enabled but no token file in app dir")
        rpc_workers = self.conf.get_int(K.AM_RPC_WORKERS, 0)
        if rpc_workers <= 0:
            rpc_workers = auto_rpc_workers(self._gang_width)
        self._rpc_server, self.rpc_port = serve(
            cluster_handler=self, metrics_handler=self.metrics_store,
            auth_token=self._auth_token, max_workers=rpc_workers)
        # off-host executors can't read the client's app dir — publish the
        # frozen conf through the staging store and hand its URI to every
        # container (the reference localized tony-final.xml from HDFS into
        # each container, TonyClient.java:219-227 / TaskExecutor.java:269)
        self._conf_uri = ""
        staging_loc = self.conf.get_str(K.STAGING_LOCATION, "")
        if staging_loc:
            from tony_tpu_torch.storage import staging_store
            store = staging_store(staging_loc, self.app_dir)
            conf_file = os.path.join(self.app_dir, C.TONY_FINAL_CONF)
            if os.path.exists(conf_file):
                self._conf_uri = store.put(conf_file, C.TONY_FINAL_CONF)
            # the fleet registry publishes into the same per-app
            # namespace ("" = app-local staging stays registry-less:
            # there is no shared location a portal could scan)
            self._fleet_store = store
        self.backend.set_callbacks(self._on_container_allocated,
                                   self._on_container_completed)
        self.backend.start()
        self.hb_monitor.start()
        self.event_handler.start()
        self._write_history_config()
        self._write_am_info()
        self._start_trace()
        self._start_metrics_endpoint()
        hostport_path = os.path.join(self.app_dir, C.AM_HOSTPORT_FILE)
        tmp = hostport_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(f"{self.host}:{self.rpc_port}")
        os.replace(tmp, hostport_path)
        LOG.info("AM RPC serving at %s:%d", self.host, self.rpc_port)
        if self._recovering:
            # flap guard: the registry entry went LOST with the crashed
            # AM's heartbeat — republish on the NEW address immediately
            # (RECOVERING, not RUNNING: running is gated on the adoption
            # barrier), so the fleet refolds LOST→RECOVERING→RUNNING
            # instead of dropping the job
            self._publish_fleet_state("RECOVERING", force=True)

    def _write_am_info(self) -> None:
        """Publish this AM's RPC address into the history dir so the
        portal can reach a RUNNING job's control plane (the profile
        button's POST /api/jobs/:id/profile needs an address the
        history-based portal can discover)."""
        try:
            from tony_tpu_torch.events.history import write_json_atomic
            write_json_atomic(
                os.path.join(self.history_dir, C.AM_INFO_FILE),
                {"host": self.host, "rpc_port": self.rpc_port,
                 "app_id": self.app_id,
                 # the portal holds no credential: on a secured cluster
                 # its profile POST must answer "use the CLI" instead of
                 # misreporting an AM outage
                 "security_enabled": bool(self._auth_token)})
        except Exception:  # noqa: BLE001 — observability must not kill the AM
            LOG.exception("failed to write AM info file")

    def _start_trace(self) -> None:
        """Open the application root span and back-fill the client-side
        submit span from the trace seed the client wrote into the app dir
        (the client process can't push spans to an AM that doesn't exist
        yet, so the handoff is a file — start = submit time, end = now,
        i.e. the span covers submission + resource staging + AM boot)."""
        if not self._trace_enabled:
            return
        self._root_span = self.tracer.start("application")
        seed_path = os.path.join(self.app_dir, C.TRACE_SEED_FILE)
        try:
            with open(seed_path, "r", encoding="utf-8") as f:
                seed = json.load(f)
            submit_ms = int(seed.get("submit_ms", 0))
        except (OSError, ValueError, json.JSONDecodeError):
            submit_ms = 0
        if submit_ms > 0:
            submit = self.tracer.start("client_submit",
                                       parent=self._root_span)
            submit.start_ms = submit_ms
            self.tracer.end(submit, attrs={"staged_via": "app_dir"})

    def _start_metrics_endpoint(self) -> None:
        """Prometheus /metrics scrape endpoint (tony.metrics.port; -1
        disables). The bound port is written to the app dir so operators
        and tests can find an ephemeral one."""
        port = self.conf.get_int(K.METRICS_PORT, 0)
        if port < 0:
            return
        try:
            from tony_tpu_torch.observability.http import MetricsHTTPServer
            self._metrics_http = MetricsHTTPServer(self._render_prometheus,
                                                   port=port)
            self._metrics_http.start()
            path = os.path.join(self.app_dir, C.AM_METRICS_PORT_FILE)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(str(self._metrics_http.port))
            os.replace(tmp, path)
            LOG.info("AM /metrics on port %d", self._metrics_http.port)
        except Exception:  # noqa: BLE001 — observability must not kill the AM
            LOG.exception("could not start the /metrics endpoint")
            self._metrics_http = None

    def _render_prometheus(self) -> str:
        """Task gauges (latest values, {app_id,task_type,index,attempt}
        labels) + job-level goodput + this AM process's own health
        registry."""
        from tony_tpu_torch.observability.metrics import REGISTRY
        from tony_tpu_torch.observability.prometheus import render
        families = self.metrics_store.prometheus_families(self.app_id)
        if self._goodput_enabled:
            job = self.goodput_dict()["job"]
            labels = {"app_id": self.app_id}
            for key, name in (
                    ("goodput_pct", "tony_job_goodput_pct"),
                    ("productive_s", "tony_job_productive_seconds"),
                    ("relaunch_downtime_s",
                     "tony_job_relaunch_downtime_seconds")):
                families.append({"name": name, "type": "gauge", "help": "",
                                 "samples": [(labels, float(job[key]))]})
            families.append({
                "name": "tony_job_preemptions_total", "type": "gauge",
                "help": "", "samples": [(labels, float(
                    self._preempt_count
                    + (1 if self._preemption is not None else 0)))]})
            families.append({
                "name": "tony_job_resizes_total", "type": "gauge",
                "help": "", "samples": [(labels, float(
                    self.elastic.resizes_total))]})
        families += REGISTRY.families()
        return render(families)

    def goodput_dict(self) -> dict:
        """Job-level time accounting: per-task ledgers (pushed as
        GOODPUT_* gauges over the metrics RPC) + the fault-tolerance
        layer's relaunch downtime (observability/perf.py
        aggregate_goodput) — the shape flushed as goodput.json."""
        from tony_tpu_torch.observability.perf import aggregate_goodput
        with self._lock:
            downtime = self._relaunch_downtime_s
            now = time.monotonic()
            # in-flight relaunch gaps count at their elapsed-so-far, so a
            # live scrape mid-relaunch already shows the bleeding
            downtime += sum(now - t0
                            for t0 in self._relaunch_pending_since.values())
            # superseded attempts appear as their own "<task>@aN" entries
            # so their wall/productive time stays in the job totals
            per_task = dict(self._goodput_archive)
            # AM downtime: folded crash gaps + the in-flight adoption
            # barrier at its elapsed-so-far, mirroring the relaunch clock
            am_downtime = self._am_downtime_s
            if self._recovery is not None:
                am_downtime += now - self._recovery["started"]
        per_task.update(self.metrics_store.latest_gauges())
        return aggregate_goodput(
            per_task, relaunch_downtime_s=downtime,
            preemption_downtime_s=self._preemption_downtime_s,
            resize_downtime_s=self.elastic.downtime_s(),
            am_downtime_s=am_downtime)

    def fleet_summary(self, state: str) -> dict:
        """The compact jobstate entry this AM contributes to the live
        cross-job registry (observability/fleet.py): identity (app,
        queue, user), gang shape, chip occupancy, and the job-level
        health numbers — every `tony_job_*` gauge the AM exports lands
        in the `gauges` map so the fleet /metrics re-exposition carries
        exactly what the per-job /metrics does."""
        from tony_tpu_torch.conf.queues import app_queue, total_requested_tpus
        from tony_tpu_torch.observability import fleet
        session = self.session
        gang_width = session.total_tracked_tasks() \
            if session is not None else 0
        allocated = 0
        if session is not None:
            for job_name, req in session.requests.items():
                live = sum(1 for t in session.job_tasks.get(job_name, [])
                           if t.container_id and not t.completed)
                allocated += live * req.tpus
        gauges: dict[str, float] = {}
        goodput_pct = mfu = None
        if self._goodput_enabled:
            gd = self.goodput_dict()
            job = gd["job"]
            if gd["tasks"]:
                goodput_pct = job["goodput_pct"]
            gauges["tony_job_goodput_pct"] = float(job["goodput_pct"])
            gauges["tony_job_productive_seconds"] = float(
                job["productive_s"])
            gauges["tony_job_relaunch_downtime_seconds"] = float(
                job["relaunch_downtime_s"])
            mfus = [e["mfu_pct"] for e in gd["tasks"].values()
                    if isinstance(e.get("mfu_pct"), (int, float))]
            if mfus:
                mfu = round(sum(mfus) / len(mfus), 3)
        straggler_count = (len(self.straggler.active())
                           if self._straggler_enabled else 0)
        gauges["tony_job_straggler_count"] = float(straggler_count)
        alerts_firing = 0   # no alert engine in the port (refused)
        gauges["tony_job_alerts_firing"] = float(alerts_firing)
        preemptions = self._preempt_count \
            + (1 if self._preemption is not None else 0)
        gauges["tony_job_preemptions_total"] = float(preemptions)
        gauges["tony_job_resizes_total"] = float(self.elastic.resizes_total)
        for q, gauge_name in fleet.STEP_TIME_GAUGES.items():
            if q in self._step_time_quantiles:
                gauges[gauge_name] = self._step_time_quantiles[q]
        # serving throughput, summed across serving slots (the closest
        # live QPS signal the engine exports)
        serving_tps = None
        tps = [g["SERVING_TOKENS_PER_SEC"]
               for g in self.metrics_store.latest_gauges().values()
               if isinstance(g.get("SERVING_TOKENS_PER_SEC"),
                             (int, float))]
        if tps:
            serving_tps = round(sum(tps), 3)
        from tony_tpu_torch.conf.queues import app_priority
        # elastic width surface: current vs requested gang width (a
        # resize in flight shows its target fleet-wide), the resize
        # count, and the reclaim floor the arbiter's
        # reclaim-instead-of-evict verdict needs. requested_chips comes
        # from the LIVE session (a resize moves it off the frozen conf).
        width_fields = self.elastic.width_fields(gang_width)
        elastic_job = ""
        elastic_min_chips = 0
        elastic_width = 0
        elastic_cpt = 0
        if self.elastic.enabled and session is not None:
            elastic_job = self.elastic._default_job() or ""
            if elastic_job:
                req = session.requests[elastic_job]
                elastic_width = req.num_instances
                elastic_cpt = max(1, req.tpus)
                elastic_min_chips = self.elastic.min_width * elastic_cpt
        requested_chips = (sum(r.num_instances * r.tpus
                               for r in session.requests.values())
                           if session is not None
                           else total_requested_tpus(self.conf))
        return fleet.job_summary(
            self.app_id, self.metadata.user, app_queue(self.conf), state,
            gang_width=gang_width,
            requested_width=width_fields["requested_width"],
            resizes=self.elastic.resizes_total,
            elastic_job=elastic_job,
            elastic_width=elastic_width,
            elastic_chips_per_task=elastic_cpt,
            elastic_min_width=width_fields["elastic_min_width"],
            elastic_max_width=width_fields["elastic_max_width"],
            elastic_min_chips=elastic_min_chips,
            requested_chips=requested_chips,
            allocated_chips=allocated,
            started_ms=self.metadata.started,
            goodput_pct=goodput_pct, mfu_pct=mfu,
            straggler_count=straggler_count,
            alerts_firing=alerts_firing,
            serving_tokens_per_sec=serving_tps,
            preemptions=preemptions,
            priority=app_priority(self.conf),
            # the arbiter reaches a victim's control plane through the
            # registry entry — no extra discovery file
            am_addr=(f"{self.host}:{self.rpc_port}"
                     if self.rpc_port else ""),
            gauges=gauges)

    def _publish_fleet_state(self, state: str = "RUNNING",
                             force: bool = False) -> None:
        """Republish this job's registry entry (throttled to
        tony.fleet.publish-interval-ms; monitor-loop cadence). No-op
        without a shared staging location — there is no store another
        process could scan."""
        if self._fleet_store is None:
            return
        now = time.monotonic()
        if not force and now - self._fleet_last_publish \
                < self._fleet_interval_s:
            return
        self._fleet_last_publish = now
        try:
            from tony_tpu_torch.observability import fleet
            fleet.publish_job_state(self._fleet_store,
                                    self.fleet_summary(state),
                                    self.app_dir)
        except Exception:  # noqa: BLE001 — fleet must never kill the AM
            LOG.exception("fleet jobstate publish failed")

    def _task_span_start(self, task: Task, container: Container) -> None:
        """Open the allocation→completion span for one task attempt; its
        span id is the trace parent rendered into the container env."""
        if not self._trace_enabled:
            return
        span = self.tracer.start(
            f"task:{task.task_id}", parent=self._root_span,
            task_id=task.task_id, attempt=task.attempt,
            attrs={"container_id": container.container_id,
                   "host": container.host, "job_name": task.job_name})
        self._task_spans[(task.task_id, task.attempt)] = span

    def _task_span_end(self, task_id: str, attempt: int, status: str,
                       reason: str = "") -> None:
        span = self._task_spans.pop((task_id, attempt), None)
        if span is not None:
            self.tracer.end(span, status,
                            attrs={"reason": reason} if reason else None)

    def _rendezvous_span_start(self, reason: str) -> None:
        if not self._trace_enabled:
            return
        if self._rendezvous_span is not None:
            self.tracer.end(self._rendezvous_span, "ERROR",
                            attrs={"reason": "superseded"})
        self._rendezvous_span = self.tracer.start(
            "rendezvous", parent=self._root_span, attrs={"reason": reason})

    def _rendezvous_span_end(self, status: str = "OK") -> None:
        if self._rendezvous_span is not None:
            self.tracer.end(self._rendezvous_span, status)
            self._rendezvous_span = None

    def _flush_observability(self) -> None:
        """Spans + metric timeseries into the history dir, next to the
        event log (the portal's waterfall and metrics.json sources)."""
        from tony_tpu_torch.events.history import (
            write_goodput_file, write_metrics_file,
            write_serving_traces_file, write_skew_file, write_spans_file,
        )
        try:
            if self._trace_enabled:
                for span in list(self._task_spans.values()):
                    self.tracer.end(span, "ERROR",
                                    attrs={"reason": "am-shutdown"})
                self._task_spans.clear()
                write_spans_file(self.history_dir, self.span_store.to_list())
            write_metrics_file(self.history_dir,
                               self.metrics_store.timeseries_dict())
            traces = self.metrics_store.serving_traces()
            if traces:
                # request traces only exist when a serving jobtype ran —
                # an empty sidecar would read as "traced, found nothing"
                write_serving_traces_file(self.history_dir, traces)
            if self._goodput_enabled:
                write_goodput_file(self.history_dir, self.goodput_dict())
            if self._straggler_enabled:
                # fold the still-open window in first so a short run's
                # skew story isn't lost to an unclosed window
                self.skew_tracker.maybe_roll(self._straggler_window_ms,
                                             force=True)
                write_skew_file(self.history_dir,
                                self.skew_tracker.bundle(self.straggler))
            if self._profiler is not None:
                # the control-plane flamegraph travels with the history:
                # collapsed-stack text, redacted at flush
                from tony_tpu_torch.events.history import write_profile_file
                write_profile_file(self.history_dir,
                                   self._profiler.folded_text())
        except Exception:  # noqa: BLE001 — observability must not fail _finish
            LOG.exception("failed to flush spans/metrics into history")

    def _aggregate_container_logs(self) -> None:
        """Copy every container's stdout/stderr into the history dir
        (`<history>/logs/<container-dir>/<stream>`) — the
        YARN-log-aggregation role. The reference's portal linked to live
        NodeManager web servers (models/JobLog.java:27-60); here no such
        server exists after the app dies, so the logs travel WITH the
        history and the portal serves them itself (/logs/:id/:task/:stream).
        Files are tail-capped at tony.history.log-max-size.

        This is the finish-time sweep; it RE-copies dirs the incremental
        path already aggregated (cheap — tail-capped files) so the final
        history always holds the complete stream."""
        src_root = os.path.join(self.app_dir, C.CONTAINERS_DIR_NAME)
        if not os.path.isdir(src_root):
            return
        try:
            for cdir in sorted(os.listdir(src_root)):
                self._aggregate_one_container(cdir)
        except Exception:  # noqa: BLE001 — observability must not fail the app
            LOG.exception("container log aggregation failed")

    def _aggregate_one_container(self, cdir: str) -> None:
        """Aggregate ONE container dir's streams into history. Called at
        finish (the sweep above), at task completion, and when a relaunch
        supersedes an attempt — so an AM crash or `kill -9` after that
        point no longer loses the logs, and the portal's permanent
        'logs unavailable (not aggregated)' state for such jobs is gone."""
        src_root = os.path.join(self.app_dir, C.CONTAINERS_DIR_NAME)
        cap = self.conf.get_memory_mb(K.HISTORY_LOG_MAX_SIZE, 10) \
            * 1024 * 1024
        dst_root = os.path.join(self.history_dir, C.HISTORY_LOGS_DIR_NAME)
        try:
            for stream in ("stdout", "stderr"):
                src = os.path.join(src_root, cdir, stream)
                if not os.path.isfile(src):
                    continue
                dst_dir = os.path.join(dst_root, cdir)
                os.makedirs(dst_dir, exist_ok=True)
                size = os.path.getsize(src)
                with open(src, "rb") as fin, \
                        open(os.path.join(dst_dir, stream), "wb") as fo:
                    if size > cap:
                        # keep the TAIL — failures print last
                        fin.seek(size - cap)
                        fo.write(b"[... truncated by log "
                                 b"aggregation ...]\n")
                    while True:
                        chunk = fin.read(1 << 20)
                        if not chunk:
                            break
                        fo.write(chunk)
        except Exception:  # noqa: BLE001 — observability must not fail the app
            LOG.exception("log aggregation failed for %s", cdir)

    def _aggregate_task_container(self, task: Task) -> None:
        """Incremental aggregation for the container a task is (or was)
        running in, derived from the stdout path recorded at launch."""
        url = getattr(task, "url", "")
        if url:
            self._aggregate_one_container(os.path.basename(
                os.path.dirname(url)))

    # ------------------------------------------------------------------
    # failure diagnostics (observability/logs.py)
    # ------------------------------------------------------------------
    def _record_task_failure(self, task_id: str, attempt: int, reason: str,
                             exit_code: Optional[int] = None,
                             diagnostics: Optional[dict] = None,
                             container_dir: str = "") -> None:
        """One attempt-fenced failure record. First observer wins: the
        executor's own redacted report (register_execution_result
        `diagnostics`) usually lands first and is the best evidence; a
        container-completion or heartbeat-expiry observer of the SAME
        (task, attempt) only fills the slot if nothing did yet, reading
        the container's files itself (local/shared-fs backends) for the
        tail + signature."""
        key = (task_id, max(attempt, 0))
        with self._lock:
            if key in self._failure_records:
                return
        # build the FULL record outside the lock (the tail read is file
        # I/O), publish atomically below — a concurrent diagnostics
        # flush must never snapshot a half-built record
        record = {
            "task_id": task_id, "attempt": max(attempt, 0),
            "ts_ms": int(time.time() * 1000), "reason": reason,
            "exit_code": exit_code,
        }
        try:
            from tony_tpu_torch.observability import logs as tlogs
            if diagnostics:
                body = dict(diagnostics)
                body.pop("task_id", None)
                body.pop("attempt", None)
                record.update(body)
                record["source"] = "executor"
            elif container_dir and os.path.isdir(container_dir):
                record.update(tlogs.classify_container_failure(
                    container_dir, exit_code, self._diag_lines,
                    tail_bytes=self._log_tail_bytes))
                record["source"] = "am"
            else:
                record.update(tlogs.decode_exit(exit_code))
                record["source"] = "am"
            if "signature" not in record:
                sig = tlogs.classify(reason)
                if sig:
                    record.update(sig)
        except Exception:  # noqa: BLE001 — diagnostics must not fail the AM
            LOG.exception("failed to enrich failure record for %s", task_id)
        with self._lock:
            # first COMPLETE record wins (two observers may build
            # concurrently; the executor's shipped report is cheap to
            # build, so it tends to land first — the preferred evidence)
            if key in self._failure_records:
                return
            self._failure_records[key] = record
        LOG.warning("recorded failure of %s attempt %d (%s, signature=%s)",
                    task_id, max(attempt, 0), reason,
                    record.get("signature", "none"))

    # ------------------------------------------------------------------
    # continuous profiler + wedge autopsy (observability/profiler.py)
    # ------------------------------------------------------------------
    def adopt_profiler(self, profiler, watchdog) -> None:
        """Adopt the process-wide SamplingProfiler/StallWatchdog pair
        installed by __main__ (or a test harness): the watchdog's
        latched stall transitions become history events, the profiler's
        collapsed-stack table is served live over get_profile and
        flushed into history as profile.folded at finish."""
        self._profiler = profiler
        self._stall_watchdog = watchdog
        if watchdog is not None:
            watchdog.set_event_sink(self._on_stall_event)

    def _on_stall_event(self, name: str, payload: dict) -> None:
        """StallWatchdog sink: a local daemon loop's latched stall
        transition (detect/clear, never a storm) lands in the event
        history next to the task lifecycle it wedged."""
        from tony_tpu_torch.observability.profiler import STALL_DETECTED
        try:
            if name == STALL_DETECTED:
                self.event_handler.emit(Event(
                    EventType.PROCESS_STALL_DETECTED,
                    ProcessStallDetected(
                        process=str(payload.get("process", "am")),
                        beacon=str(payload.get("beacon", "")),
                        stalled_ms=float(payload.get("stalled_ms", 0.0)),
                        cadence_ms=float(payload.get("cadence_ms", 0.0)),
                        blocking_frame=str(
                            payload.get("blocking_frame", "")))))
            else:
                self.event_handler.emit(Event(
                    EventType.PROCESS_STALL_CLEARED,
                    ProcessStallCleared(
                        process=str(payload.get("process", "am")),
                        beacon=str(payload.get("beacon", "")),
                        stalled_ms=float(payload.get("stalled_ms", 0.0)),
                        blocking_frame=str(
                            payload.get("blocking_frame", "")),
                        reason="recovered")))
        except Exception:  # noqa: BLE001 — observability must not kill the AM
            LOG.exception("failed to emit stall event")

    def _capture_task_stacks(self, task_id: str, attempt: int,
                             reason: str) -> Optional[dict]:
        """Wedge autopsy: pull the suspect executor's redacted all-thread
        stack dump over its token-authed log service (the read runs on a
        gRPC worker thread over there, so it answers even while the
        executor's MAIN thread is parked in the wedged frame). The
        capture feeds the diagnostics bundle's `stacks` section and
        latches one PROCESS_STALL_DETECTED event naming the dominant
        blocking frame. Best-effort: a crashed (vs wedged) executor
        simply doesn't answer and the autopsy records nothing — the
        distinction is itself the diagnosis."""
        with self._lock:
            entry = self._log_addrs.get(task_id)
        if entry is None:
            return None
        try:
            client = self._log_client(task_id, entry[0], entry[1])
            dump = client.read_stacks()
        except Exception:  # noqa: BLE001 — a crashed executor can't answer
            LOG.info("stack capture from %s (%s) failed — crashed, not "
                     "wedged", task_id, entry[1], exc_info=True)
            return None
        if not isinstance(dump, dict) or dump.get("error") \
                or not dump.get("threads"):
            return None
        from tony_tpu_torch.observability.profiler import dominant_frame
        frame = dominant_frame(dump.get("threads") or [])
        record = {
            "task_id": task_id, "attempt": max(attempt, 0),
            "reason": reason,
            "generated_ms": int(dump.get("generated_ms", 0) or 0),
            "blocking_frame": frame,
            "threads": dump.get("threads") or [],
        }
        with self._lock:
            self._task_stacks[task_id] = record
            already = task_id in self._remote_stalls
            if not already:
                self._remote_stalls[task_id] = {
                    "since_ms": int(time.time() * 1000),
                    "blocking_frame": frame, "attempt": max(attempt, 0)}
        if not already:
            self.event_handler.emit(Event(
                EventType.PROCESS_STALL_DETECTED,
                ProcessStallDetected(
                    process=f"executor:{task_id}",
                    beacon="task-heartbeat",
                    stalled_ms=float(self._max_missed_hb
                                     * self._hb_interval_ms),
                    cadence_ms=float(self._hb_interval_ms),
                    blocking_frame=frame,
                    task_id=task_id, attempt=max(attempt, 0))))
        LOG.warning("wedge autopsy for %s attempt %d: %d thread(s) "
                    "captured, blocked in %s", task_id, max(attempt, 0),
                    len(record["threads"]), frame or "<unknown>")
        return record

    def _clear_remote_stall(self, task_id: str, reason: str) -> None:
        """Close a latched remote-stall pair (the slot was relaunched
        past the wedge, or the session/application is tearing down) —
        the history must always carry the CLEARED half."""
        with self._lock:
            latch = self._remote_stalls.pop(task_id, None)
        if latch is None:
            return
        try:
            self.event_handler.emit(Event(
                EventType.PROCESS_STALL_CLEARED,
                ProcessStallCleared(
                    process=f"executor:{task_id}",
                    beacon="task-heartbeat",
                    stalled_ms=float(
                        int(time.time() * 1000) - latch["since_ms"]),
                    blocking_frame=latch.get("blocking_frame", ""),
                    task_id=task_id,
                    attempt=int(latch.get("attempt", 0)),
                    reason=reason)))
        except Exception:  # noqa: BLE001 — observability must not kill the AM
            LOG.exception("failed to emit stall-cleared for %s", task_id)

    def _capture_barrier_stacks(self, limit: int = 8) -> None:
        """Barrier-timeout autopsy: tasks that heartbeated (so their
        stack-service address is known) but the gang never completed
        registration — exactly the wedged-in-localization suspects.
        Bounded: at width 1k the failing session must not serially pull
        a thousand dumps before it can report."""
        session = self.session
        if session is None:
            return
        with self._lock:
            addrs = dict(self._log_addrs)
        captured = 0
        for tasks in session.job_tasks.values():
            for task in tasks:
                if captured >= limit:
                    return
                if task.completed or task.task_id not in addrs:
                    continue
                if self._capture_task_stacks(
                        task.task_id, task.attempt,
                        "registration deadline expired") is not None:
                    captured += 1

    def _assemble_diagnostics(self, status: str) -> Optional[dict]:
        """The root-cause bundle for a failed/killed job: every failure
        record ordered by observation time, the FIRST one called out as
        the root cause (first failure by timestamp across attempts — at
        gang width every peer dies of the first victim's collapse, so
        ordering is the diagnosis), plus span links into the waterfall.
        Written as diagnostics.json next to the event log and announced
        with a DIAGNOSTICS_READY event."""
        with self._lock:
            records = sorted(self._failure_records.values(),
                             key=lambda r: (r.get("ts_ms", 0),
                                            r.get("task_id", "")))
        session = self.session
        message = session.final_message if session is not None else None
        if not records and status == "SUCCEEDED":
            return None
        first = records[0] if records else None
        bundle = {
            "app_id": self.app_id,
            "status": status,
            "message": message or "",
            "generated_ms": int(time.time() * 1000),
            "line_budget": self._diag_lines,
            "first_failure": first,
            "failures": records,
        }
        with self._lock:
            stacks = dict(self._task_stacks)
        if stacks:
            # wedge autopsies: per-task all-thread dumps pulled from
            # suspect executors, each naming its dominant blocking frame
            # ("it is stuck in LocalizationCache.materialize")
            bundle["stacks"] = stacks
        if first is not None:
            # link the failing task's lifecycle spans so the bundle jumps
            # straight into the waterfall (same trace_id = app_id)
            task_id = first.get("task_id", "")
            spans = [
                {k: s.get(k) for k in ("name", "span_id", "start_ms",
                                       "end_ms", "status")}
                for s in self.span_store.to_list()
                if s.get("task_id") == task_id
            ][:32]
            bundle["first_failure_spans"] = spans
        return bundle

    def _flush_diagnostics(self, status: str) -> None:
        """Assemble + persist the bundle and emit DIAGNOSTICS_READY (part
        of _finish, BEFORE the event log closes). Succeeding jobs write
        nothing — the file's existence means 'there is a story here'."""
        if status == "SUCCEEDED":
            return
        try:
            bundle = self._assemble_diagnostics(status)
            if bundle is None:
                return
            from tony_tpu_torch.events.history import write_diagnostics_file
            write_diagnostics_file(self.history_dir, bundle)
            first = bundle.get("first_failure") or {}
            self.event_handler.emit(Event(
                EventType.DIAGNOSTICS_READY,
                DiagnosticsReady(
                    self.app_id,
                    first_failing_task=first.get("task_id", ""),
                    attempt=int(first.get("attempt", 0) or 0),
                    signature=first.get("signature", ""),
                    exit_code=int(first.get("exit_code") or 0),
                    signal_name=first.get("signal_name", ""),
                    num_failures=len(bundle.get("failures", [])),
                    path=C.DIAGNOSTICS_FILE)))
            LOG.info("diagnostics bundle written (%d failure records, "
                     "first: %s)", len(bundle.get("failures", [])),
                     first.get("task_id", "<none>"))
        except Exception:  # noqa: BLE001 — diagnostics must not fail _finish
            LOG.exception("failed to flush the diagnostics bundle")

    def _publish_history(self, final_hist: str) -> None:
        """Upload the finalized jhist + config snapshot to the staging
        store. The local history dir assumes the
        portal can read this host's filesystem — false on a multi-host
        TPU-VM fleet where the AM ran off-host. With a staging location
        configured, the portal's HistoryStoreFetcher pulls
        `<location>/<app_id>/history/*` into its own intermediate dir
        (the reference's equivalent was jhist on HDFS,
        events/EventHandler.java:97-113)."""
        location = self.conf.get_str(K.STAGING_LOCATION, "")
        if not location or not final_hist or not os.path.exists(final_hist):
            return
        try:
            from tony_tpu_torch.storage import staging_store
            store = staging_store(location, self.app_dir)
            store.put(final_hist,
                      f"history/{os.path.basename(final_hist)}")
            for extra in (C.PORTAL_CONFIG_FILE, C.SPANS_FILE,
                          C.METRICS_FILE, C.GOODPUT_FILE,
                          C.DIAGNOSTICS_FILE, C.SKEW_FILE,
                          C.JOBSTATE_FILE, C.ALERTS_FILE,
                          C.SERVING_TRACES_FILE, C.PROFILE_FOLDED_FILE):
                p = os.path.join(self.history_dir, extra)
                if os.path.exists(p):
                    store.put(p, f"history/{extra}")
            # profiler-capture artifacts travel with the history too
            profiles_root = os.path.join(self.history_dir,
                                         C.PROFILES_DIR_NAME)
            if os.path.isdir(profiles_root):
                for dirpath, _, files in os.walk(profiles_root):
                    for name in files:
                        p = os.path.join(dirpath, name)
                        rel = os.path.relpath(p, self.history_dir)
                        store.put(p, f"history/{rel}")
            # aggregated container logs ride along so an off-host portal
            # can serve /logs/:id/:task/:stream without reaching this host
            logs_root = os.path.join(self.history_dir,
                                     C.HISTORY_LOGS_DIR_NAME)
            if os.path.isdir(logs_root):
                for cdir in sorted(os.listdir(logs_root)):
                    for stream in ("stdout", "stderr"):
                        p = os.path.join(logs_root, cdir, stream)
                        if os.path.isfile(p):
                            store.put(
                                p, f"history/{C.HISTORY_LOGS_DIR_NAME}/"
                                   f"{cdir}/{stream}")
        except Exception:  # noqa: BLE001 — history must never fail the app
            LOG.exception("failed to publish history to the staging store")

    def _write_history_config(self) -> None:
        """Snapshot the frozen conf into the history dir so the portal can
        serve /config/:jobId (reference: writeConfigFile,
        ApplicationMaster.java:454-460)."""
        try:
            path = os.path.join(self.history_dir, C.PORTAL_CONFIG_FILE)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.conf.to_dict(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 — observability must not kill the job
            LOG.exception("failed to write history config snapshot")

    def run(self) -> bool:
        """Full AM lifecycle incl. the session retry loop
        (ApplicationMaster.run, ApplicationMaster.java:311-386).
        Returns overall success."""
        self.prepare()
        self._schedule_preempt_if_testing()
        self._schedule_am_chaos_if_testing()
        # TEST_AM_CRASH: die before doing anything useful, simulating an AM
        # container crash (reference: ApplicationMaster.java:337-342)
        if os.environ.get(C.TEST_AM_CRASH):
            LOG.error("TEST_AM_CRASH set — simulating AM crash")
            self._write_status("FAILED", "TEST_AM_CRASH")
            os._exit(1)
        max_retries = self.conf.get_int(K.AM_RETRY_COUNT, 0)
        succeeded = False
        attempt = 0
        try:
            while True:
                succeeded = self._run_session(attempt)
                if succeeded or attempt >= max_retries:
                    break
                if self._client_signal_stop.is_set():
                    break
                if self._preemption is not None:
                    # checkpoint-then-evict: the pool wants these chips —
                    # a session retry would re-occupy them. The job
                    # resumes from its checkpoint when re-admitted.
                    break
                if self._unsatisfiable_request:
                    # deterministic placement failure: a retry would hit
                    # the identical node pool — don't burn the retries
                    break
                attempt += 1
                backoff = session_retry_backoff_sec(
                    self.app_id, attempt,
                    self.conf.get_time_ms(K.AM_RETRY_BACKOFF_BASE_MS, 1000),
                    self.conf.get_time_ms(K.AM_RETRY_BACKOFF_MAX_MS, 30_000))
                LOG.warning("session failed; AM retry %d/%d after %.0f ms "
                            "backoff", attempt, max_retries, backoff * 1000)
                self._reset()
                if backoff > 0:
                    # interruptible: a client kill during backoff must not
                    # be held hostage by the wait
                    self._client_signal_stop.wait(backoff)
                    if self._client_signal_stop.is_set():
                        break
            self._finish(succeeded)
        finally:
            self._teardown()
        return succeeded

    def _run_session(self, attempt: int) -> bool:
        """One session generation: build, preprocess, schedule, monitor."""
        self._task_missed_hb = False
        self._untracked_task_failed = False
        self._unsatisfiable_request: str | None = None
        self._killed_by_client = False
        self._preprocess_exit_code = 0
        self._preprocess_finished = False
        self._model_params: str | None = None
        # AM crash recovery: a supervised restart replays the journal
        # BEFORE the session is built — the journaled session id must
        # seed the new TonySession or every adopted executor would be
        # fenced out as a stale-session registration
        recovered: Optional[J.RecoveredState] = None
        if self._recovering and attempt == 0:
            recovered = J.replay(self.app_dir)
            if recovered.replayed_records == 0 and not recovered.tasks:
                LOG.warning("AM attempt %d found an empty journal — "
                            "starting a fresh session", self._am_attempt)
                recovered = None
            else:
                self._session_id = max(self._session_id,
                                       recovered.session_id)
        self.session = TonySession(self.conf, session_id=self._session_id)
        # wipe liveliness entries a stale executor's in-flight
        # registration may have planted between _reset()'s clear and this
        # point — from here on register_worker_spec validates ids against
        # THIS session
        self.hb_monitor.clear()
        with self._lock:
            self._session_containers.setdefault(self._session_id, [])
        self.scheduler = TaskScheduler(self.session,
                                       _Requestor(self.backend, self))

        if self._unported:
            LOG.error("refusing the job: %s", self._unported)
            self.session.set_final_status(FinalStatus.FAILED, self._unported)
            self._unsatisfiable_request = "unported-feature"
            return False

        # queue quota, re-validated AM-side (conf files can reach the AM
        # without passing through TonyClient.validate_conf) — a pure-conf
        # check, so it runs BEFORE preprocess burns minutes of user code
        from tony_tpu_torch.conf.queues import validate_queue_quota
        try:
            validate_queue_quota(self.conf)
        except ValueError as e:
            LOG.error("queue quota violation: %s", e)
            self.session.set_final_status(FinalStatus.FAILED, str(e))
            self._unsatisfiable_request = "queue-quota"
            return False

        if attempt == 0 and self._am_attempt == 0:
            self.event_handler.emit(Event(
                EventType.APPLICATION_INITED,
                ApplicationInited(self.app_id,
                                  sum(r.num_instances
                                      for r in self.session.requests.values()),
                                  self.host)))
            if self._resumed_from:
                # checkpoint-then-evict resume: this application
                # continues a PREEMPTED predecessor from its checkpoint
                # — possibly at a different gang width (the resharding
                # restore maps saved shards onto the new mesh); the
                # downtime gap is priced into the goodput ledger
                from tony_tpu_torch.conf.queues import total_requested_tpus
                LOG.info("resumed from preempted %s after %.1f s "
                         "downtime", self._resumed_from,
                         self._preemption_downtime_s)
                self.event_handler.emit(Event(
                    EventType.RESUMED,
                    Resumed(self.app_id,
                            resumed_from=self._resumed_from,
                            downtime_ms=int(
                                self._preemption_downtime_s * 1000),
                            gang_width=self.session.total_tracked_tasks(),
                            requested_chips=total_requested_tpus(
                                self.conf))))

        if recovered is None and (self._single_node or self.conf.get_bool(
                K.APPLICATION_ENABLE_PREPROCESS, False)):
            self._do_preprocessing_job(attempt)
            if self._single_node:
                ok = self._preprocess_exit_code == 0
                if ok:
                    self.session.set_final_status(FinalStatus.SUCCEEDED, None)
                else:
                    self.session.set_final_status(
                        FinalStatus.FAILED,
                        f"preprocess exit {self._preprocess_exit_code}")
                return ok
            if self._preprocess_exit_code != 0:
                # short-circuit BEFORE requesting containers (reference:
                # doPreprocessingJob exit-code check feeds run()'s early
                # return, ApplicationMaster.java:746-751)
                self.session.set_final_status(
                    FinalStatus.FAILED,
                    f"Preprocess failed with exit code: "
                    f"{self._preprocess_exit_code}")
                return False

        # joint gang feasibility BEFORE scheduling: tracked jobtypes with
        # no ordering between them all rendezvous at the barrier, so
        # their summed demand must fit the pool at once — per-request
        # gates can't see this. Any depends_on among tracked
        # jobs means they need NOT all co-reside; skip the joint check
        # then (the per-request gate still applies).
        tracked = [r for r in self.session.requests.values()
                   if not r.untracked]
        if tracked and not any(r.depends_on for r in tracked):
            from tony_tpu_torch.cluster.backend import UnsatisfiableRequestError
            try:
                self.backend.validate_coresident(
                    [(r.num_instances, r.memory_mb, r.gpus, r.tpus,
                      r.node_label) for r in tracked])
            except UnsatisfiableRequestError as e:
                self._fail_unsatisfiable(
                    "+".join(r.job_name for r in tracked), str(e))
                return False

        if recovered is not None and self._adopt_recovered(recovered):
            # live-gang adoption: the executors are still running (the
            # backend launched them in their own sessions) — nothing is
            # scheduled; RUNNING is gated on the adoption barrier and
            # lost members are relaunched through the normal budget path
            pass
        else:
            self.scheduler.schedule_tasks()
            # journal the session start AFTER scheduling (the scheduler
            # owns num_expected_tasks) — the first record a recovering
            # attempt replays
            self.journal.append(
                J.REC_SESSION, session_id=self._session_id,
                expected=self.session.num_expected_tasks,
                instances={name: req.num_instances
                           for name, req in self.session.requests.items()})
        self._rendezvous_span_start(f"session-{self._session_id}")
        if not self.scheduler.dependency_check_passed:
            return False
        if self._unsatisfiable_request:
            # placement infeasibility surfaced synchronously from
            # request_containers — final status already set
            return False
        # registration timeout clock starts at scheduling time (reference:
        # tony.container.allocation.timeout, ApplicationMaster.java:790-791)
        # and is re-armed whenever a task relaunch re-opens the barrier
        self._registration_deadline = (
            time.monotonic() + self._alloc_timeout_ms / 1000.0
            if self._alloc_timeout_ms > 0 else None)
        return self._monitor()

    # ------------------------------------------------------------------
    # AM crash recovery: journal replay + live-gang adoption
    # ------------------------------------------------------------------
    def _adopt_recovered(self, state: "J.RecoveredState") -> bool:
        """Apply a replayed journal to the fresh session and arm the
        adoption barrier. Returns True when at least one journaled task
        was still live at crash time (a gang worth adopting); False
        falls back to scheduling a fresh gang."""
        session = self.session
        live = state.live_tasks()
        if not live:
            LOG.warning("journal replay found no live tasks — scheduling "
                        "a fresh gang")
            return False
        session.restore_for_recovery(state.num_expected,
                                     state.spec_generation,
                                     state.instances)
        adopted_live: list[tuple[str, int]] = []
        for task_id, rec in sorted(state.tasks.items()):
            task = session.adopt_task(
                task_id, rec.get("host_port", ""),
                int(rec.get("attempt", 0)),
                container_id=rec.get("container_id", ""),
                host=rec.get("host", ""),
                lifecycle_relaunches=int(rec.get("lifecycle_relaunches",
                                                 0)),
                completed=bool(rec.get("completed")),
                exit_code=int(rec.get("exit_code", 0)))
            if task is not None and task_id in live:
                adopted_live.append((task_id, task.attempt))
        if not adopted_live:
            return False
        # control-plane downtime so far: last journal stamp → now (the
        # gap no AM existed); the adoption-barrier window is added when
        # the barrier completes (_check_recovery)
        pre_downtime_s = 0.0
        if state.last_ts_ms > 0:
            pre_downtime_s = max(
                0.0, time.time() * 1000 - state.last_ts_ms) / 1000.0
        with self._lock:
            self._am_downtime_s += pre_downtime_s
            self._am_downtime_s += float(
                state.clocks.get("am_downtime_s", 0.0))
            self._relaunch_downtime_s = max(
                self._relaunch_downtime_s,
                float(state.clocks.get("relaunch_downtime_s", 0.0)))
            self._preemption_downtime_s = max(
                self._preemption_downtime_s,
                float(state.clocks.get("preemption_downtime_s", 0.0)))
            for task_id, rec in state.endpoints.items():
                self._serving_endpoints[task_id] = dict(rec)
            if state.preemption:
                # the predecessor crashed mid-drain: resume the
                # checkpoint-then-evict with a FRESH grace window (the
                # old monotonic deadline died with the old process)
                grace_ms = int(state.preemption.get("grace_ms", 0)
                               or 30_000)
                self._preemption = {
                    "reason": state.preemption.get("reason", ""),
                    "grace_ms": grace_ms,
                    "requested_by": state.preemption.get(
                        "requested_by", ""),
                    "requested": time.monotonic(),
                    "requested_ms": int(state.preemption.get(
                        "requested_ms", 0)) or int(time.time() * 1000),
                    "deadline": time.monotonic() + grace_ms / 1000.0,
                }
            self._recovery = {
                "pending": {tid for tid, _ in adopted_live},
                "adopted": set(),
                "deadline": (time.monotonic()
                             + self._recovery_settle_ms / 1000.0),
                "started": time.monotonic(),
                "replayed": state.replayed_records,
                "pre_downtime_ms": int(pre_downtime_s * 1000),
            }
        if state.resize:
            LOG.warning("in-flight elastic resize did not survive the AM "
                        "crash; the gang stays at its current width")
        # liveliness restarts with a fresh clock per adopted member: an
        # orphaned executor heartbeats into the void until it polls the
        # new amhostport, so its clock starts at re-bind, not at crash
        for task_id, task_attempt in adopted_live:
            self.hb_monitor.register(task_id, task_attempt)
        self.journal.seed(state)
        LOG.warning("AM attempt %d recovering: %d journal record(s) "
                    "replayed, %d live task(s) to adopt, %.1f s downtime "
                    "before this attempt", self._am_attempt,
                    state.replayed_records, len(adopted_live),
                    pre_downtime_s)
        self.event_handler.emit(Event(
            EventType.AM_RECOVERY_STARTED,
            AmRecoveryStarted(self.app_id, self._am_attempt,
                              live_tasks=len(adopted_live),
                              replayed_records=state.replayed_records,
                              journal_path=self.journal.path)))
        return True

    def _note_recovery_adoption(self, task_id: str, attempt: int) -> None:
        """An adopted executor showed up (re-registration or heartbeat)
        at the journaled attempt: drain it from the adoption barrier."""
        with self._lock:
            rec = self._recovery
            if rec is None or task_id not in rec["pending"]:
                return
            session = self.session
            task = (session.get_task_by_id(task_id)
                    if session is not None else None)
            if task is not None and attempt >= 0 \
                    and attempt != task.attempt:
                return      # superseded attempt cannot satisfy the barrier
            rec["pending"].discard(task_id)
            rec["adopted"].add(task_id)
            remaining = len(rec["pending"])
        LOG.info("recovery: adopted %s (attempt %d), %d member(s) "
                 "pending", task_id, max(attempt, 0), remaining)
        self._wake.set()

    def _check_recovery(self) -> None:
        """One adoption-barrier pass (monitor-loop cadence): complete the
        recovery when every adopted member re-attached, or at the settle
        deadline — stragglers that never re-attached are relaunched
        through the normal budget machinery."""
        with self._lock:
            rec = self._recovery
            if rec is None:
                return
            pending = set(rec["pending"])
            deadline = rec["deadline"]
        if pending and time.monotonic() <= deadline:
            return
        session = self.session
        stragglers: list[Task] = []
        if pending and session is not None:
            for task_id in sorted(pending):
                task = session.get_task_by_id(task_id)
                if task is not None and not task.completed:
                    stragglers.append(task)
        with self._lock:
            rec, self._recovery = self._recovery, None
            if rec is None:
                return
            adopted = len(rec["adopted"])
            lost = len(rec["pending"])
            elapsed_s = time.monotonic() - rec["started"]
            self._am_downtime_s += elapsed_s
            downtime_ms = rec["pre_downtime_ms"] + int(elapsed_s * 1000)
            replayed = rec["replayed"]
        for task in stragglers:
            # autopsy first: a straggler that is wedged (vs gone with the
            # host) still answers read_stacks at its gossiped address
            self._capture_task_stacks(task.task_id, task.attempt,
                                      "executor lost across AM restart")
            if self._maybe_relaunch_task(
                    task, "executor lost across AM restart",
                    observed_attempt=task.attempt):
                self._clear_remote_stall(task.task_id, "relaunched")
        (LOG.info if lost == 0 else LOG.warning)(
            "AM recovery complete: %d executor(s) adopted, %d lost, "
            "%d ms control-plane downtime", adopted, lost, downtime_ms)
        self.event_handler.emit(Event(
            EventType.AM_RECOVERY_COMPLETED,
            AmRecoveryCompleted(self.app_id, self._am_attempt,
                                adopted=adopted, lost=lost,
                                replayed_records=replayed,
                                duration_ms=int(elapsed_s * 1000),
                                downtime_ms=downtime_ms)))
        # the barrier is down: the registry entry folds RECOVERING back
        # into RUNNING immediately (flap guard — no throttle window)
        self._publish_fleet_state(force=True)

    def _journal_clocks(self) -> None:
        """Journal the goodput downtime clocks when they moved (monitor
        cadence) — the phase ledger a recovering attempt restores."""
        with self._lock:
            clocks = {
                "relaunch_downtime_s": round(self._relaunch_downtime_s, 3),
                "preemption_downtime_s": round(
                    self._preemption_downtime_s, 3),
                "resize_downtime_s": round(self.elastic.downtime_s(), 3),
                "am_downtime_s": round(self._am_downtime_s, 3),
            }
        if clocks != self._last_clock_rec:
            self._last_clock_rec = clocks
            self.journal.append(J.REC_CLOCK, **clocks)

    def _monitor(self) -> bool:
        """The monitor loop (ApplicationMaster.monitor,
        ApplicationMaster.java:580-658): same break conditions, same
        end-of-loop final-status aggregation."""
        timeout_ms = self.conf.get_time_ms(K.APPLICATION_TIMEOUT, 0)
        expire_at = (time.monotonic() + timeout_ms / 1000.0
                     if timeout_ms > 0 else None)
        session = self.session
        # stall-watchdog beacon: the monitor loop IS the AM's pulse — a
        # pass wedged inside one of the _check_* calls below freezes
        # relaunch, preemption, and alerting all at once
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon("am-monitor", self._monitor_interval)
        while True:
            beacon.beat()
            if expire_at is not None and time.monotonic() > expire_at:
                LOG.error("application timed out")
                session.set_final_status(FinalStatus.FAILED,
                                         "Application times out.")
                break
            if self._client_signal_stop.is_set():
                LOG.info("client signaled AM to exit")
                if not session.all_tracked_tasks_completed():
                    self._killed_by_client = True
                break
            if session.training_finished:
                LOG.info("training finished (short-circuit)")
                break
            if self._preprocess_exit_code != 0:
                session.set_final_status(
                    FinalStatus.FAILED,
                    f"Preprocess failed with exit code: {self._preprocess_exit_code}")
                break
            if self._preemption is not None and self._check_preemption():
                break
            if self._task_missed_hb:
                break
            if self._untracked_task_failed:
                session.set_final_status(
                    FinalStatus.FAILED,
                    "An untracked task failed with a non-zero exit code.")
                break
            if self._unsatisfiable_request:
                # a dependency-released jobtype asked for placement no
                # node can provide (scheduling-time asks are caught
                # before the monitor starts)
                break
            if (self._registration_deadline is not None
                    and not session.all_tasks_registered()
                    and time.monotonic() > self._registration_deadline):
                # barrier-timeout autopsy BEFORE the session is failed:
                # the suspects are still alive to answer read_stacks
                self._capture_barrier_stacks()
                session.set_final_status(
                    FinalStatus.FAILED,
                    "Tasks failed to register within the allocation timeout.")
                break
            with self._lock:
                # clear-and-check atomically against the relaunch path,
                # which re-arms the deadline under the same lock while
                # popping the dead task's registration — an unlocked clear
                # here could wipe that re-arm and let a replacement that
                # never registers hang the session forever
                if session.all_tasks_registered():
                    # all gang members arrived: stop the registration clock
                    self._registration_deadline = None
                    # the barrier-wait span covers scheduling → full gang
                    self._rendezvous_span_end()
                    # any in-flight relaunch gap closes here: the gang is
                    # whole again, downtime stops accruing
                    self._close_relaunch_downtime()
            self._check_recovery()
            self._check_slo()
            self._check_stragglers()
            self._check_rolling_update()
            self.elastic.check()
            self._journal_clocks()
            # RUNNING is gated on the adoption barrier: while a recovery
            # is in flight the registry shows RECOVERING
            with self._lock:
                in_recovery = self._recovery is not None
            self._publish_fleet_state(
                "RECOVERING" if in_recovery else "RUNNING")
            total = session.total_tracked_tasks()
            if total > 0 and session.num_completed_tracked_tasks() >= total:
                if self._preemption is not None:
                    # the last drain completion can land between this
                    # iteration's _check_preemption and here — settle
                    # the PREEMPTED terminal state (+ event) before
                    # breaking, or the generic aggregation below would
                    # read the drained gang as SUCCEEDED
                    self._check_preemption()
                    break
                LOG.info("all %d tracked tasks completed", total)
                break
            self._wake.wait(self._monitor_interval)
            self._wake.clear()
        # a finished monitor is idle, not stalled — park the beacon so
        # the finish/teardown tail can't trip the watchdog
        beacon.idle()
        if self._killed_by_client:
            session.set_final_status(FinalStatus.KILLED,
                                     "Application killed by client.")
        else:
            session.update_session_status()
        ok = session.final_status == FinalStatus.SUCCEEDED
        if not ok:
            LOG.info("session failed: %s", session.final_message)
        return ok

    def _check_preemption(self) -> bool:
        """One monitor-loop pass of the checkpoint-then-evict drain.
        Returns True when the drain is complete (the monitor breaks and
        the application finishes PREEMPTED). Phases: (1) wait for every
        tracked task to stop — executors TERM their user processes on
        the heartbeat-piggybacked drain ask and trainers
        emergency-checkpoint inside the grace window; (2) at the
        deadline, force-stop the stragglers' containers (the backend's
        TERM→KILL ladder still gives their trainers the term-grace
        window); (3) a bounded tail wait for completion callbacks, so a
        lost callback can't wedge the drain forever."""
        session = self.session
        preemption = self._preemption
        if session is None or preemption is None:
            return False
        now = time.monotonic()
        if session.all_tracked_tasks_completed():
            self._finish_preemption("drained")
            return True
        if now > preemption["deadline"] and not self._preempt_forced:
            self._preempt_forced = True
            with self._lock:
                cids = [cid for cid, (task, sid) in self._launched.items()
                        if sid == session.session_id and not task.completed
                        and cid not in self._finished_containers]
            LOG.warning("preemption grace expired — force-stopping %d "
                        "container(s)", len(cids))
            for cid in cids:
                self.backend.stop_container(cid)
        # bounded tail: the force-stop's TERM→KILL ladder + callback
        # delivery; past it, settle PREEMPTED with whatever completed
        # (remaining slots are recorded killed-by-AM by the backend)
        ladder_s = self.conf.get_time_ms(K.TASK_TERM_GRACE_MS,
                                         15_000) / 1000.0 + 10.0
        if now > preemption["deadline"] + ladder_s:
            LOG.error("preemption drain wedged past the stop ladder — "
                      "finishing PREEMPTED with %d/%d tasks completed",
                      session.num_completed_tracked_tasks(),
                      session.total_tracked_tasks())
            self._finish_preemption("drain timed out")
            return True
        return False

    def _finish_preemption(self, how: str) -> None:
        """Settle the PREEMPTED terminal state + emit the PREEMPTED
        event (once) with the drain evidence."""
        session = self.session
        preemption = self._preemption
        reason = preemption.get("reason", "") or "preempted"
        session.set_final_status(
            FinalStatus.PREEMPTED,
            f"Preempted ({how}): {reason}")
        if self._preempt_event_emitted:
            return
        self._preempt_event_emitted = True
        from tony_tpu_torch.rpc.messages import TaskStatus
        drained = killed = 0
        for tasks in session.job_tasks.values():
            for t in tasks:
                if not session.is_tracked(t.job_name):
                    continue
                if t.status == TaskStatus.PREEMPTED:
                    drained += 1
                elif t.status == TaskStatus.FINISHED \
                        or (not t.completed and t.container_id):
                    killed += 1
        drain_ms = int((time.monotonic() - preemption["requested"]) * 1000)
        self.event_handler.emit(Event(
            EventType.PREEMPTED,
            Preempted(self.app_id, reason=reason,
                      drained_tasks=drained, killed_tasks=killed,
                      drain_ms=drain_ms)))
        LOG.warning("application preempted: %d task(s) drained "
                    "gracefully, %d force-stopped (%d ms)", drained,
                    killed, drain_ms)

    # holds: _lock (see docstring — callers own the AM lock)
    def _close_relaunch_downtime(self) -> None:
        """Fold every open relaunch gap into the accumulated downtime
        (caller holds the AM lock, or the app is single-threadedly
        finishing). Idempotent: the pending map empties."""
        now = time.monotonic()
        for t0 in self._relaunch_pending_since.values():
            self._relaunch_downtime_s += now - t0
        self._relaunch_pending_since.clear()

    def _check_slo(self) -> None:
        """One SLO-watchdog pass (monitor-loop cadence): newly entered
        violations become WARNING history events; the current latch set
        is exposed as alert gauges on /metrics."""
        if (self.slo.step_regression_pct <= 0
                and self.slo.goodput_floor_pct <= 0):
            return      # both checks off (the default): no per-tick work
        try:
            goodput_pct = None
            if self.slo.goodput_floor_pct > 0 and self._goodput_enabled:
                gd = self.goodput_dict()
                # no ledgers yet (containers still launching/compiling)
                # reads as 0% — that is absence of data, not a violation
                if gd["tasks"]:
                    goodput_pct = gd["job"]["goodput_pct"]
            step_series = (
                self.metrics_store.metric_histories("TRAIN_STEP_TIME_MS")
                if self.slo.step_regression_pct > 0 else {})
            violations = self.slo.check(
                step_series, goodput_pct=goodput_pct,
                attempts=self.metrics_store.attempts())
            for v in violations:
                LOG.warning("SLO violation (%s): %s", v["kind"],
                            v["message"])
                self.event_handler.emit(Event(
                    EventType.SLO_VIOLATION,
                    SloViolation(kind=v["kind"], message=v["message"],
                                 task_id=v.get("task_id", ""),
                                 value=float(v.get("value", 0.0)),
                                 threshold=float(v.get("threshold", 0.0)))))
            if (self.slo.step_regression_pct > 0
                    or self.slo.goodput_floor_pct > 0):
                from tony_tpu_torch.observability.metrics import REGISTRY
                REGISTRY.gauge("tony_slo_violations_active",
                               app_id=self.app_id).set(
                    len(self.slo.active()))
        except Exception:  # noqa: BLE001 — the watchdog must never kill the AM
            LOG.exception("SLO check failed")

    def get_alerts(self, req: dict) -> dict:
        """Operator plane: the live alert bundle. The port runs no alert
        engine, so it answers as the JAX AM does when alerting is off."""
        return {"error": "alerting disabled (tony.alerts.enabled)"}

    # ------------------------------------------------------------------
    # serving-fleet lifecycle: rolling weight updates
    # ------------------------------------------------------------------
    def _serving_replicas(self) -> list[Task]:
        """Live (launched-or-launching, not completed) serving tasks."""
        session = self.session
        if session is None:
            return []
        return [t for t in session.job_tasks.get(C.SERVING_JOB_NAME, [])
                if not t.completed]

    def request_rolling_update(self, req: dict) -> dict:
        """Operator ask: zero-downtime rolling weight update over the
        serving replicas. Bumps the AM's weights epoch and arms the
        one-replica-at-a-time state machine _check_rolling_update
        advances on the monitor cadence. Idempotent while in flight."""
        session = self.session
        if session is None:
            return {"error": "no active session"}
        replicas = [t for t in self._serving_replicas()
                    if t.container_id]
        if not replicas:
            return {"error": "no running serving replicas to update"}
        requested_by = str(req.get("requested_by", "") or "operator")
        with self._lock:
            if self._rolling is not None:
                r = self._rolling
                return {"app_id": self.app_id, "duplicate": True,
                        "generation": r["generation"],
                        "replicas": len(r["pending"])
                        + (1 if r["current"] else 0)}
            generation = int(req.get("generation", 0) or 0) \
                or self._weights_generation + 1
            self._weights_generation = generation
            self._rolling = {
                "generation": generation,
                "pending": sorted((t.task_id for t in replicas),
                                  key=lambda tid: int(
                                      tid.rpartition(":")[2])),
                "current": None,
                "updated": 0,
                "started": time.monotonic(),
                "since": time.monotonic(),
            }
        LOG.info("rolling update to weights generation %d over %d "
                 "serving replica(s)", generation, len(replicas))
        self.event_handler.emit(Event(
            EventType.ROLLING_UPDATE_STARTED,
            RollingUpdateStarted(self.app_id, generation, len(replicas),
                                 requested_by=requested_by)))
        self._wake.set()
        return {"app_id": self.app_id, "generation": generation,
                "replicas": len(replicas)}

    def _check_rolling_update(self) -> None:
        """One rollout pass (monitor-loop cadence): advance the
        one-replica-at-a-time state machine — mark the next replica's
        endpoint draining, relaunch it through the (budget-exempt)
        relaunch machinery, and only move on once its replacement
        re-registered a healthy endpoint at the new generation. A
        replica that never comes back inside the allocation window
        abandons the rollout loudly instead of wedging it."""
        with self._lock:
            ru = self._rolling
        session = self.session
        if ru is None or session is None or self._preemption is not None:
            return
        try:
            now = time.monotonic()
            if ru["current"] is not None:
                with self._lock:
                    rec = self._serving_endpoints.get(ru["current"])
                healthy = (rec is not None and not rec.get("draining")
                           and rec.get("generation", 0)
                           >= ru["generation"])
                if healthy:
                    ru["updated"] += 1
                    ru["current"] = None
                    ru["since"] = now
                elif (self._alloc_timeout_ms > 0
                        and now - ru["since"]
                        > self._alloc_timeout_ms / 1000.0):
                    self._finish_rolling_update(
                        ok=False,
                        message=f"replica {ru['current']} never came "
                                f"back healthy")
                    return
                else:
                    return      # still waiting on the replacement
            if not ru["pending"]:
                self._finish_rolling_update(ok=True)
                return
            task_id = ru["pending"].pop(0)
            task = session.get_task_by_id(task_id)
            if task is None or task.completed or not task.container_id:
                return          # scaled away mid-rollout; next pass
            with self._lock:
                self._mark_endpoint_draining(task_id)
            if self._maybe_relaunch_task(
                    task,
                    f"rolling update to weights generation "
                    f"{ru['generation']}",
                    count_failure=False, force=True):
                ru["current"] = task_id
                ru["since"] = now
            else:
                self._finish_rolling_update(
                    ok=False,
                    message=f"could not relaunch {task_id}")
        except Exception:  # noqa: BLE001 — rollout must never kill the AM
            LOG.exception("rolling-update check failed")

    def _finish_rolling_update(self, ok: bool, message: str = "") -> None:
        with self._lock:
            ru, self._rolling = self._rolling, None
        if ru is None:
            return
        duration_ms = int((time.monotonic() - ru["started"]) * 1000)
        (LOG.info if ok else LOG.error)(
            "rolling update to generation %d %s: %d replica(s) updated "
            "in %d ms %s", ru["generation"],
            "completed" if ok else "FAILED", ru["updated"], duration_ms,
            message)
        self.event_handler.emit(Event(
            EventType.ROLLING_UPDATE_COMPLETED,
            RollingUpdateCompleted(self.app_id, ru["generation"],
                                   replicas_updated=ru["updated"],
                                   ok=ok, duration_ms=duration_ms,
                                   message=message)))

    def _build_skew_state(self) -> None:
        """(Re)construct the skew tracker + straggler analyzer from the
        frozen conf and rewire the metrics-store sink onto the fresh
        tracker. Called at construction AND from _reset(): a new session
        is a new gang — the dead session's latched stragglers, one-shot
        startup flags, and declined-remediation slots must not judge it.
        (The heartbeat lag sink needs no rewiring: its lambda reads
        self.skew_tracker at call time.)"""
        from tony_tpu_torch.observability.skew import SkewTracker, StragglerAnalyzer
        conf = self.conf
        self.skew_tracker = SkewTracker(
            buckets=conf.get_int(K.STRAGGLER_SKETCH_BUCKETS, 96),
            heatmap_windows=conf.get_int(K.STRAGGLER_HEATMAP_WINDOWS, 32))
        self.straggler = StragglerAnalyzer(
            threshold_pct=conf.get_int(K.STRAGGLER_THRESHOLD_PCT, 50),
            windows=conf.get_int(K.STRAGGLER_WINDOWS, 3),
            min_tasks=conf.get_int(K.STRAGGLER_MIN_TASKS, 3),
            relaunch_after_windows=conf.get_int(
                K.STRAGGLER_RELAUNCH_AFTER_WINDOWS, 0))
        # slots whose straggler remediation was declined (budget/peers):
        # never re-asked — the latch stays, the relaunch machinery is
        # left alone
        self._straggler_no_remediate: set[str] = set()
        if self._straggler_enabled:
            self.metrics_store.skew_sink = self.skew_tracker.observe_metric

    def _task_span_ids(self, task_id: str, limit: int = 8) -> list[str]:
        """Span ids of one task's lifecycle spans — the STRAGGLER event's
        link into the waterfall (same trace_id = app_id)."""
        return [str(s.get("span_id"))
                for s in self.span_store.to_list()
                if s.get("task_id") == task_id and s.get("span_id")
                ][:limit]

    def _check_stragglers(self) -> None:
        """One skew-analyzer pass (monitor-loop cadence): close the open
        window when it has aged past tony.straggler.window-ms, latch /
        clear stragglers against the gang distribution, refresh the skew
        gauges, and — with the remediation knob set — route a persistent
        steady-state straggler through the task-attempt relaunch path."""
        if not self._straggler_enabled:
            return
        try:
            closed = self.skew_tracker.maybe_roll(self._straggler_window_ms)
            if closed is None:
                return
            actions, remediate = self.straggler.analyze(
                closed, self.skew_tracker.startup_values())
            # pin each remediation candidate to the attempt whose lag the
            # evidence describes NOW — a crash observer relaunching the
            # slot between this snapshot and the relaunch call below must
            # be fenced out, not handed a healthy replacement to kill
            session = self.session
            nominated = []
            for r in remediate:
                task = (session.get_task_by_id(r["task_id"])
                        if session is not None else None)
                if task is not None and not task.completed:
                    nominated.append((r, task, task.attempt))
            for a in actions:
                task_id = a["task_id"]
                name, _, idx = task_id.rpartition(":")
                try:
                    index = int(idx)
                except ValueError:
                    name, index = task_id, 0
                if a["action"] == "detected":
                    session = self.session
                    task = (session.get_task_by_id(task_id)
                            if session is not None else None)
                    LOG.warning(
                        "straggler detected: %s (%s via %s) %.1f ms vs "
                        "gang median %.1f ms (z=%.1f, %d window(s))",
                        task_id, a["phase"], a["signal"], a["value_ms"],
                        a["gang_median_ms"], a["z_score"], a["windows"])
                    self.event_handler.emit(Event(
                        EventType.STRAGGLER_DETECTED,
                        StragglerDetected(
                            name, index,
                            attempt=task.attempt if task is not None else 0,
                            signal=a["signal"], phase=a["phase"],
                            value_ms=a["value_ms"],
                            gang_median_ms=a["gang_median_ms"],
                            z_score=a["z_score"], windows=a["windows"],
                            span_ids=self._task_span_ids(task_id))))
                else:
                    LOG.info("straggler cleared: %s (%s)", task_id,
                             a.get("reason", "recovered"))
                    self.event_handler.emit(Event(
                        EventType.STRAGGLER_CLEARED,
                        StragglerCleared(name, index,
                                         reason=a.get("reason",
                                                      "recovered"),
                                         windows_lagging=a["windows"])))
            # alert gauges: latched count + the gang's step-time spread
            # from the window that just closed (AM /metrics exposition)
            from tony_tpu_torch.observability.metrics import REGISTRY
            REGISTRY.gauge("tony_job_straggler_count",
                           app_id=self.app_id).set(
                len(self.straggler.active()))
            gang = (closed.get("step_time_ms") or {}).get("gang") or {}
            from tony_tpu_torch.observability.fleet import STEP_TIME_GAUGES
            for q, gauge_name in STEP_TIME_GAUGES.items():
                if q in gang:
                    # mirrored into the jobstate gauges so the fleet
                    # /metrics re-exposition matches the AM /metrics
                    self._step_time_quantiles[q] = float(gang[q])
                    REGISTRY.gauge(gauge_name,
                                   app_id=self.app_id).set(gang[q])
            for r, task, attempt in nominated:
                self._remediate_straggler(r, task, attempt)
        except Exception:  # noqa: BLE001 — skew must never kill the AM
            LOG.exception("straggler check failed")

    def _remediate_straggler(self, evidence: dict, task: Task,
                             observed_attempt: int) -> None:
        """The opt-in recovery hook: a steady-state straggler that kept
        lagging past tony.straggler.relaunch-after-windows is relaunched
        through the SAME machinery a crash uses — attempt-fenced
        (`observed_attempt` is the attempt the lag evidence belongs to,
        pinned at nomination time), counted against the attempt budget,
        its gap attributed to the goodput ledger's relaunch_downtime. A
        declined relaunch (budget exhausted, peers completed) leaves the
        latch in place: detection stays on the record even when recovery
        is off the table."""
        task_id = evidence["task_id"]
        # decline-once: a slot whose relaunch was refused (attempt budget
        # exhausted, completed peers) is refused forever — re-asking every
        # window would spam the log and, worse, re-enter the relaunch
        # decision each time for a task that never actually failed
        if task_id in self._straggler_no_remediate:
            return
        reason = (f"persistent steady-state straggler "
                  f"({evidence['signal']} {evidence['value_ms']} ms vs "
                  f"gang median {evidence['gang_median_ms']} ms for "
                  f"{evidence['windows']} windows)")
        if not self._maybe_relaunch_task(task, reason,
                                         observed_attempt=observed_attempt,
                                         count_failure=False):
            self._straggler_no_remediate.add(task_id)
            LOG.warning("straggler %s not relaunched (budget/peers) — "
                        "detection stays latched, remediation disabled "
                        "for this slot: %s", task_id, reason)
        # on success the relaunch path itself released the latch and
        # emitted STRAGGLER_CLEARED(relaunched) — nothing left to do

    def get_skew(self, req: dict) -> dict:
        """Operator plane: the live cross-task skew bundle (portal
        /api/jobs/:id/skew proxy + CLI). Same shape as the skew.json
        flushed into history at finish."""
        if not self._straggler_enabled:
            return {"error": "straggler detection disabled "
                             "(tony.straggler.enabled)"}
        return self.skew_tracker.bundle(self.straggler)

    def _reset(self) -> None:
        """Stop this session's containers and bump the session id so stale
        completion callbacks are ignored (ApplicationMaster.reset,
        ApplicationMaster.java:558-574)."""
        with self._lock:
            cids = list(self._session_containers.get(self._session_id, []))
        for cid in cids:
            self.backend.stop_container(cid)
        self.hb_monitor.clear()
        # the dead session's wedges die with its containers: close every
        # latched stall pair (the captured stacks stay — they are failure
        # evidence for the final diagnostics bundle)
        with self._lock:
            latched = list(self._remote_stalls)
        for task_id in latched:
            self._clear_remote_stall(task_id, "teardown")
        # an in-flight resize dies with the session: the retry rebuilds
        # the gang at the frozen conf's width
        self.elastic.reset()
        # fresh gang, fresh skew books: the dead session's latches,
        # startup flags, and declined-remediation slots must not carry
        # into the retry (the task-relaunch path clears per-slot; a
        # session reset clears everything)
        self._build_skew_state()
        self._session_id += 1

    def _drain_completion_callbacks(self, timeout_sec: float = 5.0) -> None:
        """Wait (bounded) for container-completion callbacks of tasks whose
        executors already registered their result, so their TASK_FINISHED
        events land in the history before it closes. Containers still running
        (short-circuited session) are not waited on."""
        deadline = time.monotonic() + timeout_sec
        while time.monotonic() < deadline:
            with self._lock:
                session = self.session
                if session is None:
                    return
                pending = [
                    cid for cid, (task, sid) in self._launched.items()
                    if sid == session.session_id and task.completed
                    and cid not in self._finished_containers]
            if not pending:
                return
            time.sleep(0.05)

    def _finish(self, succeeded: bool) -> None:
        self._drain_completion_callbacks()
        if succeeded:
            status = "SUCCEEDED"
        elif (self.session is not None
              and self.session.final_status == FinalStatus.KILLED):
            status = "KILLED"
        elif (self.session is not None
              and self.session.final_status == FinalStatus.PREEMPTED):
            # terminal-but-resumable: the fleet registry settles the
            # entry as PREEMPTED and the arbiter can re-admit it later
            status = "PREEMPTED"
        else:
            status = "FAILED"
        # close the lifecycle trace before flushing it next to the events
        with self._lock:
            self._close_relaunch_downtime()
        self._rendezvous_span_end("OK" if succeeded else "ERROR")
        if self._root_span is not None:
            self.tracer.end(self._root_span,
                            "OK" if succeeded else "ERROR",
                            attrs={"final_status": status})
            self._root_span = None
        self._flush_observability()
        # any still-latched wedge closes here: every detect must have its
        # clear inside the jhist, even when the wedge killed the job
        with self._lock:
            latched = list(self._remote_stalls)
        for task_id in latched:
            self._clear_remote_stall(task_id, "teardown")
        # root-cause bundle BEFORE the event log closes: the
        # DIAGNOSTICS_READY event must land inside the jhist
        self._flush_diagnostics(status)
        # fleet: the terminal jobstate replaces the live registry entry
        # (so the entry settles instead of going stale → LOST) and a
        # copy travels with the history for the ledger's final read
        try:
            from tony_tpu_torch.events.history import write_jobstate_file
            write_jobstate_file(self.history_dir,
                                self.fleet_summary(status))
            self._publish_fleet_state(status, force=True)
        except Exception:  # noqa: BLE001 — fleet must never fail _finish
            LOG.exception("failed to flush the terminal fleet jobstate")
        if self.session is not None:
            all_metrics = []
            for infos in (self.session.get_task_infos() or []):
                all_metrics.extend(
                    self.metrics_store.get_metrics(infos.name, infos.index))
            self.event_handler.emit(Event(
                EventType.APPLICATION_FINISHED,
                ApplicationFinished(self.app_id, status,
                                    self.session.num_failed_tasks(),
                                    all_metrics)))
        final_hist = self.event_handler.stop(status)
        LOG.info("history written to %s", final_hist)
        self._aggregate_container_logs()
        self._publish_history(final_hist)
        self._write_status(
            status,
            self.session.final_message if self.session else None)
        # the verdict is on disk: nothing is left to recover, so a later
        # supervisor attempt must not replay this application's journal
        self.journal.discard()
        # give the client a moment to observe the terminal state and send
        # finish_application (ApplicationMaster.stop poll,
        # ApplicationMaster.java:669-710)
        stop_wait = self.conf.get_time_ms(K.AM_STOP_POLL_TIMEOUT_MS, 30_000) / 1000.0
        self._client_signal_stop.wait(timeout=stop_wait)

    def _write_status(self, status: str, message: Optional[str]) -> None:
        path = os.path.join(self.app_dir, C.AM_STATUS_FILE)
        tmp = path + ".tmp"
        with self._lock:
            tb_url = self._tb_url
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"status": status, "message": message,
                       "app_id": self.app_id,
                       "tb_url": tb_url,
                       "completed": int(time.time() * 1000)}, f)
        os.replace(tmp, path)

    def _teardown(self) -> None:
        self.backend.stop()
        self.hb_monitor.stop()
        with self._lock:
            log_clients = list(self._log_clients.values())
            self._log_clients.clear()
        for _, _, client in log_clients:
            try:
                client.close()
            except Exception:  # noqa: BLE001
                LOG.debug("log client close failed at teardown",
                          exc_info=True)
        if self._metrics_http is not None:
            self._metrics_http.stop()
            self._metrics_http = None
        if self._rpc_server is not None:
            self._rpc_server.stop(grace=0.5)

    # ------------------------------------------------------------------
    # preprocessing / single-node (ApplicationMaster.doPreprocessingJob,
    # ApplicationMaster.java:713-765): run the user command ON the AM host.
    # ------------------------------------------------------------------
    def _do_preprocessing_job(self, attempt: int) -> None:
        # the AM's own command key first, so a prepare stage can run a
        # different script than the training gang (reference:
        # getExecuteCommandKey(AM_NAME) fallback chain,
        # ApplicationMaster.java:738-739)
        from tony_tpu_torch.conf.keys import command_key
        command = (self.conf.get_str(command_key("am"))
                   or self.conf.get_str(K.TASK_COMMAND)
                   or os.environ.get(C.TASK_COMMAND, ""))
        if not command:
            LOG.warning("single-node/preprocess mode with no task command")
            self._preprocess_finished = True
            return
        LOG.info("running preprocess/single-node command on AM: %s", command)
        log_dir = os.path.join(self.app_dir, C.CONTAINERS_DIR_NAME, "am")
        os.makedirs(log_dir, exist_ok=True)
        env = {
            C.JOB_NAME: C.NOTEBOOK_JOB_NAME if self._single_node else C.AM_NAME,
            C.TASK_INDEX: "0",
            C.IS_CHIEF: "true",
            C.ATTEMPT_NUMBER: str(attempt),
            C.APP_ID: self.app_id,
            C.TONY_APP_DIR: self.app_dir,
        }
        reservation = None
        if self._single_node:
            # notebook path: reserve the UI port on the AM host, hand it to
            # the command via TB_PORT, and surface the URL in TaskInfos so
            # the NotebookSubmitter can proxy to it (reference:
            # ApplicationMaster.java:717-726 + NotebookSubmitter.java:107-130)
            from tony_tpu_torch.utils.ports import reserve_port
            reservation = reserve_port()
            env[C.TB_PORT] = str(reservation.port)
            with self._lock:
                self._tb_url = f"http://{self.host}:{reservation.port}"
        stdout_path = os.path.join(log_dir, "stdout")
        scan_from = 0
        try:
            with open(stdout_path, "ab") as out, \
                    open(os.path.join(log_dir, "stderr"), "ab") as err:
                # append mode: on an AM retry this file already holds the
                # previous attempt's output — the scrape must only see
                # THIS attempt's lines or a stale 'Model parameters:'
                # value would win
                scan_from = out.tell()
                if reservation is not None:
                    reservation.release()  # user process binds it now
                self._preprocess_exit_code = execute_shell(
                    command, extra_env=env, cwd=self.app_dir,
                    stdout=out, stderr=err)
        finally:
            if reservation is not None:
                reservation.release()
        if self._preprocess_exit_code == 0:
            self._model_params = self._scrape_model_params(stdout_path,
                                                           scan_from)
        self._preprocess_finished = True

    @staticmethod
    def _scrape_model_params(stdout_path: str,
                             scan_from: int = 0) -> Optional[str]:
        """Scan the preprocess job's stdout (from `scan_from`, i.e. this
        attempt's output only) for a 'Model parameters: ' line; the
        remainder of the first such line is injected into every training
        container's env as $MODEL_PARAMS — how a prepare-stage job hands
        computed parameters to the gang (reference:
        ApplicationMaster.java:753-764, Constants.java:84)."""
        try:
            with open(stdout_path, "r", encoding="utf-8",
                      errors="replace") as f:
                f.seek(scan_from)
                for line in f:
                    if C.MODEL_PARAMS_MARKER in line:
                        params = line.split(C.MODEL_PARAMS_MARKER, 1)[1]
                        params = params.rstrip("\n")
                        LOG.info("preprocess published model parameters "
                                 "(%d chars)", len(params))
                        return params
        except OSError as e:
            LOG.warning("cannot scan preprocess stdout %s: %s",
                        stdout_path, e)
        return None

    # ------------------------------------------------------------------
    # backend callbacks
    # ------------------------------------------------------------------
    def _on_container_allocated(self, container: Container) -> None:
        """RMCallbackHandler.onContainersAllocated + ContainerLauncher
        (ApplicationMaster.java:1040-1050,1088-1155)."""
        with self._lock:
            session = self.session
            if session is None:
                self.backend.release_container(container.container_id)
                return
            task = session.match_allocation(
                container.priority, container.container_id, container.host)
            if task is None:
                LOG.info("no matching task for %s (priority %d) — releasing",
                         container.container_id, container.priority)
                self.backend.release_container(container.container_id)
                return
            self._launched[container.container_id] = (task, session.session_id)
            self._session_containers.setdefault(
                session.session_id, []).append(container.container_id)
            self._task_span_start(task, container)
        self.journal.append(
            J.REC_CONTAINER, task_id=task.task_id,
            container_id=container.container_id, host=container.host,
            attempt=task.attempt, session_id=session.session_id)
        req = session.requests[task.job_name]
        env = self._container_env(task, req, container)
        cmd = [sys.executable, "-m", "tony_tpu_torch.executor"]
        # a relaunched attempt gets its own log dir: the crashed attempt's
        # stdout/stderr are the evidence being debugged, and a slow
        # stop_container could leave the old process writing concurrently
        cdir = f"{task.job_name}_{task.index}_s{task.session_id}"
        if task.attempt > 0:
            cdir += f"_a{task.attempt}"
        cwd = os.path.join(self.app_dir, C.CONTAINERS_DIR_NAME, cdir)
        task.url = os.path.join(cwd, "stdout")
        self.backend.launch_container(container, cmd, env, cwd)
        # NOT hb-registered yet: liveliness starts at registerWorkerSpec
        # (reference ApplicationMaster.java:851) — at gang width, dozens
        # of executors boot concurrently and can take >expiry to reach
        # their first heartbeat; pre-registration loss is covered by the
        # registration timeout + container-completion callbacks
        self.event_handler.emit(Event(
            EventType.TASK_STARTED,
            TaskStarted(task.job_name, task.index, container.host,
                        container.container_id)))

    def _container_env(self, task: Task, req: JobContainerRequest,
                       container: Container) -> dict[str, str]:
        """Executor env block (ApplicationMaster.java:1109-1121)."""
        session = self.session
        env = {
            C.JOB_NAME: task.job_name,
            C.TASK_INDEX: str(task.index),
            C.TASK_NUM: str(req.num_instances),
            C.IS_CHIEF: str(session.is_chief(task.job_name, task.index)).lower(),
            C.SESSION_ID: str(session.session_id),
            C.AM_HOST: self.host,
            C.AM_PORT: str(self.rpc_port),
            C.METRICS_RPC_PORT: str(self.rpc_port),
            C.CONTAINER_ID: container.container_id,
            C.APP_ID: self.app_id,
            C.ATTEMPT_NUMBER: str(self._session_id),
            C.TASK_ATTEMPT: str(task.attempt),
            C.NUM_AM_RETRIES: str(self.conf.get_int(K.AM_RETRY_COUNT, 0)),
            C.TONY_APP_DIR: self.app_dir,
            # off-host containers with a configured staging store get a
            # cwd-relative conf path + fetch URI — no app-dir read at all;
            # otherwise (shared fs) the absolute frozen-conf path
            C.TONY_CONF_PATH: (
                C.TONY_FINAL_CONF
                if self.backend.off_host and self._conf_uri
                else os.path.join(self.app_dir, C.TONY_FINAL_CONF)),
            **({C.TONY_CONF_URI: self._conf_uri} if self._conf_uri else {}),
            "PYTHONPATH": framework_pythonpath(),
        }
        # trace context: the executor parents its spans under this
        # attempt's AM-side task span (observability/trace.py env contract)
        if self._trace_enabled:
            env[C.TONY_TRACE_ID] = self.app_id
            span = self._task_spans.get((task.task_id, task.attempt))
            if span is not None:
                env[C.TONY_PARENT_SPAN] = span.span_id
        # preprocess-scraped parameters, visible to every task
        # (ApplicationMaster.java:753-764)
        if self._model_params is not None:
            env[C.MODEL_PARAMS] = self._model_params
        # elastic resize: a container launched mid- or post-resize must
        # run the CURRENT width's mesh, not the frozen conf's
        mesh_override = self.elastic.mesh_override()
        if mesh_override:
            env[C.ELASTIC_MESH_SHAPE] = mesh_override
        # per-jobtype command override, else the global task command —
        # except `serving`, whose workload is built in: it runs the serve/
        # subsystem's server (knobs from tony.serving.*) unless
        # tony.serving.command overrides (e.g. to add --config /
        # --checkpoint-dir flags). The GLOBAL --executes command never
        # leaks into a serving task: in a mixed train+serve app it is the
        # training script.
        if task.job_name == C.SERVING_JOB_NAME:
            command = req.command or f"{sys.executable} -m tony_tpu_torch.serve"
        else:
            command = req.command \
                or self.conf.get_str(K.TASK_COMMAND) \
                or os.environ.get(C.TASK_COMMAND, "")
        env[C.TASK_COMMAND] = command
        # user-supplied pass-through env (tony.execution.env k=v list)
        for entry in self.conf.get_strings(K.EXECUTION_ENV):
            k, _, v = entry.partition("=")
            env[k] = v
        # docker runtime opt-in (util/Utils.java:718-765 equivalent)
        docker = docker_env(self.conf, task.job_name)
        if docker:
            env.update(docker)
        # security: each container gets its task-scoped derived token, not
        # the app secret — a leaked container env can authenticate only as
        # that task, never as the client (reference duplicated the flat
        # credential into every launch context,
        # ApplicationMaster.java:1137-1140; this narrows it per principal)
        if self._auth_token:
            from tony_tpu_torch.security.tokens import TOKEN_ENV, derive_task_token
            env[TOKEN_ENV] = derive_task_token(self._auth_token, task.task_id)
        return env

    def _on_container_completed(self, container_id: str, exit_code: int) -> None:
        """RMCallbackHandler.onContainersCompleted → processFinishedContainer
        (ApplicationMaster.java:1004-1023,1167-1200)."""
        # TEST hook: delay the completion notification to exercise the
        # executor-result-before-container-callback race
        # (reference: ApplicationMaster.java:1028-1037)
        delay = os.environ.get(C.TEST_TASK_COMPLETION_NOTIFICATION_DELAYED)
        if delay:
            time.sleep(float(delay) if delay.replace(".", "").isdigit() else 1.0)
        with self._lock:
            self._finished_containers.add(container_id)
            entry = self._launched.get(container_id)
            session = self.session
            if entry is None or session is None:
                LOG.warning("completion for unknown container %s", container_id)
                return
            task, launch_session = entry
            if launch_session != session.session_id:
                LOG.info("ignoring completion from stale session %d (now %d)",
                         launch_session, session.session_id)
                return
            if task.container_id != container_id:
                # the slot was relaunched and this completion belongs to the
                # superseded attempt's container (the AM killed it, or the
                # crash that triggered the relaunch is only now reported) —
                # it must not complete/fail the replacement attempt, and the
                # replacement's liveliness entry must stay registered
                LOG.info("ignoring completion of superseded container %s for "
                         "%s (attempt now %d)", container_id, task.task_id,
                         task.attempt)
                return
            # the attempt this completion belongs to, captured while the
            # container ownership check above still holds
            observed_attempt = task.attempt
        # elastic resize: an exit of a container the coordinator released
        # (shrink victim / rolled-back grow slot) is routine lifecycle —
        # its slot left (or never joined) the gang table, so it must not
        # complete, fail, or relaunch anything. Logs still aggregate:
        # the drained attempt's output is evidence.
        if self.elastic.is_released_container(container_id):
            LOG.info("container %s of %s exited after elastic release "
                     "(rc=%d)", container_id, task.task_id, exit_code)
            self.hb_monitor.unregister(task.task_id)
            self.metrics_store.clear_utilization_state(task.job_name,
                                                       task.index)
            self._task_span_end(task.task_id, observed_attempt, "OK",
                                reason="resized away")
            self._aggregate_task_container(task)
            self._wake.set()
            return
        # an exit observed while a preemption drain is in flight is the
        # drain completing (or the deadline force-stop), never a fault:
        # no failure record, no relaunch, and the completion below is
        # stamped preempted so the aggregation can't read it as a
        # worker failure
        draining = self._preemption is not None
        # diagnostics: a crash that never registered a result (hard kill,
        # os._exit) is only ever seen HERE — read the container's own
        # files for the tail + signature before the relaunch decision can
        # recycle the slot (first-wins: an executor-shipped report for
        # the same attempt already holds the slot)
        if exit_code not in (0, C.EXIT_KILLED_BY_AM) and not draining:
            self._record_task_failure(
                task.task_id, observed_attempt,
                f"container exited with code {exit_code}",
                exit_code=exit_code,
                container_dir=os.path.dirname(task.url) if task.url else "")
        # within budget, a tracked task's crash replaces only that container
        # instead of failing the session (the reference's all-or-nothing
        # short-circuit, TonySession.java:251-271, becomes the fallback).
        # (Rendezvous timeouts are fenced at register_execution_result via
        # the barrier_timeout flag; an executor that died before reporting
        # is indistinguishable from a crash here, which is the safe side.)
        if (exit_code not in (0, C.EXIT_KILLED_BY_AM) and not draining
                and session.is_tracked(task.job_name)
                and self._maybe_relaunch_task(
                    task, f"container exited with code {exit_code}",
                    observed_attempt=observed_attempt)):
            return
        # a task that crashed without registering its result must not linger
        # in the liveliness monitor and expire later
        self.hb_monitor.unregister(task.task_id)
        self.metrics_store.clear_utilization_state(task.job_name, task.index)
        self._clear_profile_request(task.task_id)
        self._drop_serving_endpoint(task.task_id)
        self._task_span_end(
            task.task_id, observed_attempt,
            "OK" if exit_code in (0, C.EXIT_KILLED_BY_AM) else "ERROR",
            reason=f"exit {exit_code}")
        session.on_task_completed(task.job_name, task.index, exit_code,
                                  preempted=(draining
                                             and exit_code not in
                                             (0, C.EXIT_KILLED_BY_AM)))
        self.journal.append(
            J.REC_COMPLETED, task_id=task.task_id,
            attempt=observed_attempt, exit_code=exit_code,
            status=task.status.value)
        # incremental log aggregation: this container's streams are final
        # — copy them into history NOW, so an AM crash/kill -9 after this
        # point no longer loses the logs (previously aggregation only
        # happened at application finish)
        self._aggregate_task_container(task)
        self.scheduler.register_dependency_completed(task.job_name)
        self.event_handler.emit(Event(
            EventType.TASK_FINISHED,
            TaskFinished(task.job_name, task.index, task.status.value,
                         self.metrics_store.get_metrics(task.job_name,
                                                        task.index))))
        # untracked-crash detection prevents application hang-ups
        # (ApplicationMaster.java:1192-1195)
        if not session.is_tracked(task.job_name) and not draining \
                and exit_code not in (0, C.EXIT_KILLED_BY_AM):
            self._untracked_task_failed = True
        self._wake.set()

    def _on_task_deemed_dead(self, task_id: str, attempt: int = -1) -> None:
        """(ApplicationMaster.onTaskDeemedDead, ApplicationMaster.java:1158-1165
        — but expiry now routes through the relaunch budget first; only an
        exhausted budget ends the application). `attempt` is the attempt the
        expired liveliness entry belonged to — an expiry delivered after
        that attempt was already relaunched past must not judge the healthy
        replacement by its predecessor's silence."""
        session = self.session
        task = session.get_task_by_id(task_id) if session is not None else None
        if task is None:
            # orphaned liveliness entry: a stale executor's registration
            # raced _reset()'s clear() — the task isn't in the current
            # session, so its silence must not fail the new session
            LOG.warning("ignoring heartbeat expiry for stale task %s",
                        task_id)
            self.hb_monitor.unregister(task_id)
            return
        if self._preemption is not None:
            # silence during a drain is the drain (the executor stops
            # heartbeating on its way out): the deadline force-stop owns
            # cleanup — never a relaunch, never a session failure
            LOG.info("ignoring heartbeat expiry of %s during preemption "
                     "drain", task_id)
            self.hb_monitor.unregister(task_id)
            return
        if (attempt < 0 or task.attempt == attempt) and not task.completed \
                and task.container_id:
            # a wedge the liveliness monitor caught: no exit code exists,
            # but the container's files often hold the story (hung
            # collective, stalled input) — snapshot the tail now, before
            # a relaunch recycles the dir name. The stack autopsy runs
            # FIRST: a silent-but-alive executor answers read_stacks and
            # the dump names the exact frame it is parked in
            self._capture_task_stacks(
                task_id, attempt if attempt >= 0 else task.attempt,
                f"missed {self._max_missed_hb} heartbeats")
            self._record_task_failure(
                task_id, attempt if attempt >= 0 else task.attempt,
                f"missed {self._max_missed_hb} heartbeats",
                container_dir=(os.path.dirname(task.url)
                               if task.url else ""))
        if attempt >= 0 and task.attempt != attempt:
            # stale expiry: the silent attempt was already relaunched past
            LOG.info("ignoring expiry of %s attempt %d (slot now at "
                     "attempt %d)", task_id, attempt, task.attempt)
            return
        if task.completed:
            # result already registered; the expired entry was a leftover
            return
        if not task.container_id:
            # the slot is between attempts (a relaunch is in flight): this
            # expiry belongs to the superseded attempt's liveliness entry
            # that raced the unregister — the replacement re-registers with
            # a fresh clock, so its silence must not be judged yet
            LOG.info("ignoring expiry for %s: slot awaiting its "
                     "replacement container", task_id)
            return
        if self._maybe_relaunch_task(
                task, f"missed {self._max_missed_hb} heartbeats",
                observed_attempt=(attempt if attempt >= 0
                                  else task.attempt)):
            # the wedged attempt is being replaced: close its latched
            # stall pair so the history reads detect → relaunch → clear
            self._clear_remote_stall(task_id, "relaunched")
            return
        msg = (f"Task with id [{task_id}] has missed "
               f"[{self._max_missed_hb}] heartbeats. Ending application!")
        LOG.error(msg)
        self._task_missed_hb = True
        session.set_final_status(FinalStatus.FAILED, msg)
        self._wake.set()

    def _maybe_relaunch_task(self, task: Task, reason: str,
                             observed_attempt: int = -1,
                             count_failure: bool = True,
                             force: bool = False) -> bool:
        """The relaunch decision path: on a tracked task's crash or
        heartbeat expiry, stop only that container, recycle the slot
        (bumping the cluster-spec generation so survivors re-rendezvous
        while keeping their containers and localized resources), and
        re-request ONE replacement through the scheduler — if and only if
        the per-jobtype attempt budget and the app-wide failure circuit
        breaker both allow it. Returns True when the failure was absorbed
        by a relaunch (or is stale — see observed_attempt); False means
        the caller proceeds with today's fail-the-session path.

        `observed_attempt` is the attempt number the caller saw failing.
        One crash has up to three observers (executor-reported result,
        container-completion callback, heartbeat expiry) and none of them
        holds the AM lock when calling here — the first to win the lock
        relaunches, bumping task.attempt; the fence turns every later
        observer of the SAME failure into a no-op instead of letting it
        burn a second budget slot or fail the in-flight replacement."""
        with self._lock:
            session = self.session
            if (session is None or session.training_finished
                    or session.final_status != FinalStatus.UNDEFINED
                    or self._client_signal_stop.is_set()
                    or self._preemption is not None):
                return False
            if task.session_id != session.session_id:
                # a stale-session observer racing an AM session retry: the
                # old Task object must not resolve by name/index onto the
                # NEW session's healthy same-named slot and burn its
                # budget. Absorbed (True), not declined: the caller's
                # fail path would complete the new slot with a dead
                # session's exit code
                LOG.info("ignoring failure of %s from superseded session "
                         "%d (now %d)", task.task_id, task.session_id,
                         session.session_id)
                return True
            if observed_attempt >= 0 and task.attempt != observed_attempt:
                # another observer already relaunched past the attempt this
                # failure belongs to — absorb it (the caller must neither
                # fail the session nor complete the replacement's slot).
                # This fence runs FIRST: any later gate returning False
                # would hand the stale failure to the fail-the-session path
                LOG.info("ignoring stale failure of %s attempt %d (%s): "
                         "already relaunched to attempt %d", task.task_id,
                         observed_attempt, reason, task.attempt)
                return True
            if not session.is_tracked(task.job_name) or task.completed:
                return False
            # force marks an OPERATOR-lifecycle relaunch (rolling weight
            # update): not a failure, so neither the attempt budget nor
            # the completed-peer barrier concern applies — serving
            # replicas rendezvous independently and the replacement is
            # the whole point
            if not force and session.num_completed_barrier_tasks() > 0:
                # a completed peer cannot re-enter the barrier, so the
                # replacement would rendezvous against its dead endpoint
                # and hang — once any tracked GANG task has finished,
                # failures fall back to the session-level recovery
                # ladder. Completed serving replicas don't count: they
                # never rendezvous, and an autoscaler scale-down exits
                # one cleanly as routine lifecycle
                LOG.warning("not relaunching %s (%s): %d tracked peer(s) "
                            "already completed and cannot re-join the gang",
                            task.task_id, reason,
                            session.num_completed_barrier_tasks())
                return False
            # count_failure=False marks a non-failure relaunch (straggler
            # remediation): it still spends the attempt budget below, but
            # a slow-yet-alive task must not burn the application's
            # task-FAILURE circuit breaker
            if count_failure:
                self._total_task_failures += 1
            max_attempts = session.max_task_attempts(task.job_name)
            # failure attempts only: attempts consumed by rolling-update
            # (force) relaunches incremented `attempt` for fencing but
            # must not spend the crash budget
            failure_attempts = task.attempt - task.lifecycle_relaunches
            if not force and failure_attempts + 1 >= max_attempts:
                if max_attempts > 1:
                    LOG.error("task %s failed (%s) with its attempt budget "
                              "exhausted (%d/%d)", task.task_id, reason,
                              failure_attempts + 1, max_attempts)
                return False
            max_total = self.conf.get_int(
                K.APPLICATION_MAX_TOTAL_TASK_FAILURES, -1)
            if not force and 0 <= max_total < self._total_task_failures:
                LOG.error("task %s failed (%s) but the application already "
                          "saw %d task failures (circuit breaker: %d) — not "
                          "relaunching", task.task_id, reason,
                          self._total_task_failures, max_total)
                return False
            old_cid = task.container_id
            old_url = task.url
            if session.relaunch_task(task.job_name, task.index) is None:
                return False
            if force:
                # this attempt belongs to an operator lifecycle (rolling
                # update), not a failure — exclude it from the budget
                task.lifecycle_relaunches += 1
            # the dead attempt must not linger in liveliness or wedge
            # detection; the replacement re-registers under the same id
            self.hb_monitor.unregister(task.task_id)
            self.metrics_store.clear_utilization_state(task.job_name,
                                                       task.index)
            # re-arm the barrier clock: a replacement that never registers
            # must still time the session out instead of hanging forever
            if self._alloc_timeout_ms > 0:
                self._registration_deadline = (
                    time.monotonic() + self._alloc_timeout_ms / 1000.0)
            new_attempt = task.attempt
            new_generation = session.spec_generation
            # goodput: the relaunch gap starts NOW and closes when the
            # gang barrier completes again — wall-clock no task process
            # exists to account for, charged against job goodput
            self._relaunch_pending_since[task.task_id] = time.monotonic()
            # ...and EVERY task's ledger is archived under the superseded
            # generation: the victim's replacement AND each survivor's
            # relaunched user process start fresh ledgers whose pushes
            # overwrite the slot (merge-by-name), so the pre-relaunch
            # epoch would otherwise vanish from the job accounting. The
            # live perf gauges are dropped after archiving — keeping
            # both would double-count the epoch until the successor's
            # first push.
            epoch = new_generation - 1
            for tid, gauges in self.metrics_store.latest_gauges().items():
                if any(k.startswith("GOODPUT_") for k in gauges):
                    self._goodput_archive[f"{tid}@g{epoch}"] = gauges
                    name, _, idx = tid.rpartition(":")
                    self.metrics_store.drop_perf_gauges(name, int(idx))
            # a pending profiler ask targeting the dead attempt would
            # wedge the slot forever; the operator re-requests
            self._clear_profile_request(task.task_id)
            LOG.warning("relaunching task %s (%s): attempt %d/%d, spec "
                        "generation %d, stopping container %s",
                        task.task_id, reason, new_attempt + 1, max_attempts,
                        new_generation, old_cid or "<none>")
        # outside the AM lock: container stop + event emit don't need it,
        # and stop_container may block on process teardown
        self.journal.append(
            J.REC_RELAUNCH, task_id=task.task_id, attempt=new_attempt,
            generation=new_generation, lifecycle=force, reason=reason)
        if old_cid:
            self.backend.stop_container(old_cid)
        # the superseded attempt's serving endpoint dies with its
        # container; the replacement re-registers its own
        self._drop_serving_endpoint(task.task_id)
        # relaunch supersession: the dead attempt's logs are evidence —
        # aggregate them into history NOW (its dir name is attempt-unique,
        # so the replacement can never overwrite them)
        if old_url:
            self._aggregate_one_container(
                os.path.basename(os.path.dirname(old_url)))
        # skew state for the slot starts clean: the replacement attempt
        # must not inherit the dead attempt's lag windows or startup
        # values. A latched straggler's latch releases HERE — whatever
        # triggered the relaunch (remediation or an ordinary crash), the
        # slot it was latched on no longer exists — so the CLEARED event
        # is emitted by the one path every relaunch funnels through.
        if self._straggler_enabled:
            self.skew_tracker.clear_task(task.task_id)
            cleared = self.straggler.clear_task(task.task_id,
                                                reason="relaunched")
            if cleared is not None:
                self.event_handler.emit(Event(
                    EventType.STRAGGLER_CLEARED,
                    StragglerCleared(
                        task.job_name, task.index, reason="relaunched",
                        windows_lagging=int(cleared["windows"]))))
        # the failed attempt's span ends here; the gang is back at the
        # barrier until the replacement registers, so a fresh rendezvous
        # span opens (waterfall shows relaunch → re-rendezvous wait)
        self._task_span_end(task.task_id, new_attempt - 1, "ERROR",
                            reason=reason)
        self._rendezvous_span_start(f"relaunch:{task.task_id}")
        self.event_handler.emit(Event(
            EventType.TASK_RELAUNCHED,
            TaskRelaunched(task.job_name, task.index, new_attempt,
                           new_generation, reason)))
        self.scheduler.schedule_replacement(task.job_name)
        self._wake.set()
        return True

    # ------------------------------------------------------------------
    # ClusterServiceHandler: the 7-RPC control plane
    # (inner class RpcForClient, ApplicationMaster.java:787-932)
    # ------------------------------------------------------------------
    def get_task_infos(self, req: dict) -> list[dict]:
        if self.session is None:
            return []
        infos = [i.to_dict() for i in self.session.get_task_infos()]
        # surface the heartbeating-but-idle diagnosis (MetricsStore wedge
        # detection) on the client status path — RUNNING tasks only; a
        # completed task's stale flag is cleared on completion, and an
        # ended status must never read as "currently wedged"
        idle = set(self.metrics_store.low_utilization_tasks())
        if idle:
            for info in infos:
                if (info.get("status") == "RUNNING"
                        and f"{info.get('name')}:{info.get('index')}"
                        in idle):
                    info["low_utilization"] = True
        with self._lock:
            tb_url = self._tb_url
            # live serving endpoints ride the same status channel the
            # reference used for the TB URL, so clients/proxies discover
            # the inference endpoint without parsing history
            endpoints = sorted(self._serving_endpoints.items())
        if tb_url:
            infos.append({"name": "tensorboard", "index": 0,
                          "url": tb_url, "status": "RUNNING"})
        for i, (task_id, rec) in enumerate(endpoints):
            infos.append({"name": "serving-endpoint", "index": i,
                          "task_id": task_id, "url": rec["url"],
                          "generation": rec.get("generation", 0),
                          "draining": bool(rec.get("draining")),
                          "role": rec.get("role", ""),
                          "status": ("DRAINING" if rec.get("draining")
                                     else "RUNNING")})
        return infos

    def get_cluster_spec(self, req: dict) -> dict:
        if self.session is None:
            return {"spec": None}
        spec = self.session.cluster_spec_json()
        if spec is not None:
            # a full O(width) payload on the wire — counted like a
            # barrier-release serve so spec_bytes accounting covers every
            # fan-out path (the diff protocol exists to keep this rare)
            self.session.note_full_serve(spec)
        return {"spec": spec,
                "generation": self.session.spec_generation}

    def register_worker_spec(self, req: dict) -> dict:
        session = self.session
        if session is None:
            return {"spec": None}
        sid = int(req.get("session_id", -1))
        task = session.get_task_by_id(req["task_id"])
        attempt = int(req.get("task_attempt", -1))
        if task is not None and attempt >= 0 and attempt != task.attempt:
            # fast path: a superseded attempt's executor (zombie the AM
            # already relaunched past) re-registering must not overwrite
            # the replacement's host:port or plant a liveliness entry — it
            # gets an open barrier forever and eventually times itself out.
            # (The session-locked expected_attempt fence below is the
            # authoritative check; this just skips the work.)
            LOG.warning("ignoring registration from superseded attempt %d "
                        "of %s (current attempt %d)", attempt,
                        req["task_id"], task.attempt)
            return {"spec": None, "generation": session.spec_generation}
        spec, generation, accepted = \
            session.register_worker_spec_with_generation(
                req["task_id"], req["spec"], expected_attempt=attempt)
        # liveliness begins HERE, like the reference (ApplicationMaster
        # .java:851): the executor is demonstrably alive and its
        # heartbeater starts right after this call returns. Gated on the
        # session-locked acceptance (planting it before the fence could
        # resurrect an entry a concurrent relaunch just unregistered) and
        # on the executor's SESSION id (task ids repeat across AM
        # retries): a stale previous-session registration racing _reset
        # must not plant a liveliness record attributed to the new
        # session's same-named task (register_execution_result has the
        # same gate). The entry carries the attempt the acceptance was
        # based on, so a stale expiry can be fenced later.
        if accepted and sid in (session.session_id, -1) and task is not None:
            self.hb_monitor.register(
                req["task_id"], attempt if attempt >= 0 else task.attempt)
            self.journal.append(
                J.REC_REGISTER, task_id=req["task_id"],
                host_port=str(req.get("spec", "") or ""),
                attempt=attempt if attempt >= 0 else task.attempt,
                session_id=session.session_id, generation=generation)
            # an orphaned executor re-registering after an AM restart is
            # the adoption barrier's primary drain path
            self._note_recovery_adoption(
                req["task_id"], attempt if attempt >= 0 else task.attempt)
        # TEST hook: simulate chief-worker termination once the chief shows up
        # (reference: killChiefWorkerIfTesting, ApplicationMaster.java:1204-1215)
        if (os.environ.get(C.TEST_WORKER_TERMINATION)
                and req["task_id"] == f"{C.WORKER_JOB_NAME}:0"):
            threading.Thread(target=self._kill_workers_for_test,
                             daemon=True).start()
        return {"spec": spec, "generation": generation}

    def _kill_workers_for_test(self) -> None:
        time.sleep(0.5)
        with self._lock:
            cids = [cid for cid, (task, sid) in self._launched.items()
                    if task.job_name == C.WORKER_JOB_NAME
                    and sid == self.session.session_id]
        LOG.warning("TEST_WORKER_TERMINATION: killing %d workers", len(cids))
        for cid in cids:
            self.backend.stop_container(cid)

    def register_tensorboard_url(self, req: dict) -> dict:
        url = req.get("url", "")
        with self._lock:
            self._tb_url = url
        LOG.info("TensorBoard registered at %s", url)
        return {}

    def register_serving_endpoint(self, req: dict) -> dict:
        """A serving task's HTTP frontend announced its live endpoint
        (or, with draining=true, its impending drain): record it (task
        infos — the fleet router's endpoint-set source) and persist it
        to history so the portal job page can render the URL after the
        AM is gone. A registration with no explicit weights_generation
        is stamped with the AM's current epoch: any freshly (re)started
        replica restored the newest promoted checkpoint, which is
        exactly what the epoch names."""
        task_id = str(req.get("task_id", ""))
        url = str(req.get("url", ""))
        if not task_id or not url:
            return {}
        name, _, idx = task_id.rpartition(":")
        try:
            index = int(idx)
        except ValueError:
            name, index = task_id, 0
        explicit_gen = int(req.get("weights_generation", 0) or 0)
        draining = bool(req.get("draining"))
        role = str(req.get("role", "") or "")
        with self._lock:
            known = self._serving_endpoints.get(task_id)
            generation = explicit_gen or self._weights_generation
            if known is not None:
                if draining:
                    # a drain announcement keeps the recorded generation:
                    # the replica is going away, not changing weights
                    generation = known.get("generation", generation)
                # a re-registration without an explicit role keeps the
                # recorded pool membership (drain asks omit it)
                role = role or known.get("role", "")
            self._serving_endpoints[task_id] = {
                "url": url, "generation": generation,
                "draining": draining, "role": role}
        self.journal.append(J.REC_ENDPOINT, task_id=task_id, url=url,
                            generation=generation, draining=draining,
                            role=role)
        if draining:
            LOG.info("serving endpoint draining: %s (%s)", task_id, url)
            return {}
        if known is None or known.get("url") != url \
                or known.get("draining"):
            LOG.info("serving endpoint registered: %s -> %s "
                     "(weights generation %d)", task_id, url, generation)
            self.event_handler.emit(Event(
                EventType.SERVING_ENDPOINT_REGISTERED,
                ServingEndpointRegistered(name, index, url)))
        return {}

    def report_serving_migrated(self, req: dict) -> dict:
        """Telemetry from a prefill-role replica: it handed `count`
        request(s)' KV prefix + sampler state to the decode replica at
        target_url over /v1/migrate. Emits SERVING_MIGRATED into job
        history so operators can audit disaggregation traffic."""
        task_id = str(req.get("task_id", ""))
        target_url = str(req.get("target_url", ""))
        if not task_id or not target_url:
            return {}
        name, _, idx = task_id.rpartition(":")
        try:
            index = int(idx)
        except ValueError:
            name, index = task_id, 0
        count = max(1, int(req.get("count", 1) or 1))
        self.event_handler.emit(Event(
            EventType.SERVING_MIGRATED,
            ServingMigrated(name, index, target_url, count)))
        return {}

    # holds: _lock (callers mark drains under the AM lock)
    def _mark_endpoint_draining(self, task_id: str) -> None:
        rec = self._serving_endpoints.get(task_id)
        if rec is not None:
            rec["draining"] = True
            self.journal.append(
                J.REC_ENDPOINT, task_id=task_id, url=rec.get("url", ""),
                generation=int(rec.get("generation", 0)), draining=True,
                role=rec.get("role", ""))

    def _drop_serving_endpoint(self, task_id: str) -> None:
        """A serving task completed: its endpoint leaves the set (the
        router's next poll stops considering it entirely)."""
        with self._lock:
            existed = self._serving_endpoints.pop(task_id, None) is not None
        if existed:
            self.journal.append(J.REC_ENDPOINT, task_id=task_id,
                                removed=True)

    def register_execution_result(self, req: dict) -> dict:
        """Executor-reported exit code. Unregisters the task from the HB
        monitor early — AFTER the session-id gate, so a stale
        previous-session executor reporting a same-named task cannot strip
        the current session's task from liveliness monitoring — but before
        completion handling, so a delayed container-completion callback
        can't race a clean exit into a missed-heartbeat failure
        (reference rationale: ApplicationMaster.java:890-918)."""
        task_id = f"{req['job_name']}:{req['job_index']}"
        session = self.session
        if session is None or int(req.get("session_id", -1)) != session.session_id:
            return {}
        task = session.get_task_by_id(task_id)
        attempt = int(req.get("task_attempt", -1))
        if task is not None and attempt >= 0 and attempt != task.attempt:
            # superseded attempt reporting after its slot was relaunched:
            # its result must not complete (or fail) the replacement
            LOG.info("ignoring execution result from superseded attempt %d "
                     "of %s (current attempt %d)", attempt, task_id,
                     task.attempt)
            return {}
        exit_code = int(req["exit_code"])
        # elastic shrink: a release victim's exit is the slot LEAVING the
        # gang — terminal, never a fault: no failure record, no relaunch
        # budget, and the slot is NOT completed (the coordinator removes
        # it from the table once every member quiesced). Acknowledged
        # only while a resize actually names this task a victim; a
        # release racing a resize abort means the slot STAYS — relaunch
        # it through the budget-exempt lifecycle path so the gang heals.
        if req.get("resized") and task is not None:
            if self.elastic.note_released(task_id, task.container_id):
                LOG.info("task %s released for elastic shrink (rc=%d)",
                         task_id, exit_code)
                self.hb_monitor.unregister(task_id)
                self._clear_profile_request(task_id)
                self._drop_serving_endpoint(task_id)
                self._task_span_end(
                    task_id, attempt if attempt >= 0 else task.attempt,
                    "OK", reason="resized away")
                self._wake.set()
                return {}
            if self._maybe_relaunch_task(
                    task, "elastic release raced a resize abort",
                    observed_attempt=(attempt if attempt >= 0
                                      else task.attempt),
                    count_failure=False, force=True):
                return {}
        # checkpoint-then-evict drain: the executor TERMed its user
        # process on the drain ask and the trainer emergency-checkpointed
        # — terminal, not a fault: no failure record, no relaunch budget,
        # PREEMPTED task status (acknowledged only while a drain is
        # actually in flight; the flag alone must not let a crashing
        # executor dress a real failure up as a preemption)
        if req.get("preempted") and self._preemption is not None \
                and task is not None:
            LOG.info("task %s drained for preemption (rc=%d)", task_id,
                     exit_code)
            self.hb_monitor.unregister(task_id)
            self._clear_profile_request(task_id)
            self._drop_serving_endpoint(task_id)
            self._task_span_end(task_id,
                                attempt if attempt >= 0 else task.attempt,
                                "OK", reason="preempted")
            session.on_task_completed(req["job_name"],
                                      int(req["job_index"]), exit_code,
                                      preempted=True)
            self._wake.set()
            return {}
        # a non-zero exit observed while a drain is in flight is part of
        # the drain (the executor may simply not have seen the drain ask
        # yet when its user process died of the TERM) — mirror the
        # container-completion path: no failure record, no relaunch, and
        # the completion below is stamped preempted so a mid-drain crash
        # can't trip the chief/stop-on-failure short-circuit and turn
        # the PREEMPTED terminal state into FAILED
        draining = self._preemption is not None
        # diagnostics: the executor's own classified, redacted post-mortem
        # is the best failure evidence — record it FIRST (attempt-fenced,
        # first-wins) so neither the relaunch decision nor a racing
        # completion callback can beat it to the record slot
        if exit_code not in (0, C.EXIT_KILLED_BY_AM) and task is not None \
                and not draining:
            self._record_task_failure(
                task_id, attempt if attempt >= 0 else task.attempt,
                ("gang rendezvous timed out" if req.get("barrier_timeout")
                 else f"executor reported exit {exit_code}"),
                exit_code=exit_code,
                diagnostics=req.get("diagnostics")
                if isinstance(req.get("diagnostics"), dict) else None,
                container_dir=os.path.dirname(task.url) if task.url else "")
        # barrier_timeout marks a rendezvous timeout — an allocation
        # problem, not a task fault: replacing healthy containers cannot
        # conjure the missing allocation, so no relaunch budget is spent.
        # (An explicit flag, not an exit code: every 0-255 value is
        # reachable by the user process itself.)
        if (task is not None and not req.get("barrier_timeout")
                and not draining
                and exit_code not in (0, C.EXIT_KILLED_BY_AM)
                and self._maybe_relaunch_task(
                    task, f"executor reported exit {exit_code}",
                    observed_attempt=(attempt if attempt >= 0
                                      else task.attempt))):
            return {}
        self.hb_monitor.unregister(task_id)
        self._clear_profile_request(task_id)
        self._drop_serving_endpoint(task_id)
        session.on_task_completed(req["job_name"], int(req["job_index"]),
                                  exit_code,
                                  preempted=(draining
                                             and exit_code not in
                                             (0, C.EXIT_KILLED_BY_AM)))
        if task is not None:
            self.journal.append(
                J.REC_COMPLETED, task_id=task_id,
                attempt=attempt if attempt >= 0 else task.attempt,
                exit_code=exit_code, status=task.status.value)
        self._wake.set()
        return {}

    def finish_application(self, req: dict) -> dict:
        self._client_signal_stop.set()
        self._wake.set()
        return {}

    def _fail_unsatisfiable(self, job_name: str, message: str) -> None:
        """An UnsatisfiableRequestError from the backend: fail the app
        immediately (set-once final status; wake the monitor in case the
        request came from a mid-run dependency release). Status is set
        BEFORE the flag: the monitor may observe the flag the instant it
        is written, and must then find the FAILED status in place."""
        if self.session is not None:
            self.session.set_final_status(
                FinalStatus.FAILED,
                f"Unsatisfiable container request for jobtype "
                f"{job_name!r}: {message}")
        self._unsatisfiable_request = job_name
        self._wake.set()

    def task_executor_heartbeat(self, req: dict) -> dict:
        """The width-scaled hot path: at gang width W this runs W times per
        heartbeat interval, so it must stay a cheap dict-update — all
        O(width) work (expiry scans, diff rendering) is deferred to the
        sharded liveliness sweep and the session's per-generation caches."""
        session = self.session
        generation = session.spec_generation if session is not None else 0
        attempt = int(req.get("task_attempt", -1))
        if session is not None and attempt >= 0:
            task = session.get_task_by_id(req["task_id"])
            if task is not None and attempt != task.attempt:
                # zombie ping from a relaunched-past attempt: must not keep
                # the replacement's liveliness entry fresh (and must never
                # be handed a spec diff — it has no live spec to patch)
                return {"spec_generation": generation}
        # AM recovery: an adopted executor's first heartbeat at the
        # journaled attempt satisfies the adoption barrier (it never
        # re-registers when its old AM address still resolves — the
        # TEST_AM_HANG thaw case). Lock-free pre-check: recovery is
        # almost never in flight and W pings/interval must not pay for it.
        # tony: disable=guarded-by -- lock-free heartbeat fast path
        if self._recovery is not None:
            self._note_recovery_adoption(req["task_id"], attempt)
        # live-tail surface: remember where this attempt's TaskLogService
        # listens (attempt-fenced above — a zombie's address can never
        # displace the replacement's). Lock-free fast path: the address is
        # identical on every ping after the first, so the AM lock — shared
        # with the monitor loop's O(width) passes — is only taken when the
        # gossiped address actually changes.
        log_addr = str(req.get("log_addr", "") or "")
        if log_addr:
            # deliberate lock-free pre-check: the address is identical on
            # every ping after the first, and W heartbeats/interval must
            # not serialize on the AM lock to discover that; the
            # write below re-checks under the lock
            # tony: disable=guarded-by -- lock-free heartbeat fast path
            known = self._log_addrs.get(req["task_id"])
            if known is None or known != (max(attempt, 0), log_addr):
                with self._lock:
                    self._log_addrs[req["task_id"]] = (max(attempt, 0),
                                                       log_addr)
        if not self.hb_monitor.ping(req["task_id"]):
            # an alive executor with no liveliness entry: it either has not
            # registered yet (entries are planted at register_worker_spec)
            # or its entry already expired and the relaunch verdict is in
            # flight — either way the ping must not resurrect it
            LOG.debug("heartbeat from %s has no liveliness entry",
                      req["task_id"])
        resp = {"spec_generation": generation}
        # coalesced control plane: the executor reports the generation of
        # the spec it holds; a survivor behind the current generation gets
        # the generation-keyed diff (changed tasks only) piggybacked HERE
        # instead of re-polling register_worker_spec for the full O(width)
        # spec. While the re-rendezvous barrier is still open nothing is
        # attached (the diff rides a later heartbeat); only an executor
        # whose generation fell outside the diff window is told to refetch.
        if session is not None:
            exec_gen = int(req.get("spec_generation", -1) or -1)
            resp.update(session.heartbeat_spec_fields(exec_gen))
        # elastic resize: while a quiesce (or corrective revert) is in
        # flight, the resize ask rides every member's heartbeat and the
        # executor's quiesce ack rides back — the coordinator gates the
        # membership change on every ack, so a new-width trainer can
        # never restore before the in-place checkpoint committed.
        # Lock-free `active` pre-check: a resize almost never exists and
        # W pings/interval must not pay for the one that doesn't.
        if self.elastic.active:
            ask = self.elastic.heartbeat_fields(req["task_id"])
            if ask:
                resp["resize"] = ask
            ack = int(req.get("resize_ack", 0) or 0)
            if ack > 0:
                self.elastic.note_quiesced(req["task_id"], ack)
            # the generation a survivor reports holding is the evidence
            # it re-rendezvoused: the coordinator closes the resize (and
            # its downtime clock) on the gang being BACK, not merely on
            # the membership books changing
            self.elastic.note_generation(
                req["task_id"], int(req.get("spec_generation", 0) or 0))
        # checkpoint-then-evict: the drain ask rides every heartbeat
        # while a preemption is in flight (resends are harmless — the
        # executor's drain is one-shot); grace_ms is the REMAINING
        # window, so a late-heartbeating task doesn't overshoot the
        # deadline every earlier task is held to
        preemption = self._preemption
        if preemption is not None:
            resp["drain"] = {
                "grace_ms": max(
                    0, int((preemption["deadline"] - time.monotonic())
                           * 1000)),
                "reason": preemption.get("reason", "")}
        # on-demand profiler: a pending request for this task rides its
        # heartbeat (resent until the capture completes — the executor's
        # request-file write and the trainer's id-dedup are idempotent).
        # Lock-free emptiness pre-check: profile requests are rare
        # operator asks, and W heartbeats/interval must not serialize on
        # the AM lock to discover an empty dict.
        if self._profile_requests and \
                self._profile_requests.get(req["task_id"]) is not None:
            with self._lock:
                preq = self._profile_requests.get(req["task_id"])
                if preq is not None and preq["state"] in ("pending", "sent"):
                    preq["state"] = "sent"
                    resp["profile_request"] = {"request_id": preq["id"],
                                               "num_steps": preq["num_steps"]}
        return resp

    def request_preemption(self, req: dict) -> dict:
        """Arbiter/operator ask: checkpoint-then-evict this application.
        Sets the one-shot drain state (idempotent — a second ask returns
        the in-flight drain's deadline), emits PREEMPTION_REQUESTED, and
        wakes the monitor; from here the drain ask rides every task
        heartbeat, executors TERM their user processes, trainers
        emergency-checkpoint inside the grace window, and the
        application finishes PREEMPTED (see _check_preemption)."""
        session = self.session
        if session is None:
            return {"error": "no active session"}
        grace_ms = int(req.get("grace_ms", 0) or 0) or self.conf.get_time_ms(
            K.ARBITER_GRACE_MS, 30_000)
        reason = str(req.get("reason", "") or "")
        requested_by = str(req.get("requested_by", "") or "operator")
        with self._lock:
            if self._preemption is not None:
                p = self._preemption
                return {"app_id": self.app_id, "duplicate": True,
                        "grace_ms": p["grace_ms"],
                        "deadline_ms": max(0, int(
                            (p["deadline"] - time.monotonic()) * 1000))}
            self._preemption = {
                "reason": reason, "grace_ms": grace_ms,
                "requested_by": requested_by,
                "requested": time.monotonic(),
                "requested_ms": int(time.time() * 1000),
                "deadline": time.monotonic() + grace_ms / 1000.0,
            }
            # connection draining: every serving endpoint flips to
            # draining in the same breath, so an external fleet router
            # polling task infos stops new sends while the replicas
            # finish their in-flight streams inside the grace window
            for task_id in list(self._serving_endpoints):
                self._mark_endpoint_draining(task_id)
        LOG.warning("preemption requested by %s (%d ms grace): %s",
                    requested_by, grace_ms, reason or "unspecified")
        self.journal.append(
            J.REC_PREEMPTION, reason=reason, grace_ms=grace_ms,
            requested_by=requested_by,
            requested_ms=int(time.time() * 1000))
        self.event_handler.emit(Event(
            EventType.PREEMPTION_REQUESTED,
            PreemptionRequested(self.app_id, reason=reason,
                                grace_ms=grace_ms,
                                requested_by=requested_by)))
        # the registry shows the bumped preemption count right away
        self._publish_fleet_state(force=True)
        self._wake.set()
        return {"app_id": self.app_id, "grace_ms": grace_ms,
                "deadline_ms": grace_ms}

    def request_resize(self, req: dict) -> dict:
        """Arbiter/operator ask: elastic gang resize — grow/shrink the
        running gang in place (cluster/elastic.py state machine).
        Attempt-fenced: a resize aimed at a superseded session attempt
        (the asker read a stale registry entry across an AM session
        retry) must not fire on the retry's fresh gang — task ids and
        widths repeat across session attempts, so the ask names the
        attempt it was computed against."""
        session = self.session
        if session is None:
            return {"error": "no active session"}
        session_attempt = int(req.get("session_attempt", -1))
        if session_attempt >= 0 and session_attempt != session.session_id:
            LOG.warning("rejecting resize aimed at superseded session "
                        "attempt %d (now %d)", session_attempt,
                        session.session_id)
            return {"error": f"stale session attempt {session_attempt} "
                             f"(current {session.session_id})"}
        resp = self.elastic.request_resize(req)
        if "error" not in resp and not resp.get("duplicate"):
            self.journal.append(
                J.REC_RESIZE,
                ask={k: v for k, v in req.items()
                     if isinstance(v, (str, int, float, bool))})
        return resp

    def _schedule_preempt_if_testing(self) -> None:
        """TEST_TASK_PREEMPT='after_ms[#grace_ms]': the AM preempts
        itself after_ms after prepare(), exactly as if an arbiter's
        request_preemption had arrived — the chaos harness's
        checkpoint-then-evict injection (tests/chaos.py Preempt)."""
        spec = os.environ.get(C.TEST_TASK_PREEMPT)
        if not spec:
            return
        try:
            parts = spec.split("#")
            after_s = int(parts[0]) / 1000.0
            grace_ms = int(parts[1]) if len(parts) > 1 else 0
        except (ValueError, IndexError):
            LOG.error("bad TEST_TASK_PREEMPT spec: %r", spec)
            return
        LOG.warning("TEST hook: preempting this application in %d ms",
                    int(after_s * 1000))
        timer = threading.Timer(
            after_s, lambda: self.request_preemption(
                {"grace_ms": grace_ms, "reason": "TEST_TASK_PREEMPT",
                 "requested_by": "test"}))
        timer.daemon = True
        timer.start()

    def _schedule_am_chaos_if_testing(self) -> None:
        """AM-process chaos hooks (tests/chaos.py KillAM / HangAM):

        TEST_AM_KILL='after_ms[#attempt]' — SIGKILL our own process
        after_ms after prepare(), only when this is AM process attempt
        `attempt` (default 0), exercising the supervised-restart +
        journal-replay + live-gang-adoption path end to end.

        TEST_AM_HANG='after_ms#hang_ms[#attempt]' — SIGSTOP the AM for
        hang_ms then SIGCONT it, via a detached shell (a thread of a
        fully-stopped process cannot CONT itself): executors exhaust
        their heartbeat budget, enter orphan mode, and must re-attach to
        the SAME address once the AM thaws — no restart involved."""
        kill_spec = os.environ.get(C.TEST_AM_KILL)
        if kill_spec:
            try:
                parts = kill_spec.split("#")
                after_s = int(parts[0]) / 1000.0
                at_attempt = int(parts[1]) if len(parts) > 1 else 0
            except (ValueError, IndexError):
                LOG.error("bad TEST_AM_KILL spec: %r", kill_spec)
            else:
                if self._am_attempt == at_attempt:
                    import signal
                    LOG.warning("TEST hook: SIGKILL this AM (attempt %d) "
                                "in %d ms", self._am_attempt,
                                int(after_s * 1000))
                    timer = threading.Timer(
                        after_s,
                        lambda: os.kill(os.getpid(), signal.SIGKILL))
                    timer.daemon = True
                    timer.start()
        hang_spec = os.environ.get(C.TEST_AM_HANG)
        if hang_spec:
            try:
                parts = hang_spec.split("#")
                after_s = int(parts[0]) / 1000.0
                hang_s = int(parts[1]) / 1000.0
                at_attempt = int(parts[2]) if len(parts) > 2 else 0
            except (ValueError, IndexError):
                LOG.error("bad TEST_AM_HANG spec: %r", hang_spec)
            else:
                if self._am_attempt == at_attempt:
                    import subprocess
                    LOG.warning("TEST hook: SIGSTOP this AM in %d ms for "
                                "%d ms", int(after_s * 1000),
                                int(hang_s * 1000))
                    subprocess.Popen(
                        ["/bin/sh", "-c",
                         f"sleep {after_s}; kill -STOP {os.getpid()}; "
                         f"sleep {hang_s}; kill -CONT {os.getpid()}"],
                        start_new_session=True,
                        stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL)

    # an in-flight profiler ask older than this is considered lost (the
    # trainer's start_trace failed, or the profile_done push was dropped)
    # and a new request replaces it instead of echoing the dead id forever
    PROFILE_REQUEST_TTL_SEC = 600.0

    def _clear_profile_request(self, task_id: str) -> None:
        """Drop a not-yet-completed profiler ask for a task that is gone
        (completed or relaunched) — it could never be satisfied, and
        leaving it would wedge request_profile for the slot with
        duplicate:true for the rest of the application."""
        with self._lock:
            entry = self._profile_requests.get(task_id)
            if entry is not None and entry["state"] != "done":
                del self._profile_requests[task_id]

    def request_profile(self, req: dict) -> dict:
        """Operator ask: capture a profiler trace on one task's trainer.
        Default target is the first running tracked task; the ask rides
        that task's next heartbeat. Idempotent while in flight: a double
        request returns the same request_id (until the TTL calls the
        in-flight one lost)."""
        from tony_tpu_torch.observability.perf import new_profile_request_id
        if not self._profiling_enabled:
            return {"error": "profiling disabled (tony.profiling.enabled)"}
        session = self.session
        if session is None:
            return {"error": "no active session"}
        task_id = str(req.get("task_id", "") or "")
        if not task_id:
            running = [t for tasks in session.job_tasks.values()
                       for t in tasks
                       if session.is_tracked(t.job_name)
                       and not t.completed and t.container_id]
            if not running:
                return {"error": "no running tracked task to profile"}
            task_id = running[0].task_id
        else:
            task = session.get_task_by_id(task_id)
            if task is None:
                return {"error": f"no such task {task_id!r}"}
            if task.completed:
                return {"error": f"task {task_id} already completed"}
        steps = int(req.get("num_steps", 0) or 0) or self.conf.get_int(
            K.PROFILING_DEFAULT_STEPS, 5)
        now = time.monotonic()
        with self._lock:
            existing = self._profile_requests.get(task_id)
            if (existing is not None
                    and existing["state"] in ("pending", "sent")
                    and now - existing.get("ts", now)
                    < self.PROFILE_REQUEST_TTL_SEC):
                return {"request_id": existing["id"], "task_id": task_id,
                        "num_steps": existing["num_steps"],
                        "duplicate": True}
            rid = new_profile_request_id()
            self._profile_requests[task_id] = {
                "id": rid, "num_steps": steps, "state": "pending",
                "ts": now}
        LOG.info("profile requested for %s (%d steps, id %s)", task_id,
                 steps, rid)
        return {"request_id": rid, "task_id": task_id, "num_steps": steps}

    def get_profile(self, req: dict) -> dict:
        """Operator plane: the AM's own continuous-profile snapshot —
        sampler counters (rate, overhead, throttle) plus the
        collapsed-stack `folded` text, the flame renderer's input.
        Answers an error when no profiler was installed
        (tony.profiler.enabled=false or a bare harness)."""
        prof = self._profiler
        if prof is None:
            return {"error": "profiler not running"}
        snap = prof.snapshot()
        snap["folded"] = prof.folded_text()
        return snap

    def _log_client(self, task_id: str, attempt: int, addr: str):
        """Cached TaskLogServiceClient for one executor's log service,
        keyed to (attempt, addr) — a relaunch (new attempt/port)
        displaces and closes the stale channel."""
        from tony_tpu_torch.rpc.client import TaskLogServiceClient
        from tony_tpu_torch.security.tokens import derive_task_token
        with self._lock:
            cached = self._log_clients.get(task_id)
            if cached is not None and cached[0] == attempt \
                    and cached[1] == addr:
                return cached[2]
        token = (derive_task_token(self._auth_token, task_id)
                 if self._auth_token else None)
        host, _, port = addr.rpartition(":")
        client = TaskLogServiceClient(host, int(port), auth_token=token)
        stale = None
        with self._lock:
            stale = self._log_clients.get(task_id)
            self._log_clients[task_id] = (attempt, addr, client)
        if stale is not None:
            try:
                stale[2].close()
            except Exception:  # noqa: BLE001
                LOG.debug("displaced log client close failed", exc_info=True)
        return client

    def read_task_logs(self, req: dict) -> dict:
        """Operator plane: one bounded log chunk for a task. RUNNING task
        → proxied live from its executor's TaskLogService (address from
        heartbeat gossip, authenticated with the task's re-derived
        token); completed task (or unreachable executor) → served from
        the logs aggregated into history at task completion. Chunk size
        is capped at tony.logs.chunk-bytes either way."""
        from tony_tpu_torch.observability.logs import STREAMS, LogTail
        session = self.session
        if session is None:
            return {"error": "no active session"}
        stream = str(req.get("stream", "stderr") or "stderr")
        if stream not in STREAMS:
            return {"error": f"unknown stream {stream!r}"}
        offset = int(req.get("offset", -1))
        max_bytes = min(int(req.get("max_bytes", 0) or 0)
                        or self._log_chunk_bytes, self._log_chunk_bytes)
        task_id = str(req.get("task_id", "") or "")
        if not task_id:
            running = [t for tasks in session.job_tasks.values()
                       for t in tasks
                       if session.is_tracked(t.job_name)
                       and not t.completed and t.container_id]
            if not running:
                return {"error": "no running tracked task to tail"}
            task_id = running[0].task_id
        task = session.get_task_by_id(task_id)
        if task is None:
            return {"error": f"no such task {task_id!r}"}
        with self._lock:
            entry = self._log_addrs.get(task_id)
        if (not task.completed and entry is not None
                and entry[0] == task.attempt):
            client = self._log_client(task_id, entry[0], entry[1])
            try:
                chunk = client.read_log(stream, offset, max_bytes)
                if "error" not in chunk:
                    chunk["task_id"] = task_id
                    chunk["source"] = "live"
                    return chunk
            except Exception:  # noqa: BLE001 — degrade to aggregated logs
                LOG.warning("live log read from %s (%s) failed; falling "
                            "back to aggregated logs", task_id, entry[1],
                            exc_info=True)
        # aggregated / shared-fs path: the container's own file when this
        # host can see it, else the tail-capped copy in history
        path = None
        if task.url:
            candidate = os.path.join(os.path.dirname(task.url), stream)
            if os.path.isfile(candidate):
                path = candidate
        if path is None:
            cdir = (os.path.basename(os.path.dirname(task.url))
                    if task.url else "")
            if cdir:
                candidate = os.path.join(
                    self.history_dir, C.HISTORY_LOGS_DIR_NAME, cdir, stream)
                if os.path.isfile(candidate):
                    path = candidate
        if path is None:
            return {"error": f"no logs available for {task_id} ({stream})"}
        tail = LogTail(path, tail_bytes=self._log_tail_bytes,
                       chunk_bytes=self._log_chunk_bytes)
        chunk = tail.read_chunk(offset=offset, max_bytes=max_bytes,
                                final=task.completed)
        chunk["stream"] = stream
        chunk["task_id"] = task_id
        chunk["source"] = "aggregated"
        return chunk

    def _on_profile_captured(self, task_type: str, index: int,
                             pd: dict) -> None:
        """A trainer finished its capture (update_metrics profile_done):
        link the artifact into history — copy the trace dir next to the
        event log, publish it to the staging store at finish, emit
        PROFILE_CAPTURED. Idempotent per request_id."""
        task_id = f"{task_type}:{index}"
        rid = str(pd.get("request_id", "") or "")
        if not rid:
            return
        with self._lock:
            if rid in self._profiles_captured:
                return
            self._profiles_captured.add(rid)
            entry = self._profile_requests.get(task_id)
            if entry is not None and entry["id"] == rid:
                entry["state"] = "done"
        rel_dir = os.path.join(C.PROFILES_DIR_NAME, rid)
        dst = os.path.join(self.history_dir, rel_dir)
        src = str(pd.get("path", "") or "")
        try:
            if src and os.path.isdir(src):
                import shutil
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                # artifact not reachable from the AM host (off-host
                # container without a shared fs): the event still links
                # the source path for operators with node access
                os.makedirs(dst, exist_ok=True)
                meta = {"source_path": src, "note": "artifact not "
                        "reachable from the AM host"}
                with open(os.path.join(dst, "UNREACHABLE.json"), "w",
                          encoding="utf-8") as f:
                    json.dump(meta, f)
        except Exception:  # noqa: BLE001 — profiling must not fail the app
            LOG.exception("failed to copy profile artifact %s", src)
        LOG.info("profile %s captured by %s (%s steps) -> %s", rid,
                 task_id, pd.get("num_steps", "?"), dst)
        self.event_handler.emit(Event(
            EventType.PROFILE_CAPTURED,
            ProfileCaptured(task_type, index, rid, rel_dir,
                            num_steps=int(pd.get("num_steps", 0) or 0),
                            duration_ms=int(pd.get("duration_ms", 0)
                                            or 0))))


class _Requestor(ResourceRequestor):
    def __init__(self, backend: ClusterBackend,
                 am: "ApplicationMaster" = None):
        self.backend = backend
        self.am = am

    def request_containers(self, request: JobContainerRequest) -> None:
        from tony_tpu_torch.cluster.backend import UnsatisfiableRequestError
        try:
            self.backend.request_containers(
                request.num_instances, request.priority, request.memory_mb,
                request.vcores, request.gpus, request.tpus,
                request.node_label, gang=not request.untracked)
        except UnsatisfiableRequestError as e:
            # fail the app NOW, not at the 15-min registration timeout
            # (reference: YARN rejected impossible asks at submission)
            LOG.error("unsatisfiable container request for %s: %s",
                      request.job_name, e)
            if self.am is not None:
                self.am._fail_unsatisfiable(request.job_name, str(e))
            else:
                raise
