"""Event log schema.

The port's copy of `tony_tpu/events/schema.py`: every event serialises
to the JAX package's bytes, so either package reads the other's history.

Equivalent of the reference's Avro union
(tony-core/src/main/avro/{Event,EventType,ApplicationInited,
ApplicationFinished,TaskStarted,TaskFinished,Metric}.avsc) as dataclasses
serialized to JSON lines. The union tag travels as `type`; `payload` holds
the per-type record; `timestamp` is epoch millis, matching the reference's
Event record shape.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field, asdict
from typing import Any, Union


class EventType(str, enum.Enum):
    APPLICATION_INITED = "APPLICATION_INITED"
    APPLICATION_FINISHED = "APPLICATION_FINISHED"
    TASK_STARTED = "TASK_STARTED"
    TASK_FINISHED = "TASK_FINISHED"
    TASK_RELAUNCHED = "TASK_RELAUNCHED"
    SERVING_ENDPOINT_REGISTERED = "SERVING_ENDPOINT_REGISTERED"
    SERVING_MIGRATED = "SERVING_MIGRATED"
    PROFILE_CAPTURED = "PROFILE_CAPTURED"
    SLO_VIOLATION = "SLO_VIOLATION"
    DIAGNOSTICS_READY = "DIAGNOSTICS_READY"
    STRAGGLER_DETECTED = "STRAGGLER_DETECTED"
    STRAGGLER_CLEARED = "STRAGGLER_CLEARED"
    ALERT_FIRING = "ALERT_FIRING"
    ALERT_RESOLVED = "ALERT_RESOLVED"
    PREEMPTION_REQUESTED = "PREEMPTION_REQUESTED"
    PREEMPTED = "PREEMPTED"
    RESUMED = "RESUMED"
    AUTOSCALE_DECISION = "AUTOSCALE_DECISION"
    ROLLING_UPDATE_STARTED = "ROLLING_UPDATE_STARTED"
    ROLLING_UPDATE_COMPLETED = "ROLLING_UPDATE_COMPLETED"
    RESIZE_REQUESTED = "RESIZE_REQUESTED"
    RESIZE_STARTED = "RESIZE_STARTED"
    RESIZE_COMPLETED = "RESIZE_COMPLETED"
    RESIZE_FAILED = "RESIZE_FAILED"
    AM_RECOVERY_STARTED = "AM_RECOVERY_STARTED"
    AM_RECOVERY_COMPLETED = "AM_RECOVERY_COMPLETED"
    PROCESS_STALL_DETECTED = "PROCESS_STALL_DETECTED"
    PROCESS_STALL_CLEARED = "PROCESS_STALL_CLEARED"


@dataclass
class ApplicationInited:
    """reference: ApplicationInited.avsc (appId, numTasks, host, containerId)."""
    application_id: str
    num_tasks: int
    host: str
    container_id: str = ""


@dataclass
class TaskStarted:
    """reference: TaskStarted.avsc (taskType, taskIndex, host)."""
    task_type: str
    task_index: int
    host: str
    container_id: str = ""


@dataclass
class TaskFinished:
    """reference: TaskFinished.avsc (taskType, taskIndex, status, metrics)."""
    task_type: str
    task_index: int
    status: str
    metrics: list[dict] = field(default_factory=list)


@dataclass
class TaskRelaunched:
    """No reference equivalent (the reference's fault model was
    all-or-nothing): records a single-task relaunch — the end of attempt
    `attempt - 1` and the request for a replacement container at cluster-spec
    `generation` — so history shows every attempt of every task slot."""
    task_type: str
    task_index: int
    attempt: int        # the NEW attempt number the replacement runs as
    generation: int     # cluster-spec generation after invalidation
    reason: str = ""


@dataclass
class ServingEndpointRegistered:
    """No reference equivalent (the reference's lifecycle ended at
    training): a `serving` task's HTTP frontend came up and announced its
    endpoint. History carries it so the portal job page can render the
    live URL (through the authenticated proxy when tony.proxy.url is
    configured) long after the AM's in-memory record is gone."""
    task_type: str
    task_index: int
    url: str


@dataclass
class ServingMigrated:
    """Prefill/decode disaggregation hand-off: a prefill-role serving
    replica finished a request's prompt pass and shipped the KV prefix
    + sampler state to a decode-role replica over /v1/migrate. History
    carries it so operators can audit disaggregation traffic (which
    prefill fed which decode, how often) after the fleet is gone."""
    task_type: str
    task_index: int
    target_url: str
    count: int = 1


@dataclass
class ProfileCaptured:
    """No reference equivalent: an on-demand profiler capture
    (request_profile RPC) finished and its trace artifact was linked into
    history under `path` (relative to the job's history dir) — the
    operator workflow that turns the always-on profiler *server* into an
    after-the-fact, remote-container-friendly capture."""
    task_type: str
    task_index: int
    request_id: str
    path: str           # history-dir-relative artifact dir
    num_steps: int = 0
    duration_ms: int = 0


@dataclass
class SloViolation:
    """No reference equivalent: the AM's SLO watchdog observed a
    threshold breach (tony.slo.*) — step-time regression against the
    task's own baseline, or job goodput below the floor. WARNING
    severity: recorded, never acted on."""
    kind: str           # "step_time_regression" | "goodput_floor"
    message: str
    task_id: str = ""   # "" for job-level conditions
    value: float = 0.0
    threshold: float = 0.0


@dataclass
class DiagnosticsReady:
    """No reference equivalent (the reference surfaced a one-line AM
    diagnostics string through YARN): the AM assembled the job's
    root-cause bundle — first-failing task across attempts, exit
    code/signal, matched error signature, redacted tail excerpts — into
    `diagnostics.json` next to the event log. The portal renders it as
    the failure panel; `python -m tony_tpu.cli diagnose` prints it."""
    application_id: str
    first_failing_task: str = ""    # "worker:1"
    attempt: int = 0                # the failing attempt number
    signature: str = ""             # matched error signature ("" = none)
    exit_code: int = 0
    signal_name: str = ""
    num_failures: int = 0           # failure records in the bundle
    path: str = ""                  # history-dir-relative bundle file


@dataclass
class StragglerDetected:
    """No reference equivalent: the AM's cross-task skew analyzer
    (observability/skew.py) latched one task as the gang's straggler —
    its windowed signal exceeded the gang median by tony.straggler.
    threshold-pct for tony.straggler.windows consecutive windows. The
    evidence rides along: which signal, startup vs steady-state phase
    attribution (goodput-ledger phases), z-score against the gang, and
    span ids linking into the lifecycle waterfall."""
    task_type: str
    task_index: int
    attempt: int = 0
    signal: str = ""        # step_time_ms | input_stall_ms | startup_ms
    phase: str = ""         # "startup" | "steady_state"
    value_ms: float = 0.0   # the task's windowed mean
    gang_median_ms: float = 0.0
    z_score: float = 0.0
    windows: int = 0        # consecutive lagging windows at latch time
    span_ids: list[str] = field(default_factory=list)


@dataclass
class StragglerCleared:
    """The straggler latch for a task released: the task recovered
    (windowed signal back within the gang band for tony.straggler.windows
    consecutive windows) or the remediation hook relaunched it."""
    task_type: str
    task_index: int
    reason: str = ""        # "recovered" | "relaunched"
    windows_lagging: int = 0


@dataclass
class AlertFiring:
    """No reference equivalent: the alert engine
    (observability/alerts.py) escalated one rule's pending condition to
    firing — the condition held for the rule's `for`-duration. The
    evidence travels with the event: observed value vs threshold, the
    scope key (task id / queue / job), and severity. The matching
    ALERT_RESOLVED shares the (rule_id, key) identity."""
    rule_id: str            # e.g. "train.step_time_regression"
    key: str = ""           # scope instance, e.g. "worker:3" or "queue:prod"
    severity: str = "warning"   # info | warning | critical | page
    scope: str = "job"      # job | task | queue | fleet
    value: float = 0.0
    threshold: float = 0.0
    message: str = ""
    for_ms: int = 0         # how long the condition held before firing


@dataclass
class AlertResolved:
    """The firing alert's condition went false: the (rule_id, key)
    instance resolved. `active_ms` is how long it was firing."""
    rule_id: str
    key: str = ""
    severity: str = "warning"
    scope: str = "job"
    active_ms: int = 0
    message: str = ""


@dataclass
class PreemptionRequested:
    """No reference equivalent (the reference inherited preemption from
    YARN's capacity scheduler, invisible to TonY itself): the admission
    arbiter (cluster/arbiter.py) or an operator asked this application
    to checkpoint-then-evict. The drain ask rides task heartbeats from
    here on; `grace_ms` is how long tasks get to emergency-checkpoint
    before containers are force-stopped."""
    application_id: str
    reason: str = ""
    grace_ms: int = 0
    requested_by: str = ""      # "arbiter" | "operator" | "test"


@dataclass
class Preempted:
    """The drain completed: every tracked task stopped and the
    application left the pool in state PREEMPTED (a terminal state that
    is neither FAILED nor KILLED — it is expected to resume from its
    checkpoint). `drained_tasks` exited through the graceful path
    within the grace window; `killed_tasks` had to be force-stopped at
    the deadline."""
    application_id: str
    reason: str = ""
    drained_tasks: int = 0
    killed_tasks: int = 0
    drain_ms: int = 0           # request → last task stopped


@dataclass
class Resumed:
    """A preempted application was re-admitted and restarted from its
    latest checkpoint — possibly at a different gang width (the
    resharding restore maps the saved shards onto the new mesh).
    `downtime_ms` is the eviction→resume gap the goodput ledger prices
    as preemption_downtime_s."""
    application_id: str
    resumed_from: str = ""      # the PREEMPTED predecessor's app id
    downtime_ms: int = 0
    gang_width: int = 0
    requested_chips: int = 0


@dataclass
class AutoscaleDecision:
    """No reference equivalent: the AM's serving-fleet autoscaler
    (serve/autoscaler.py) converted the burn-rate SLIs into a replica
    action. The SLI evidence and the admission arbiter's verdict travel
    with the event — a scale-up's chip ask goes THROUGH the arbiter
    (cluster/arbiter.py), so `arbiter_action` records whether it fit
    whole (admit), required checkpoint-then-evicting the `victims`
    (preempt), or waits (queue); scale-down returns chips to the pool
    and carries no arbiter verdict."""
    job_type: str               # the scaled jobtype ("serving")
    direction: str              # "up" | "down"
    from_replicas: int
    to_replicas: int
    chips: int = 0              # one replica's chip ask (up only)
    arbiter_action: str = ""    # admit | preempt | queue ("" for down)
    victims: list[str] = field(default_factory=list)
    reason: str = ""
    ttft_p95_s: float = 0.0
    queue_depth: float = 0.0
    reject_rate_pct: float = 0.0
    occupancy_pct: float = 0.0
    role: str = ""              # disaggregation pool ("" = whole fleet)


@dataclass
class RollingUpdateStarted:
    """No reference equivalent: a zero-downtime rolling weight update
    began — serving replicas are cycled one at a time (drain old →
    relaunch → wait healthy) so the fleet never drops below N-1
    capacity and no in-flight request is cut. `generation` is the
    weights epoch the updated replicas will serve."""
    application_id: str
    generation: int
    replicas: int               # serving replicas in the rollout set
    requested_by: str = ""


@dataclass
class RollingUpdateCompleted:
    """The rollout finished (ok) or was abandoned (a replacement never
    came healthy inside the window). `replicas_updated` made it to the
    new generation either way."""
    application_id: str
    generation: int
    replicas_updated: int = 0
    ok: bool = True
    duration_ms: int = 0
    message: str = ""


@dataclass
class ResizeRequested:
    """No reference equivalent (the reference's gang width was frozen at
    submit): an elastic resize was asked of a RUNNING gang — by the
    admission arbiter (idle-chip offer / reclaim-instead-of-evict), an
    operator (`cli resize` → request_resize RPC), or a test hook. The
    gang will quiesce, emergency-checkpoint in place, re-render its
    cluster spec at the new width behind a generation bump, and
    reshard-restore — no eviction, no resubmit."""
    application_id: str
    job_type: str               # the elastic jobtype being resized
    from_width: int             # task instances before
    to_width: int               # task instances after
    from_chips: int = 0         # summed chips before (width x tpus/task)
    to_chips: int = 0
    reason: str = ""
    requested_by: str = ""      # "arbiter" | "operator" | "test"
    grace_ms: int = 0           # quiesce window


@dataclass
class ResizeStarted:
    """The resize state machine left IDLE: the quiesce ask is riding
    every member's heartbeat from here on — user processes TERM,
    trainers commit the in-place emergency checkpoint, and executors
    hold at the re-rendezvous barrier (containers stay alive)."""
    application_id: str
    job_type: str
    from_width: int
    to_width: int
    members: int = 0            # tasks being quiesced (whole gang)


@dataclass
class ResizeCompleted:
    """The gang re-rendezvoused at the new width: membership changed
    (tasks added/removed, or per-task chips re-meshed), the generation-
    bumped spec propagated via heartbeat diffs, and training resumed
    from the quiesce checkpoint. `duration_ms` is the resize round-trip
    (request → barrier re-closed) the goodput ledger prices as the
    `resize` phase."""
    application_id: str
    job_type: str
    from_width: int
    to_width: int
    duration_ms: int = 0
    added_tasks: int = 0
    removed_tasks: int = 0


@dataclass
class ResizeFailed:
    """The resize did not complete: the quiesce window expired, a grow's
    new containers never registered inside the window (rolled_back=True:
    the added slots were abandoned and the gang settled back at the old
    width — mirroring the autoscaler's abandoned scale-up), or
    validation failed mid-flight. The application itself keeps running
    either way — a resize is never allowed to fail the app."""
    application_id: str
    job_type: str
    from_width: int
    to_width: int
    reason: str = ""
    rolled_back: bool = False
    duration_ms: int = 0


@dataclass
class AmRecoveryStarted:
    """No reference equivalent in the event log (the reference's AM
    retry was visible only as a YARN attempt counter): a supervised AM
    relaunch (am/supervisor.py) or a thawed hang replayed the
    control-plane journal (am/journal.py) and entered RECOVERING — the
    gang's user processes are still running, orphaned executors are
    polling the staging dir for the new address, and the AM now gates
    RUNNING on the adoption barrier (`live_tasks` re-registrations or
    the tony.am.recovery-settle-ms deadline)."""
    application_id: str
    am_attempt: int             # the recovering AM PROCESS attempt
    live_tasks: int = 0         # journaled live tasks awaiting adoption
    replayed_records: int = 0   # journal records folded into the session
    journal_path: str = ""


@dataclass
class AmRecoveryCompleted:
    """The adoption barrier closed: every journaled live task
    re-registered attempt-fenced (`adopted`) or missed the settle
    deadline and was relaunched through the normal budget (`lost`).
    `downtime_ms` — last journal record before the crash → barrier
    closed — is what the goodput ledger prices as the `am_downtime`
    phase against goodput_pct."""
    application_id: str
    am_attempt: int
    adopted: int = 0
    lost: int = 0
    replayed_records: int = 0
    duration_ms: int = 0        # recovery start → barrier closed
    downtime_ms: int = 0        # crash (last journal stamp) → barrier closed
    span_ids: list[str] = field(default_factory=list)


@dataclass
class ProcessStallDetected:
    """No reference equivalent: the stall watchdog
    (observability/profiler.py) latched a wedge — a control-plane
    process (or one of its registered daemon loops) stopped making
    progress while staying alive, or a liveliness-expired executor
    answered a stack pull proving it is blocked rather than dead. The
    evidence travels with the event: which process/beacon, how long past
    its cadence, and the dominant blocking frame ("stuck in
    LocalizationCache.materialize", not "stuck")."""
    process: str                # "am", "executor:worker:1", "router", ...
    beacon: str = ""            # stale loop's beacon ("" = whole process)
    thread_name: str = ""
    stalled_ms: float = 0.0
    cadence_ms: float = 0.0
    blocking_frame: str = ""    # leaf frame of the wedged thread
    task_id: str = ""           # set when the stall is a remote task's
    attempt: int = 0


@dataclass
class ProcessStallCleared:
    """The latched stall released: the beacon beat again, the wedged
    task's slot was relaunched, or the application tore down (a stall
    report must never dangle un-cleared in history)."""
    process: str
    beacon: str = ""
    stalled_ms: float = 0.0
    blocking_frame: str = ""
    task_id: str = ""
    attempt: int = 0
    reason: str = ""            # "recovered" | "relaunched" | "teardown"


@dataclass
class ApplicationFinished:
    """reference: ApplicationFinished.avsc (appId, status, failed tasks, metrics)."""
    application_id: str
    status: str
    num_failed_tasks: int = 0
    metrics: list[dict] = field(default_factory=list)


_PAYLOADS = {
    EventType.APPLICATION_INITED: ApplicationInited,
    EventType.APPLICATION_FINISHED: ApplicationFinished,
    EventType.TASK_STARTED: TaskStarted,
    EventType.TASK_FINISHED: TaskFinished,
    EventType.TASK_RELAUNCHED: TaskRelaunched,
    EventType.SERVING_ENDPOINT_REGISTERED: ServingEndpointRegistered,
    EventType.SERVING_MIGRATED: ServingMigrated,
    EventType.PROFILE_CAPTURED: ProfileCaptured,
    EventType.SLO_VIOLATION: SloViolation,
    EventType.DIAGNOSTICS_READY: DiagnosticsReady,
    EventType.STRAGGLER_DETECTED: StragglerDetected,
    EventType.STRAGGLER_CLEARED: StragglerCleared,
    EventType.ALERT_FIRING: AlertFiring,
    EventType.ALERT_RESOLVED: AlertResolved,
    EventType.PREEMPTION_REQUESTED: PreemptionRequested,
    EventType.PREEMPTED: Preempted,
    EventType.RESUMED: Resumed,
    EventType.AUTOSCALE_DECISION: AutoscaleDecision,
    EventType.ROLLING_UPDATE_STARTED: RollingUpdateStarted,
    EventType.ROLLING_UPDATE_COMPLETED: RollingUpdateCompleted,
    EventType.RESIZE_REQUESTED: ResizeRequested,
    EventType.RESIZE_STARTED: ResizeStarted,
    EventType.RESIZE_COMPLETED: ResizeCompleted,
    EventType.RESIZE_FAILED: ResizeFailed,
    EventType.AM_RECOVERY_STARTED: AmRecoveryStarted,
    EventType.AM_RECOVERY_COMPLETED: AmRecoveryCompleted,
    EventType.PROCESS_STALL_DETECTED: ProcessStallDetected,
    EventType.PROCESS_STALL_CLEARED: ProcessStallCleared,
}

Payload = Union[ApplicationInited, ApplicationFinished, TaskStarted,
                TaskFinished, TaskRelaunched, ServingEndpointRegistered,
                ServingMigrated,
                ProfileCaptured, SloViolation, DiagnosticsReady,
                StragglerDetected, StragglerCleared, AlertFiring,
                AlertResolved, PreemptionRequested, Preempted, Resumed,
                AutoscaleDecision, RollingUpdateStarted,
                RollingUpdateCompleted, ResizeRequested, ResizeStarted,
                ResizeCompleted, ResizeFailed, AmRecoveryStarted,
                AmRecoveryCompleted, ProcessStallDetected,
                ProcessStallCleared]


@dataclass
class Event:
    type: EventType
    payload: Payload
    timestamp: int = 0  # epoch ms; 0 = stamp at construction

    def __post_init__(self):
        if self.timestamp == 0:
            self.timestamp = int(time.time() * 1000)

    def to_dict(self) -> dict[str, Any]:
        return {"type": self.type.value, "payload": asdict(self.payload),
                "timestamp": self.timestamp}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Event":
        etype = EventType(d["type"])
        payload = _PAYLOADS[etype](**d["payload"])
        return cls(type=etype, payload=payload, timestamp=int(d["timestamp"]))
