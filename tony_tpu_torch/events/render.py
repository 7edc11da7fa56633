"""Human-readable one-liners for every history event type.

The portal's job page and the CLI's diagnose output both need a readable
"what happened" line per event; raw payload JSON stays available but the
summary is what an operator scans. The static-coverage test
(tests/test_logs.py) pins that EVERY EventType in events/schema.py has a
renderer here — adding an event without a summary is a tier-1 failure,
so history never grows entries the operator surfaces can't explain.
"""

from __future__ import annotations

from typing import Any, Callable

from tony_tpu_torch.events.schema import EventType


def _application_inited(p: dict) -> str:
    return (f"application {p.get('application_id', '?')} started on "
            f"{p.get('host', '?')} ({p.get('num_tasks', 0)} tasks)")


def _application_finished(p: dict) -> str:
    failed = p.get("num_failed_tasks", 0)
    tail = f", {failed} failed task(s)" if failed else ""
    return f"application {p.get('application_id', '?')} " \
           f"{p.get('status', '?')}{tail}"


def _task_started(p: dict) -> str:
    return (f"task {p.get('task_type', '?')}:{p.get('task_index', '?')} "
            f"launched on {p.get('host', '?')} "
            f"({p.get('container_id', '') or 'container ?'})")


def _task_finished(p: dict) -> str:
    return (f"task {p.get('task_type', '?')}:{p.get('task_index', '?')} "
            f"finished {p.get('status', '?')}")


def _task_relaunched(p: dict) -> str:
    return (f"task {p.get('task_type', '?')}:{p.get('task_index', '?')} "
            f"relaunched as attempt {p.get('attempt', '?')} at spec "
            f"generation {p.get('generation', '?')}: "
            f"{p.get('reason', '') or 'unspecified'}")


def _serving_endpoint(p: dict) -> str:
    return (f"serving endpoint {p.get('task_type', '?')}:"
            f"{p.get('task_index', '?')} up at {p.get('url', '?')}")


def _serving_migrated(p: dict) -> str:
    n = p.get("count", 1) or 1
    tail = f" ({n} requests)" if n != 1 else ""
    return (f"prefill {p.get('task_type', '?')}:{p.get('task_index', '?')} "
            f"migrated KV to decode at {p.get('target_url', '?')}{tail}")


def _profile_captured(p: dict) -> str:
    return (f"profile {p.get('request_id', '?')} captured on "
            f"{p.get('task_type', '?')}:{p.get('task_index', '?')} "
            f"({p.get('num_steps', 0)} steps) -> {p.get('path', '?')}")


def _slo_violation(p: dict) -> str:
    task = p.get("task_id") or "job"
    return f"SLO violation ({p.get('kind', '?')}) on {task}: " \
           f"{p.get('message', '')}"


def _diagnostics_ready(p: dict) -> str:
    sig = p.get("signature") or "no matched signature"
    who = p.get("first_failing_task") or "unknown task"
    sigdesc = p.get("signal_name") or f"exit {p.get('exit_code', '?')}"
    return (f"root-cause bundle ready: first failure {who} "
            f"(attempt {p.get('attempt', 0)}, {sigdesc}, {sig}; "
            f"{p.get('num_failures', 0)} failure record(s)) -> "
            f"{p.get('path', '?')}")


def _straggler_detected(p: dict) -> str:
    return (f"straggler detected: {p.get('task_type', '?')}:"
            f"{p.get('task_index', '?')} "
            f"({p.get('phase', '?')} via {p.get('signal', '?')}) — "
            f"{p.get('value_ms', 0)} ms vs gang median "
            f"{p.get('gang_median_ms', 0)} ms "
            f"(z={p.get('z_score', 0)}, "
            f"{p.get('windows', 0)} consecutive window(s))")


def _straggler_cleared(p: dict) -> str:
    return (f"straggler cleared: {p.get('task_type', '?')}:"
            f"{p.get('task_index', '?')} "
            f"({p.get('reason', '') or 'recovered'} after "
            f"{p.get('windows_lagging', 0)} lagging window(s))")


def _alert_firing(p: dict) -> str:
    where = p.get("key") or p.get("scope", "job")
    return (f"alert FIRING [{p.get('severity', 'warning')}] "
            f"{p.get('rule_id', '?')} on {where}: "
            f"{p.get('message', '') or 'condition held'} "
            f"(value {p.get('value', 0)} vs threshold "
            f"{p.get('threshold', 0)})")


def _alert_resolved(p: dict) -> str:
    where = p.get("key") or p.get("scope", "job")
    return (f"alert resolved [{p.get('severity', 'warning')}] "
            f"{p.get('rule_id', '?')} on {where} after "
            f"{p.get('active_ms', 0)} ms firing")


def _preemption_requested(p: dict) -> str:
    return (f"preemption requested for "
            f"{p.get('application_id', '?')} by "
            f"{p.get('requested_by', '') or 'operator'} "
            f"({p.get('grace_ms', 0)} ms checkpoint grace): "
            f"{p.get('reason', '') or 'unspecified'}")


def _preempted(p: dict) -> str:
    return (f"application {p.get('application_id', '?')} preempted: "
            f"{p.get('drained_tasks', 0)} task(s) drained gracefully, "
            f"{p.get('killed_tasks', 0)} force-stopped at the deadline "
            f"({p.get('drain_ms', 0)} ms drain) — "
            f"{p.get('reason', '') or 'unspecified'}")


def _resumed(p: dict) -> str:
    return (f"application {p.get('application_id', '?')} resumed from "
            f"preempted {p.get('resumed_from', '?')} after "
            f"{p.get('downtime_ms', 0)} ms downtime "
            f"(gang width {p.get('gang_width', 0)}, "
            f"{p.get('requested_chips', 0)} chips)")


def _autoscale_decision(p: dict) -> str:
    arb = p.get("arbiter_action", "")
    victims = p.get("victims") or []
    tail = ""
    if arb:
        tail = f" [arbiter: {arb}"
        if victims:
            tail += f", victims {', '.join(victims)}"
        tail += "]"
    return (f"autoscale {p.get('direction', '?')}: "
            f"{p.get('job_type', 'serving')} "
            f"{p.get('from_replicas', '?')} -> "
            f"{p.get('to_replicas', '?')} replicas "
            f"({p.get('reason', '') or 'unspecified'}){tail}")


def _rolling_update_started(p: dict) -> str:
    return (f"rolling update to weights generation "
            f"{p.get('generation', '?')} started on "
            f"{p.get('replicas', 0)} serving replica(s) "
            f"(requested by {p.get('requested_by', '') or 'operator'})")


def _rolling_update_completed(p: dict) -> str:
    status = "completed" if p.get("ok", True) else "FAILED"
    tail = f": {p['message']}" if p.get("message") else ""
    return (f"rolling update to weights generation "
            f"{p.get('generation', '?')} {status} — "
            f"{p.get('replicas_updated', 0)} replica(s) updated in "
            f"{p.get('duration_ms', 0)} ms{tail}")


def _resize_requested(p: dict) -> str:
    chips = ""
    if p.get("from_chips") or p.get("to_chips"):
        chips = (f" ({p.get('from_chips', 0)} -> "
                 f"{p.get('to_chips', 0)} chips)")
    return (f"elastic resize requested for "
            f"{p.get('application_id', '?')}: "
            f"{p.get('job_type', '?')} width {p.get('from_width', '?')} "
            f"-> {p.get('to_width', '?')}{chips} by "
            f"{p.get('requested_by', '') or 'operator'} "
            f"({p.get('grace_ms', 0)} ms quiesce grace): "
            f"{p.get('reason', '') or 'unspecified'}")


def _resize_started(p: dict) -> str:
    return (f"elastic resize started: {p.get('job_type', '?')} "
            f"{p.get('from_width', '?')} -> {p.get('to_width', '?')} — "
            f"quiescing {p.get('members', 0)} task(s) for the in-place "
            f"checkpoint")


def _resize_completed(p: dict) -> str:
    delta = ""
    if p.get("added_tasks"):
        delta = f", +{p['added_tasks']} task(s)"
    elif p.get("removed_tasks"):
        delta = f", -{p['removed_tasks']} task(s)"
    return (f"elastic resize completed: {p.get('job_type', '?')} "
            f"{p.get('from_width', '?')} -> {p.get('to_width', '?')} in "
            f"{p.get('duration_ms', 0)} ms{delta} — gang re-rendezvoused "
            f"at the new width")


def _resize_failed(p: dict) -> str:
    tail = (" (rolled back to the old width)" if p.get("rolled_back")
            else "")
    return (f"elastic resize FAILED: {p.get('job_type', '?')} "
            f"{p.get('from_width', '?')} -> {p.get('to_width', '?')} "
            f"after {p.get('duration_ms', 0)} ms{tail}: "
            f"{p.get('reason', '') or 'unspecified'}")


def _am_recovery_started(p: dict) -> str:
    return (f"AM recovery started (process attempt "
            f"{p.get('am_attempt', '?')}) for "
            f"{p.get('application_id', '?')}: replayed "
            f"{p.get('replayed_records', 0)} journal record(s), awaiting "
            f"adoption of {p.get('live_tasks', 0)} live task(s)")


def _am_recovery_completed(p: dict) -> str:
    lost = p.get("lost", 0)
    tail = f", {lost} lost to relaunch" if lost else ""
    return (f"AM recovery completed (process attempt "
            f"{p.get('am_attempt', '?')}): {p.get('adopted', 0)} task(s) "
            f"adopted{tail} in {p.get('duration_ms', 0)} ms "
            f"({p.get('downtime_ms', 0)} ms control-plane downtime, "
            f"{p.get('replayed_records', 0)} record(s) replayed)")


def _process_stall_detected(p: dict) -> str:
    where = p.get("task_id") or p.get("process", "?")
    beacon = f" ({p.get('beacon')} loop)" if p.get("beacon") else ""
    frame = p.get("blocking_frame") or "unknown frame"
    return (f"stall detected on {where}{beacon}: no progress for "
            f"{p.get('stalled_ms', 0)} ms — blocked in {frame}")


def _process_stall_cleared(p: dict) -> str:
    where = p.get("task_id") or p.get("process", "?")
    return (f"stall cleared on {where} "
            f"({p.get('reason', '') or 'recovered'}) after "
            f"{p.get('stalled_ms', 0)} ms")


RENDERERS: dict[EventType, Callable[[dict], str]] = {
    EventType.APPLICATION_INITED: _application_inited,
    EventType.APPLICATION_FINISHED: _application_finished,
    EventType.TASK_STARTED: _task_started,
    EventType.TASK_FINISHED: _task_finished,
    EventType.TASK_RELAUNCHED: _task_relaunched,
    EventType.SERVING_ENDPOINT_REGISTERED: _serving_endpoint,
    EventType.SERVING_MIGRATED: _serving_migrated,
    EventType.PROFILE_CAPTURED: _profile_captured,
    EventType.SLO_VIOLATION: _slo_violation,
    EventType.DIAGNOSTICS_READY: _diagnostics_ready,
    EventType.STRAGGLER_DETECTED: _straggler_detected,
    EventType.STRAGGLER_CLEARED: _straggler_cleared,
    EventType.ALERT_FIRING: _alert_firing,
    EventType.ALERT_RESOLVED: _alert_resolved,
    EventType.PREEMPTION_REQUESTED: _preemption_requested,
    EventType.PREEMPTED: _preempted,
    EventType.RESUMED: _resumed,
    EventType.AUTOSCALE_DECISION: _autoscale_decision,
    EventType.ROLLING_UPDATE_STARTED: _rolling_update_started,
    EventType.ROLLING_UPDATE_COMPLETED: _rolling_update_completed,
    EventType.RESIZE_REQUESTED: _resize_requested,
    EventType.RESIZE_STARTED: _resize_started,
    EventType.RESIZE_COMPLETED: _resize_completed,
    EventType.RESIZE_FAILED: _resize_failed,
    EventType.AM_RECOVERY_STARTED: _am_recovery_started,
    EventType.AM_RECOVERY_COMPLETED: _am_recovery_completed,
    EventType.PROCESS_STALL_DETECTED: _process_stall_detected,
    EventType.PROCESS_STALL_CLEARED: _process_stall_cleared,
}


def render_event(event_type: Any, payload: dict) -> str:
    """One-line summary for an event dict ({"type", "payload"}); unknown
    types degrade to the type name instead of raising — the portal must
    render history written by a newer AM."""
    try:
        etype = EventType(event_type)
    except ValueError:
        return str(event_type)
    renderer = RENDERERS.get(etype)
    if renderer is None:
        return etype.value
    try:
        return renderer(payload or {})
    except Exception:  # noqa: BLE001 — rendering must never break a page
        return etype.value
