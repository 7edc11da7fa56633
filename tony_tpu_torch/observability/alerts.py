"""Rule-driven alerting: burn-rate SLOs, lifecycle, sinks, incident timelines.

The port's copy of `tony_tpu/observability/alerts.py`. The dashboards
render; nothing else *pages*. The two-rule `SloWatchdog` is
training-only, with no delivery path and no history. This module is the
layer between "rendered" and "noticed", for operators running many jobs
they are not watching (the TonY production story, arxiv 1904.01631):

- **Rule model** (`AlertRule`): a declarative condition evaluated over
  the *existing* signals — MetricsStore gauge trajectories, the goodput
  ledger, the fleet registry. No new collection; rules run only on the
  AM monitor cadence (job/task scope) and the portal's fleet-scan
  cadence (queue/fleet scope), so the trainer hot loop never pays for
  alerting.
- **Built-in rules** (`BUILTIN_RULES`): training (step-time regression —
  attempt-aware, subsuming the legacy `tony.slo.*` checks — goodput
  floor, MFU floor), serving (TTFT p95, queue depth, 429/reject rate —
  all via multi-window **burn-rate** evaluation against an error
  budget), and fleet (queue-quota saturation, job LOST, chips idle
  while a gang queues). Custom rules come from `tony.alerts.rules`
  compact specs.
- **Lifecycle** (`AlertEngine`): pending → firing → resolved per
  (rule, scope-key) with dedup, per-rule latching, a `for`-duration
  before firing, flap suppression after a resolve, and a bounded
  transition log flushed to `alerts.json` in history + staging.
- **Sinks**: webhook POST (bounded retry on a daemon delivery worker —
  the monitor thread never blocks) and an append-only JSON-lines file.
  Every outbound payload passes through `logs.redact()` field-wise, so
  an annotation holding credential-shaped material can never leave the
  process intact.
- **Incident timeline** (`build_incident_timeline`): alerts correlated
  with history events, straggler detections, SLO violations, and the
  diagnostics bundle into one ordered story with span links — the
  portal job page's "what happened, in order" panel and the
  `cli alerts` offline renderer.

Pure stdlib, import-light: the AM and the portal load it on their
control paths.
"""

from __future__ import annotations

import json
import logging
import operator
import queue
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

LOG = logging.getLogger(__name__)

SEVERITIES = ("info", "warning", "critical", "page")
SCOPES = ("job", "task", "queue", "fleet")

# implied error budget for gauge-ceiling SLOs (TTFT p95, queue depth):
# the ceiling may be exceeded at most this fraction of the time. The
# reject-rate rule takes its budget from conf instead (it is a true
# request-ratio SLO).
GAUGE_SLO_BUDGET = 0.01


# ---------------------------------------------------------------------------
# evaluation context
# ---------------------------------------------------------------------------

class AlertContext:
    """The snapshot one evaluation pass reads. Built by the AM (job/task
    scope: gauges + trajectories + goodput) or the portal's FleetView
    (fleet scope: registry jobs + quotas). Everything is optional so
    rules degrade to 'no observation' instead of raising."""

    def __init__(self, now_ms: Optional[int] = None,
                 gauges: Optional[dict[str, dict[str, float]]] = None,
                 history_fn: Optional[Callable[[str], dict[str, list]]]
                 = None,
                 attempts: Optional[dict[str, int]] = None,
                 job: Optional[dict] = None,
                 fleet: Optional[dict] = None):
        self.now_ms = int(now_ms if now_ms is not None
                          else time.time() * 1000)
        self.gauges = gauges or {}
        self._history_fn = history_fn
        self.attempts = attempts or {}
        self.job = job or {}
        # {"jobs": [jobstate summaries], "queues": {name: max_tpus}}
        self.fleet = fleet or {}

    def history(self, metric: str) -> dict[str, list]:
        """{task_id: [[ts_ms, value], ...]} for one metric (empty
        without a trajectory source)."""
        if self._history_fn is None:
            return {}
        try:
            return self._history_fn(metric) or {}
        except Exception:  # noqa: BLE001 — a rule must not kill the pass
            LOG.exception("history read failed for %s", metric)
            return {}


# ---------------------------------------------------------------------------
# rule model
# ---------------------------------------------------------------------------

@dataclass
class AlertRule:
    """One declarative rule. `evaluate(ctx)` returns the instances whose
    condition is CURRENTLY true as observation dicts
    ``{"key", "value", "threshold", "message", "annotations"?}`` — the
    engine owns all lifecycle state (pending/for-duration/firing/
    resolved/flap), so evaluators stay pure condition checks."""
    rule_id: str
    evaluate: Callable[[AlertContext], list]
    severity: str = "warning"
    scope: str = "job"
    for_ms: int = -1        # -1 = inherit the engine default
    description: str = ""


_OPS = {">": operator.gt, ">=": operator.ge,
        "<": operator.lt, "<=": operator.le}


def threshold_rule(rule_id: str, metric: str, op: str, threshold: float,
                   *, scope: str = "task", severity: str = "warning",
                   for_ms: int = -1, description: str = "") -> AlertRule:
    """Latest-gauge comparison rule. scope=task compares every task
    slot's latest value of `metric`; scope=job compares the job-level
    value of the same (lower-cased) name in ctx.job."""
    cmp = _OPS[op]

    def evaluate(ctx: AlertContext) -> list:
        obs = []
        if scope == "job":
            value = ctx.job.get(metric) \
                if metric in ctx.job else ctx.job.get(metric.lower())
            if isinstance(value, (int, float)) and cmp(value, threshold):
                obs.append({"key": "job", "value": round(float(value), 4),
                            "threshold": threshold,
                            "message": f"{metric} {value} {op} "
                                       f"{threshold}"})
            return obs
        for task_id, gauges in sorted(ctx.gauges.items()):
            value = gauges.get(metric)
            if isinstance(value, (int, float)) and cmp(value, threshold):
                obs.append({"key": task_id,
                            "value": round(float(value), 4),
                            "threshold": threshold,
                            "message": f"{metric} {value} {op} "
                                       f"{threshold} on {task_id}"})
        return obs

    return AlertRule(rule_id, evaluate, severity=severity, scope=scope,
                     for_ms=for_ms, description=description
                     or f"{metric} {op} {threshold}")


# -- burn-rate math (held to the JAX package's, tests/test_torch_alerts.py)

def counter_window_delta(points: list, now_ms: int,
                         window_ms: int) -> float:
    """Increase of a cumulative counter over the trailing window.
    `points` is an ascending ``[[ts_ms, value], ...]`` series. The
    baseline is the latest sample at or before the window start (so a
    window that opens between samples reads the counter as it stood),
    falling back to the earliest sample when the series is younger than
    the window. Negative deltas (counter reset) clamp to 0."""
    if not points:
        return 0.0
    start = now_ms - window_ms
    baseline = None
    for ts, value in points:
        if ts <= start:
            baseline = float(value)
        else:
            break
    if baseline is None:
        baseline = float(points[0][1])
    return max(0.0, float(points[-1][1]) - baseline)


def gauge_exceed_fraction(points: list, now_ms: int, window_ms: int,
                          threshold: float) -> float:
    """Fraction of samples in the trailing window strictly above
    `threshold` — the bad-minutes fraction of a gauge-ceiling SLO.
    0.0 when the window holds no samples."""
    start = now_ms - window_ms
    total = bad = 0
    for ts, value in points or ():
        if ts < start or ts > now_ms:
            continue
        total += 1
        if float(value) > threshold:
            bad += 1
    return bad / total if total else 0.0


def burn_rate(bad_fraction: float, budget_fraction: float) -> float:
    """How fast the error budget burns: 1.0 = exactly on budget over the
    window, N = the budget would be gone in 1/N of the SLO period."""
    if budget_fraction <= 0:
        return 0.0
    return bad_fraction / budget_fraction


def gauge_burn_rule(rule_id: str, metric: str, threshold: float, *,
                    fast_ms: int, slow_ms: int, factor: float,
                    budget_fraction: float = GAUGE_SLO_BUDGET,
                    severity: str = "critical", for_ms: int = -1,
                    description: str = "") -> AlertRule:
    """Multi-window burn-rate rule over a gauge ceiling: the fraction of
    window samples above `threshold` must burn the budget at >= `factor`
    in BOTH the fast and the slow trailing window — fast catches the
    cliff, slow filters the blip."""

    def evaluate(ctx: AlertContext) -> list:
        obs = []
        for task_id, points in sorted(ctx.history(metric).items()):
            frac_fast = gauge_exceed_fraction(points, ctx.now_ms, fast_ms,
                                              threshold)
            frac_slow = gauge_exceed_fraction(points, ctx.now_ms, slow_ms,
                                              threshold)
            bf = burn_rate(frac_fast, budget_fraction)
            bs = burn_rate(frac_slow, budget_fraction)
            if bf >= factor and bs >= factor:
                obs.append({
                    "key": task_id, "value": round(bf, 3),
                    "threshold": factor,
                    "message": (f"{metric} > {threshold} burning "
                                f"{bf:.1f}x budget (fast) / {bs:.1f}x "
                                f"(slow) on {task_id}"),
                    "annotations": {"burn_fast": round(bf, 3),
                                    "burn_slow": round(bs, 3),
                                    "bad_fraction_fast": round(frac_fast,
                                                               4)},
                })
        return obs

    return AlertRule(rule_id, evaluate, severity=severity, scope="task",
                     for_ms=for_ms, description=description
                     or f"burn-rate over {metric} > {threshold}")


def ratio_burn_rule(rule_id: str, bad_metric: str, ok_metric: str, *,
                    budget_fraction: float, fast_ms: int, slow_ms: int,
                    factor: float, severity: str = "critical",
                    for_ms: int = -1,
                    description: str = "") -> AlertRule:
    """Multi-window burn-rate rule over two cumulative counters (the
    429/reject-rate SLO: bad = rejected, ok = admitted). The window's
    bad-fraction is Δbad / (Δbad + Δok)."""

    def evaluate(ctx: AlertContext) -> list:
        bad_series = ctx.history(bad_metric)
        ok_series = ctx.history(ok_metric)
        obs = []
        for task_id in sorted(set(bad_series) & set(ok_series)):
            fractions = []
            for window_ms in (fast_ms, slow_ms):
                d_bad = counter_window_delta(bad_series[task_id],
                                             ctx.now_ms, window_ms)
                d_total = d_bad + counter_window_delta(
                    ok_series[task_id], ctx.now_ms, window_ms)
                fractions.append(d_bad / d_total if d_total > 0 else 0.0)
            bf = burn_rate(fractions[0], budget_fraction)
            bs = burn_rate(fractions[1], budget_fraction)
            if bf >= factor and bs >= factor:
                obs.append({
                    "key": task_id, "value": round(bf, 3),
                    "threshold": factor,
                    "message": (f"reject ratio "
                                f"{fractions[0] * 100:.2f}% burning "
                                f"{bf:.1f}x budget (fast) / {bs:.1f}x "
                                f"(slow) on {task_id}"),
                    "annotations": {"burn_fast": round(bf, 3),
                                    "burn_slow": round(bs, 3),
                                    "bad_fraction_fast":
                                        round(fractions[0], 4)},
                })
        return obs

    return AlertRule(rule_id, evaluate, severity=severity, scope="task",
                     for_ms=for_ms, description=description
                     or f"burn-rate over {bad_metric} vs {ok_metric}")


# -- training rules ---------------------------------------------------------

def step_regression_rule(regression_pct: float, *, severity="warning",
                         for_ms: int = -1) -> AlertRule:
    """Step-time regression against each task's own per-attempt baseline
    — the engine's subsumption of the legacy SloWatchdog check, carrying
    the attempt-aware baseline fix (a relaunched attempt's recompile
    steps reset the baseline instead of tripping the latch)."""
    from tony_tpu_torch.observability.perf import SloWatchdog
    dog = SloWatchdog(step_regression_pct=regression_pct)

    def evaluate(ctx: AlertContext) -> list:
        series = ctx.history("TRAIN_STEP_TIME_MS")
        obs = []
        for v in dog.current_step_regressions(series,
                                              attempts=ctx.attempts):
            obs.append({"key": v["task_id"], "value": v["value"],
                        "threshold": v["threshold"],
                        "message": v["message"]})
        return obs

    return AlertRule("train.step_time_regression", evaluate,
                     severity=severity, scope="task", for_ms=for_ms,
                     description=f"TRAIN_STEP_TIME_MS above the task's "
                                 f"per-attempt baseline by more than "
                                 f"{regression_pct:.0f}%")


def goodput_floor_rule(floor_pct: float, *, severity="warning",
                       for_ms: int = -1) -> AlertRule:
    def evaluate(ctx: AlertContext) -> list:
        value = ctx.job.get("goodput_pct")
        if isinstance(value, (int, float)) and value < floor_pct:
            return [{"key": "job", "value": round(float(value), 3),
                     "threshold": floor_pct,
                     "message": f"job goodput {value:.1f}% below the "
                                f"{floor_pct:.0f}% floor"}]
        return []

    return AlertRule("train.goodput_floor", evaluate, severity=severity,
                     scope="job", for_ms=for_ms,
                     description=f"job goodput below {floor_pct:.0f}%")


def mfu_floor_rule(floor_pct: float, *, severity="warning",
                   for_ms: int = -1) -> AlertRule:
    def evaluate(ctx: AlertContext) -> list:
        value = ctx.job.get("mfu_pct")
        if isinstance(value, (int, float)) and value < floor_pct:
            return [{"key": "job", "value": round(float(value), 3),
                     "threshold": floor_pct,
                     "message": f"mean task MFU {value:.2f}% below the "
                                f"{floor_pct:.0f}% floor"}]
        return []

    return AlertRule("train.mfu_floor", evaluate, severity=severity,
                     scope="job", for_ms=for_ms,
                     description=f"mean MFU below {floor_pct:.0f}%")


# -- fleet rules ------------------------------------------------------------

def queue_quota_rule(saturation_pct: float, *, severity="warning",
                     for_ms: int = -1) -> AlertRule:
    def evaluate(ctx: AlertContext) -> list:
        from tony_tpu_torch.observability.fleet import quota_utilization
        jobs = [j for j in ctx.fleet.get("jobs", [])
                if j.get("state") == "RUNNING"]
        util = quota_utilization(ctx.fleet.get("queues", {}), jobs)
        obs = []
        for q in sorted(util):
            pct = util[q].get("utilization_pct")
            if pct is not None and pct >= saturation_pct:
                obs.append({"key": f"queue:{q}", "value": round(pct, 2),
                            "threshold": saturation_pct,
                            "message": f"queue {q} at {pct:.0f}% of its "
                                       f"TPU quota "
                                       f"({util[q]['chips_in_use']}/"
                                       f"{util[q]['max_tpus']} chips)"})
        return obs

    return AlertRule("fleet.queue_quota_saturated", evaluate,
                     severity=severity, scope="queue", for_ms=for_ms,
                     description=f"queue quota utilization >= "
                                 f"{saturation_pct:.0f}%")


def job_lost_rule(*, severity="critical", for_ms: int = 0) -> AlertRule:
    def evaluate(ctx: AlertContext) -> list:
        obs = []
        for j in ctx.fleet.get("jobs", []):
            if j.get("state") == "LOST":
                app = str(j.get("app_id", "?"))
                obs.append({"key": f"job:{app}", "value": 1.0,
                            "threshold": 1.0,
                            "message": f"job {app} went LOST (AM "
                                       f"heartbeat stale; queue "
                                       f"{j.get('queue', '?')}, "
                                       f"{j.get('gang_width', 0)} "
                                       f"tasks)"})
        return obs

    return AlertRule("fleet.job_lost", evaluate, severity=severity,
                     scope="fleet", for_ms=for_ms,
                     description="registry entry demoted to LOST")


def idle_chips_rule(*, severity="warning", for_ms: int = -1) -> AlertRule:
    """A RUNNING job holding a chip ask with zero allocation while its
    queue still has quota headroom: a gang is queued while chips idle —
    the placement/arbitration smell the arbiter's offer loop
    (`cluster/arbiter.py`) exists to fix."""

    def evaluate(ctx: AlertContext) -> list:
        from tony_tpu_torch.cluster.elastic import find_widenable
        from tony_tpu_torch.observability.fleet import quota_utilization
        jobs = [j for j in ctx.fleet.get("jobs", [])
                if j.get("state") == "RUNNING"]
        util = quota_utilization(ctx.fleet.get("queues", {}), jobs)
        # the arbiter's offer loop acts on the PAYLOAD: which elastic
        # job could absorb the idle chips, and how many there are —
        # computed once per pass, not per queued job
        widenable = find_widenable(jobs)
        obs = []
        for j in jobs:
            requested = int(j.get("requested_chips", 0) or 0)
            allocated = int(j.get("allocated_chips", 0) or 0)
            if requested <= 0 or allocated > 0:
                continue
            q = str(j.get("queue", "default") or "default")
            bucket = util.get(q, {})
            cap = int(bucket.get("max_tpus", 0) or 0)
            used = int(bucket.get("chips_in_use", 0) or 0)
            if cap and used >= cap:
                continue        # the queue genuinely has no headroom
            idle = max(0, cap - used) if cap else requested
            app = str(j.get("app_id", "?"))
            annotations = {"idle_chips": idle, "queue": q}
            candidate = next(
                (w for w in widenable if w.get("app_id") != app), None)
            widen_note = ""
            if candidate is not None:
                annotations["widenable_job"] = str(
                    candidate.get("app_id", ""))
                annotations["widenable_jobtype"] = str(
                    candidate.get("elastic_job", ""))
                annotations["widenable_width"] = int(
                    candidate.get("gang_width", 0) or 0)
                annotations["widenable_max_width"] = int(
                    candidate.get("elastic_max_width", 0) or 0)
                widen_note = (f"; elastic job "
                              f"{annotations['widenable_job']} could "
                              f"widen to absorb them")
            obs.append({"key": f"job:{app}", "value": float(requested),
                        "threshold": 0.0,
                        "annotations": annotations,
                        "message": f"job {app} has waited for "
                                   f"{requested} chip(s) with none "
                                   f"allocated while queue {q} has "
                                   f"{idle} idle chip(s) of headroom"
                                   f"{widen_note}"})
        return obs

    return AlertRule("fleet.chips_idle_while_queued", evaluate,
                     severity=severity, scope="fleet", for_ms=for_ms,
                     description="gang queued with zero allocated chips "
                                 "while its queue has quota headroom")


# ---------------------------------------------------------------------------
# custom-rule spec parsing (tony.alerts.rules)
# ---------------------------------------------------------------------------

_SPEC_RE = re.compile(
    r"^(?P<id>[A-Za-z][A-Za-z0-9_.\-]*):"
    r"(?P<metric>[A-Za-z][A-Za-z0-9_]*)"
    r"(?P<op>>=|<=|>|<)"
    r"(?P<thr>-?\d+(?:\.\d+)?)"
    r"(?P<rest>(?::[a-z]+=[A-Za-z0-9_.\-]+)*)$")

_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h)?$")
_DUR_SCALE = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, None: 1}


def parse_duration_ms(text: str) -> int:
    m = _DUR_RE.match(text.strip())
    if m is None:
        raise ValueError(f"bad duration {text!r} (want e.g. 500ms, 30s, 5m)")
    return int(float(m.group(1)) * _DUR_SCALE[m.group(2)])


def parse_rule_spec(spec: str) -> AlertRule:
    """One `tony.alerts.rules` entry:
    ``<id>:<METRIC><op><threshold>[:for=<dur>][:severity=<sev>]
    [:scope=task|job]``. Raises ValueError with the offending spec so a
    conf typo fails at engine build, not silently at runtime."""
    m = _SPEC_RE.match(spec.strip())
    if m is None:
        raise ValueError(f"unparseable alert rule spec {spec!r}")
    opts = {"severity": "warning", "scope": "task", "for_ms": -1}
    for part in (m.group("rest") or "").split(":"):
        if not part:
            continue
        key, _, value = part.partition("=")
        if key == "for":
            opts["for_ms"] = parse_duration_ms(value)
        elif key == "severity":
            if value not in SEVERITIES:
                raise ValueError(f"bad severity {value!r} in {spec!r}")
            opts["severity"] = value
        elif key == "scope":
            if value not in ("task", "job"):
                raise ValueError(f"bad scope {value!r} in {spec!r} "
                                 "(custom rules: task|job)")
            opts["scope"] = value
        else:
            raise ValueError(f"unknown option {key!r} in {spec!r}")
    return threshold_rule(m.group("id"), m.group("metric"), m.group("op"),
                          float(m.group("thr")), scope=opts["scope"],
                          severity=opts["severity"],
                          for_ms=opts["for_ms"],
                          description=f"custom: {spec.strip()}")


# ---------------------------------------------------------------------------
# redaction + delivery sinks
# ---------------------------------------------------------------------------

def redact_payload(obj):
    """logs.redact() applied to every string field, recursively — the
    payload stays valid JSON and keeps its shape, but credential-shaped
    material (64-hex tokens, Bearer headers, secret assignments) never
    survives into a sink."""
    from tony_tpu_torch.observability.logs import redact
    if isinstance(obj, str):
        return redact(obj)
    if isinstance(obj, dict):
        return {k: redact_payload(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [redact_payload(v) for v in obj]
    return obj


class FileSink:
    """Append-only JSON-lines delivery target (one transition per line).
    The caller hands already-redacted payloads; writes are best-effort —
    alerting must never take the control plane down."""

    name = "file"

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def deliver(self, payload: dict) -> bool:
        try:
            # defense in depth: the engine redacts before enqueue, but the
            # sink is the egress boundary — re-redacting is idempotent and
            # keeps the invariant local
            line = json.dumps(redact_payload(payload), sort_keys=True)
            with self._lock, open(self.path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
            return True
        except OSError:
            LOG.warning("alert file sink write failed (%s)", self.path,
                        exc_info=True)
            return False


class WebhookSink:
    """POST each transition as JSON to a webhook URL with bounded retry
    (attempts = retries + 1, short backoff) then give up — total worst
    case is attempts x (timeout + backoff), pinned by a test. Runs on
    the engine's delivery worker, never the monitor thread."""

    name = "webhook"

    def __init__(self, url: str, timeout_s: float = 2.0,
                 retries: int = 2, backoff_s: float = 0.2):
        self.url = url
        self.timeout_s = max(0.05, float(timeout_s))
        self.retries = max(0, int(retries))
        self.backoff_s = max(0.0, float(backoff_s))

    def deliver(self, payload: dict) -> bool:
        import urllib.request
        # defense in depth at the egress boundary (see FileSink.deliver)
        data = json.dumps(redact_payload(payload),
                          sort_keys=True).encode("utf-8")
        for attempt in range(self.retries + 1):
            try:
                req = urllib.request.Request(
                    self.url, data=data,
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    return True
            except Exception:  # noqa: BLE001 — retry, then give up
                if attempt < self.retries:
                    time.sleep(self.backoff_s)
        LOG.warning("alert webhook delivery to %s gave up after %d "
                    "attempt(s)", self.url, self.retries + 1)
        return False


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class AlertEngine:
    """Lifecycle state machine over a rule set.

    `evaluate(ctx)` runs every rule, advances per-(rule, key) state
    (inactive → pending → firing → resolved), returns the transitions of
    this pass, appends them to the bounded log, and enqueues the
    non-suppressed ones for sink delivery on a daemon worker. One state
    per (rule, key) is the dedup guarantee; a resolve followed by a
    re-fire inside `flap_suppress_ms` is a flap — latched and logged,
    but not re-notified."""

    def __init__(self, rules: list[AlertRule], *,
                 default_for_ms: int = 10_000,
                 flap_suppress_ms: int = 60_000,
                 log_max: int = 256,
                 sinks: Optional[list] = None,
                 clock: Callable[[], float] = time.time):
        self.rules = list(rules)
        self._default_for_ms = max(0, int(default_for_ms))
        self._flap_suppress_ms = max(0, int(flap_suppress_ms))
        self._log_max = max(1, int(log_max))
        self._clock = clock
        self._sinks = list(sinks or [])
        # (rule_id, key) -> state dict
        self._states: dict[tuple[str, str], dict] = {}
        self._log: list[dict] = []
        self._lock = threading.Lock()
        self._deliveries: "queue.Queue[Optional[dict]]" = queue.Queue(
            maxsize=256)
        self._delivery_thread: Optional[threading.Thread] = None
        self._dropped_deliveries = 0
        # put() increments, the worker decrements AFTER the sinks ran:
        # drain() must count a payload mid-POST as still in flight, not
        # just whatever happens to sit in the queue
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    # -- evaluation ---------------------------------------------------
    def evaluate(self, ctx: AlertContext) -> list[dict]:
        now = ctx.now_ms
        transitions: list[dict] = []
        with self._lock:
            for rule in self.rules:
                try:
                    observations = rule.evaluate(ctx) or []
                except Exception:  # noqa: BLE001 — one bad rule ≠ no alerts
                    LOG.exception("alert rule %s evaluation failed",
                                  rule.rule_id)
                    continue
                transitions += self._advance_rule_locked(
                    rule, observations, now)
            self._log.extend(transitions)
            if len(self._log) > self._log_max:
                del self._log[:len(self._log) - self._log_max]
            self._prune_locked(now)
        for t in transitions:
            if not t.get("suppressed"):
                self._enqueue_delivery(t)
        return transitions

    def _advance_rule_locked(self, rule: AlertRule, observations: list,
                             now: int) -> list[dict]:
        for_ms = rule.for_ms if rule.for_ms >= 0 else self._default_for_ms
        transitions: list[dict] = []
        by_key: dict[str, dict] = {}
        for obs in observations:
            key = str(obs.get("key", "") or rule.scope)
            by_key[key] = obs
        for key, obs in by_key.items():
            st = self._states.get((rule.rule_id, key))
            if st is None or st["status"] == "resolved":
                st = {
                    "status": "pending", "pending_since": now,
                    "firing_since": 0,
                    "last_resolved_ms": (st or {}).get("resolved_ms", 0),
                    "resolved_ms": 0,
                    "flaps": (st or {}).get("flaps", 0),
                    "suppressed": False,
                }
                self._states[(rule.rule_id, key)] = st
            st.update({
                "value": obs.get("value", 0.0),
                "threshold": obs.get("threshold", 0.0),
                "message": str(obs.get("message", "") or ""),
                "annotations": obs.get("annotations") or {},
            })
            if st["status"] == "pending" \
                    and now - st["pending_since"] >= for_ms:
                st["status"] = "firing"
                st["firing_since"] = now
                last = st.get("last_resolved_ms", 0)
                suppressed = bool(
                    last and self._flap_suppress_ms
                    and now - last <= self._flap_suppress_ms)
                st["suppressed"] = suppressed
                if suppressed:
                    st["flaps"] += 1
                transitions.append(self._transition(
                    rule, key, "firing", now, st,
                    extra={"for_ms": now - st["pending_since"]}))
            elif st["status"] == "firing" and st.get("suppressed") \
                    and now - st["firing_since"] >= self._flap_suppress_ms:
                # the "flap" turned out to be a sustained condition: a
                # re-fire that outlives the suppression window is a real
                # incident and must page after all — late-notify once and
                # clear the suppression so the eventual resolve notifies
                # too
                st["suppressed"] = False
                transitions.append(self._transition(
                    rule, key, "firing", now, st,
                    extra={"for_ms": now - st["pending_since"],
                           "late_notify": True}))
        for (rid, key), st in list(self._states.items()):
            if rid != rule.rule_id or key in by_key:
                continue
            if st["status"] == "pending":
                # the condition evaporated before the for-duration: no
                # alert ever existed — drop the embryo silently
                del self._states[(rid, key)]
            elif st["status"] == "firing":
                st["status"] = "resolved"
                st["resolved_ms"] = now
                transitions.append(self._transition(
                    rule, key, "resolved", now, st,
                    extra={"active_ms": now - st["firing_since"]}))
        return transitions

    def _transition(self, rule: AlertRule, key: str, status: str,
                    now: int, st: dict,
                    extra: Optional[dict] = None) -> dict:
        t = {
            "ts_ms": now,
            "rule_id": rule.rule_id,
            "key": key,
            "status": status,
            "severity": rule.severity,
            "scope": rule.scope,
            "value": st.get("value", 0.0),
            "threshold": st.get("threshold", 0.0),
            "message": st.get("message", ""),
            "suppressed": bool(st.get("suppressed")),
        }
        if st.get("annotations"):
            t["annotations"] = dict(st["annotations"])
        t.update(extra or {})
        return t

    def _prune_locked(self, now: int) -> None:
        """Resolved states outlive their flap window only briefly; the
        state map stays bounded no matter how churny the keys are."""
        horizon = max(self._flap_suppress_ms * 4, 300_000)
        stale = [k for k, st in self._states.items()
                 if st["status"] == "resolved"
                 and now - st.get("resolved_ms", 0) > horizon]
        for k in stale:
            del self._states[k]

    # -- views --------------------------------------------------------
    def firing(self) -> list[dict]:
        """Currently-firing alerts (suppressed flaps included — they are
        real conditions, just not re-notified)."""
        out = []
        with self._lock:
            for (rule_id, key), st in sorted(self._states.items()):
                if st["status"] != "firing":
                    continue
                rule = next((r for r in self.rules
                             if r.rule_id == rule_id), None)
                out.append({
                    "rule_id": rule_id, "key": key,
                    "severity": rule.severity if rule else "warning",
                    "scope": rule.scope if rule else "job",
                    "since_ms": st["firing_since"],
                    "value": st.get("value", 0.0),
                    "threshold": st.get("threshold", 0.0),
                    "message": st.get("message", ""),
                    "flaps": st.get("flaps", 0),
                })
        return out

    def firing_counts(self) -> dict[tuple[str, str], int]:
        """{(rule_id, severity): count} — the `tony_alert_firing` gauge
        source."""
        counts: dict[tuple[str, str], int] = {}
        for alert in self.firing():
            combo = (alert["rule_id"], alert["severity"])
            counts[combo] = counts.get(combo, 0) + 1
        return counts

    def log(self) -> list[dict]:
        with self._lock:
            return [dict(t) for t in self._log]

    def bundle(self) -> dict:
        """The alerts.json shape (also GET /api/jobs/:id/alerts)."""
        return {
            "firing": self.firing(),
            "log": self.log(),
            "rules": sorted(r.rule_id for r in self.rules),
            "dropped_deliveries": self._dropped_deliveries,
            "generated_ms": int(self._clock() * 1000),
        }

    # -- delivery -----------------------------------------------------
    def _enqueue_delivery(self, transition: dict) -> None:
        if not self._sinks:
            return
        payload = redact_payload(dict(transition))
        with self._inflight_lock:
            self._inflight += 1
        try:
            self._deliveries.put_nowait(payload)
        except queue.Full:
            with self._inflight_lock:
                self._inflight -= 1
            self._dropped_deliveries += 1
            LOG.warning("alert delivery queue full; dropped %s/%s",
                        transition.get("rule_id"), transition.get("key"))
            return
        with self._lock:
            if self._delivery_thread is None:
                self._delivery_thread = threading.Thread(
                    target=self._delivery_loop, name="alert-delivery",
                    daemon=True)
                self._delivery_thread.start()

    def _delivery_loop(self) -> None:
        from tony_tpu_torch.observability.metrics import REGISTRY
        from tony_tpu_torch.observability.profiler import register_beacon
        # queue-driven: idle() before the blocking get() so an empty
        # queue is not a stall; an ACTIVE beacon older than ~4x this
        # cadence means a sink is wedged mid-delivery
        beacon = register_beacon("alert-delivery", 30.0)
        while True:
            beacon.idle()
            payload = self._deliveries.get()
            beacon.beat()
            if payload is None:
                return
            try:
                for sink in self._sinks:
                    ok = False
                    try:
                        ok = sink.deliver(payload)
                    except Exception:  # noqa: BLE001
                        LOG.exception("alert sink %s raised",
                                      getattr(sink, "name", "?"))
                    REGISTRY.counter(
                        "tony_alert_deliveries_total",
                        sink=getattr(sink, "name", "?"),
                        status="ok" if ok else "error").inc()
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Best-effort wait for in-flight deliveries (tests, _finish) —
        counts a payload the worker already popped but is still POSTing
        as in flight, not just what sits in the queue."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    return True
            time.sleep(0.02)
        return False

    def close(self, timeout_s: float = 2.0) -> None:
        thread = self._delivery_thread
        if thread is None:
            return
        try:
            self._deliveries.put_nowait(None)
        except queue.Full:
            pass
        thread.join(timeout=timeout_s)
        self._delivery_thread = None


# ---------------------------------------------------------------------------
# registry + conf builders
# ---------------------------------------------------------------------------

# Every built-in rule id -> one-line description (the JAX package's map;
# tests/test_torch_alerts.py holds every rule id a conf builds to a key
# here, so a renamed or removed rule cannot leave a dead reference).
BUILTIN_RULES = {
    "train.step_time_regression":
        "task step time above its per-attempt baseline",
    "train.goodput_floor": "job goodput below the configured floor",
    "train.mfu_floor": "mean task MFU below the configured floor",
    "serve.ttft_p95_burn":
        "TTFT p95 ceiling burning its error budget (fast+slow windows)",
    "serve.queue_depth_burn":
        "serving queue depth ceiling burning its error budget",
    "serve.reject_rate_burn":
        "429/reject ratio burning its error budget (fast+slow windows)",
    "fleet.queue_quota_saturated": "queue TPU quota near saturation",
    "fleet.job_lost": "fleet registry entry demoted to LOST",
    "fleet.chips_idle_while_queued":
        "gang queued with zero allocated chips despite quota headroom",
}


def sinks_from_conf(conf) -> list:
    from tony_tpu_torch.conf import keys as K
    sinks: list = []
    url = conf.get_str(K.ALERTS_WEBHOOK_URL, "")
    if url:
        sinks.append(WebhookSink(
            url,
            timeout_s=conf.get_time_ms(K.ALERTS_WEBHOOK_TIMEOUT_MS,
                                       2000) / 1000.0,
            retries=conf.get_int(K.ALERTS_WEBHOOK_RETRIES, 2)))
    path = conf.get_str(K.ALERTS_FILE_SINK, "")
    if path:
        sinks.append(FileSink(path))
    return sinks


def _engine(conf, rules: list[AlertRule]) -> "AlertEngine":
    from tony_tpu_torch.conf import keys as K
    return AlertEngine(
        rules,
        default_for_ms=conf.get_time_ms(K.ALERTS_FOR_MS, 10_000),
        flap_suppress_ms=conf.get_time_ms(K.ALERTS_FLAP_SUPPRESS_MS,
                                          60_000),
        log_max=conf.get_int(K.ALERTS_LOG_MAX_ENTRIES, 256),
        sinks=sinks_from_conf(conf))


def engine_from_conf(conf) -> Optional["AlertEngine"]:
    """The AM-side engine: training + serving rules + custom specs from
    `tony.alerts.*`. None when alerting is disabled. Training thresholds
    fall back to the legacy `tony.slo.*` keys so existing confs keep
    their coverage — now with lifecycle, delivery, and history."""
    from tony_tpu_torch.conf import keys as K
    if not conf.get_bool(K.ALERTS_ENABLED, True):
        return None
    fast_ms = conf.get_time_ms(K.ALERTS_FAST_WINDOW_MS, 300_000)
    slow_ms = conf.get_time_ms(K.ALERTS_SLOW_WINDOW_MS, 3_600_000)
    factor = conf.get_float(K.ALERTS_BURN_RATE_FACTOR, 14.0)
    rules: list[AlertRule] = []

    step_pct = conf.get_float(K.ALERTS_STEP_REGRESSION_PCT, 0) \
        or conf.get_float(K.SLO_STEP_TIME_REGRESSION_PCT, 0)
    if step_pct > 0:
        rules.append(step_regression_rule(step_pct))
    goodput_pct = conf.get_float(K.ALERTS_GOODPUT_FLOOR_PCT, 0) \
        or conf.get_float(K.SLO_GOODPUT_FLOOR_PCT, 0)
    if goodput_pct > 0:
        rules.append(goodput_floor_rule(goodput_pct))
    mfu_pct = conf.get_float(K.ALERTS_MFU_FLOOR_PCT, 0)
    if mfu_pct > 0:
        rules.append(mfu_floor_rule(mfu_pct))

    ttft_ms = conf.get_time_ms(K.ALERTS_TTFT_P95_SLO_MS, 0)
    if ttft_ms > 0:
        rules.append(gauge_burn_rule(
            "serve.ttft_p95_burn", "SERVING_TTFT_P95_S",
            ttft_ms / 1000.0, fast_ms=fast_ms, slow_ms=slow_ms,
            factor=factor))
    depth = conf.get_int(K.ALERTS_QUEUE_DEPTH_SLO, 0)
    if depth > 0:
        rules.append(gauge_burn_rule(
            "serve.queue_depth_burn", "SERVING_QUEUE_DEPTH",
            float(depth), fast_ms=fast_ms, slow_ms=slow_ms,
            factor=factor))
    reject_budget_pct = conf.get_float(K.ALERTS_REJECT_RATE_BUDGET_PCT,
                                       0.0)
    if reject_budget_pct > 0:
        rules.append(ratio_burn_rule(
            "serve.reject_rate_burn", "SERVING_REJECTED_TOTAL",
            "SERVING_SUBMITTED_TOTAL",
            budget_fraction=reject_budget_pct / 100.0,
            fast_ms=fast_ms, slow_ms=slow_ms, factor=factor))

    for spec in conf.get_strings(K.ALERTS_RULES):
        try:
            rules.append(parse_rule_spec(spec))
        except ValueError as e:
            LOG.error("ignoring bad tony.alerts.rules entry: %s", e)
    if not rules:
        return None
    return _engine(conf, rules)


def fleet_engine_from_conf(conf) -> Optional["AlertEngine"]:
    """The portal-side engine: fleet/queue-scope rules evaluated on the
    FleetView refresh cadence over the registry snapshot."""
    from tony_tpu_torch.conf import keys as K
    if not conf.get_bool(K.ALERTS_ENABLED, True):
        return None
    rules = [
        queue_quota_rule(conf.get_float(K.ALERTS_QUEUE_QUOTA_PCT, 95)),
        job_lost_rule(),
        idle_chips_rule(
            for_ms=conf.get_time_ms(K.ALERTS_IDLE_CHIPS_FOR_MS, 120_000)),
    ]
    return _engine(conf, rules)


def alert_firing_families(firing: list[dict],
                          extra_labels: Optional[dict] = None
                          ) -> list[dict]:
    """`tony_alert_firing{rule, severity}` gauge families for the shared
    prometheus encoder — per-(rule, severity) firing counts, the scrape
    surface a cluster pager watches on both the AM and fleet /metrics."""
    counts: dict[tuple[str, str], int] = {}
    for alert in firing:
        combo = (str(alert.get("rule_id", "?")),
                 str(alert.get("severity", "warning")))
        counts[combo] = counts.get(combo, 0) + 1
    samples = []
    for (rule_id, severity), n in sorted(counts.items()):
        labels = {"rule": rule_id, "severity": severity}
        labels.update(extra_labels or {})
        samples.append((labels, float(n)))
    return [{"name": "tony_alert_firing", "type": "gauge", "help": "",
             "samples": samples}]


# ---------------------------------------------------------------------------
# incident timeline
# ---------------------------------------------------------------------------

# history event types worth a timeline row, with their display severity
_TIMELINE_EVENTS = {
    "APPLICATION_INITED": "info",
    "APPLICATION_FINISHED": "info",
    "TASK_RELAUNCHED": "warning",
    "SLO_VIOLATION": "warning",
    "STRAGGLER_DETECTED": "warning",
    "STRAGGLER_CLEARED": "info",
    "SERVING_ENDPOINT_REGISTERED": "info",
    "PROFILE_CAPTURED": "info",
    "DIAGNOSTICS_READY": "critical",
    "ALERT_FIRING": None,       # severity comes from the payload
    "ALERT_RESOLVED": "info",
    # checkpoint-then-evict lifecycle (cluster/arbiter.py + AM drain):
    # the preemption story is exactly what an incident timeline must
    # carry — why the job stopped, and that its successor resumed
    "PREEMPTION_REQUESTED": "warning",
    "PREEMPTED": "warning",
    "RESUMED": "info",
    # serving fleet lifecycle (serve/autoscaler.py + rolling updates):
    # scale actions and weight rollouts explain serving-SLI inflections
    "AUTOSCALE_DECISION": "info",
    "ROLLING_UPDATE_STARTED": "info",
    "ROLLING_UPDATE_COMPLETED": "info",
}


def build_incident_timeline(events: Optional[list] = None,
                            alerts_bundle: Optional[dict] = None,
                            diagnostics: Optional[dict] = None,
                            limit: int = 400) -> list[dict]:
    """Correlate history events, the alert-transition log, and the
    diagnostics bundle into one time-ordered view:
    ``[{ts_ms, kind, severity, summary, span_ids?}, ...]``. Events and
    alerts that describe the same transition (ALERT_* event + log entry)
    dedup on (ts, rule, key, status). Bounded to `limit` rows, newest
    kept."""
    from tony_tpu_torch.events.render import render_event
    rows: list[dict] = []
    # (rule, key, status) -> transition timestamps; the matching
    # ALERT_* history event is stamped at emit time, a few ms after the
    # engine transition, so dedup tolerates skew instead of comparing
    # timestamps exactly
    seen_alerts: dict[tuple, list[int]] = {}
    SKEW_MS = 10_000

    for t in (alerts_bundle or {}).get("log") or []:
        ident = (t.get("rule_id"), t.get("key"), t.get("status"))
        seen_alerts.setdefault(ident, []).append(
            int(t.get("ts_ms", 0) or 0))
        severity = str(t.get("severity", "warning")) \
            if t.get("status") == "firing" else "info"
        summary = (f"alert {t.get('status', '?').upper()} "
                   f"{t.get('rule_id', '?')} on {t.get('key', '?')}"
                   + (f": {t['message']}" if t.get("message") else ""))
        rows.append({"ts_ms": int(t.get("ts_ms", 0) or 0),
                     "kind": "alert", "severity": severity,
                     "summary": summary})

    for ev in events or []:
        etype = str(ev.get("type", ""))
        if etype not in _TIMELINE_EVENTS:
            # failed task completions still tell the story; healthy ones
            # would drown it
            if etype == "TASK_FINISHED" and str(
                    (ev.get("payload") or {}).get("status", "")
                    ).upper() in ("FAILED", "KILLED"):
                rows.append({
                    "ts_ms": int(ev.get("timestamp", 0) or 0),
                    "kind": "event", "severity": "warning",
                    "summary": render_event(etype, ev.get("payload"))})
            continue
        payload = ev.get("payload") or {}
        if etype in ("ALERT_FIRING", "ALERT_RESOLVED"):
            status = "firing" if etype == "ALERT_FIRING" else "resolved"
            ident = (payload.get("rule_id"), payload.get("key"), status)
            ev_ts = int(ev.get("timestamp", 0) or 0)
            if any(abs(ev_ts - ts) <= SKEW_MS
                   for ts in seen_alerts.get(ident, ())):
                continue
        severity = _TIMELINE_EVENTS[etype] or str(
            payload.get("severity", "warning"))
        row = {"ts_ms": int(ev.get("timestamp", 0) or 0),
               "kind": "event", "severity": severity,
               "summary": render_event(etype, payload)}
        span_ids = payload.get("span_ids")
        if isinstance(span_ids, list) and span_ids:
            row["span_ids"] = [str(s) for s in span_ids][:8]
        rows.append(row)

    first = (diagnostics or {}).get("first_failure") or {}
    if first:
        row = {"ts_ms": int(first.get("ts_ms", 0) or 0),
               "kind": "diagnosis", "severity": "critical",
               "summary": (f"root cause: {first.get('task_id', '?')} "
                           f"attempt {first.get('attempt', 0)} — "
                           f"{first.get('reason', '')}"
                           + (f" ({first['signature']})"
                              if first.get("signature") else ""))}
        spans = (diagnostics or {}).get("first_failure_spans") or []
        ids = [str(s.get("span_id")) for s in spans if s.get("span_id")]
        if ids:
            row["span_ids"] = ids[:8]
        rows.append(row)

    rows.sort(key=lambda r: (r["ts_ms"], r["kind"]))
    return rows[-limit:]
