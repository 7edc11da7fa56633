"""The port's alert engine (`tony_tpu_torch/observability/alerts.py`)
against the JAX package's.

Gauge trajectories made from a seed with numpy go through both packages'
rules and `AlertEngine`s under one fake clock. Compared: every pass's
transitions, the firing view and its counts, `bundle()`, the file sink's
JSON lines, the webhook sink's deliveries, the burn-rate arithmetic,
`parse_rule_spec`, the engines `engine_from_conf` and
`fleet_engine_from_conf` build, the fleet-scope rules over registry
summaries, `alert_firing_families`, `redact_payload` and the incident
timeline.
"""

from __future__ import annotations

import http.server
import json
import threading

import numpy as np
import pytest

from tony_tpu.observability import alerts as jalerts
from tony_tpu.observability import fleet as jfleet
from tony_tpu.observability import prometheus as jprom
from tony_tpu_torch.observability import alerts as palerts
from tony_tpu_torch.observability import fleet as pfleet
from tony_tpu_torch.observability import prometheus as pprom

ALERTS = {"jax": jalerts, "port": palerts}
PKG = {"jax": (jalerts, jfleet, jprom), "port": (palerts, pfleet, pprom)}


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _rules(A, window_ms: int) -> list:
    return [
        A.threshold_rule("t.hot", "M", ">", 5.0, for_ms=1000),
        A.threshold_rule("t.job", "GOODPUT", "<", 40.0, scope="job",
                         for_ms=0, severity="critical"),
        A.parse_rule_spec("c.low:TEMP<=2:for=500ms:severity=info"),
        A.gauge_burn_rule("serve.queue_depth_burn", "SERVING_QUEUE_DEPTH",
                          4.0, fast_ms=window_ms, slow_ms=4 * window_ms,
                          factor=14.0),
        A.ratio_burn_rule("serve.reject_rate_burn",
                          "SERVING_REJECTED_TOTAL",
                          "SERVING_SUBMITTED_TOTAL", budget_fraction=0.01,
                          fast_ms=window_ms, slow_ms=4 * window_ms,
                          factor=2.0),
        A.step_regression_rule(50.0, for_ms=0),
        A.goodput_floor_rule(55.0, for_ms=0),
        A.mfu_floor_rule(30.0, for_ms=0),
    ]


def _trajectory(seed: int, ticks: int) -> list[dict]:
    """Per tick: task gauges for three tasks, the job-level numbers and
    the attempts, from a seeded random walk that crosses every rule's
    threshold at least once."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(0, 8, 3)
    depth = rng.uniform(0, 3, 3)
    sub = np.zeros(3)
    rej = np.zeros(3)
    out = []
    for i in range(ticks):
        m = np.clip(m + rng.normal(0, 2.0, 3), 0, 12)
        burst = 20 <= i < 35
        depth = np.clip(depth + rng.normal(2.0 if burst else -1.0, 1.0, 3),
                        0, 16)
        sub += rng.integers(5, 20, 3)
        rej += rng.integers(0, 4, 3) * (1 if burst else 0)
        step = 100.0 + (150.0 if 40 <= i < 48 else 0.0) \
            + rng.normal(0, 3.0, 3)
        gauges = {
            f"serving:{k}": {
                "M": round(float(m[k]), 3),
                "TEMP": round(float(m[k] / 2), 3),
                "SERVING_QUEUE_DEPTH": round(float(depth[k]), 3),
                "SERVING_SUBMITTED_TOTAL": float(sub[k]),
                "SERVING_REJECTED_TOTAL": float(rej[k]),
                "TRAIN_STEP_TIME_MS": round(float(step[k]), 3)}
            for k in range(3)}
        job = {"goodput_pct": round(float(rng.uniform(30, 90)), 2),
               "mfu_pct": round(float(rng.uniform(20, 50)), 2),
               "GOODPUT": round(float(rng.uniform(30, 90)), 2)}
        out.append({"gauges": gauges, "job": job,
                    "attempts": {f"serving:{k}": 0 for k in range(3)}})
    return out


def _engine_run(A, seed: int, tmp_path) -> dict:
    clock = Clock()
    sink = str(tmp_path / "sink.jsonl")
    eng = A.AlertEngine(_rules(A, 2000), default_for_ms=600,
                        flap_suppress_ms=3000, log_max=24,
                        sinks=[A.FileSink(sink)], clock=clock)
    series: dict[str, dict[str, list]] = {}
    passes = []
    for tick in _trajectory(seed, 60):
        now_ms = int(clock.t * 1000)
        for task, gauges in tick["gauges"].items():
            for name, value in gauges.items():
                series.setdefault(name, {}).setdefault(task, []).append(
                    [now_ms, value])
        ctx = A.AlertContext(now_ms=now_ms, gauges=tick["gauges"],
                             history_fn=series.get,
                             attempts=tick["attempts"], job=tick["job"])
        passes.append(eng.evaluate(ctx))
        clock.t += 0.25
    assert eng.drain(timeout_s=10)
    eng.close()
    with open(sink) as f:
        lines = [json.loads(line) for line in f]
    return {"passes": passes, "firing": eng.firing(),
            "counts": sorted(eng.firing_counts().items()),
            "log": eng.log(), "bundle": eng.bundle(), "sink": lines}


@pytest.mark.parametrize("seed", [0, 3])
def test_engine_lifecycle_and_file_sink_match_jax(seed, tmp_path):
    got = {}
    for pkg, A in ALERTS.items():
        (tmp_path / pkg).mkdir()
        got[pkg] = _engine_run(A, seed, tmp_path / pkg)
    assert got["port"] == got["jax"]
    statuses = {t["status"] for p in got["port"]["passes"] for t in p}
    assert statuses == {"firing", "resolved"}
    rules = {t["rule_id"] for p in got["port"]["passes"] for t in p}
    assert {"serve.queue_depth_burn", "t.hot",
            "train.step_time_regression"} <= rules
    assert len(got["port"]["log"]) == 24          # bounded
    assert any(t.get("suppressed") for t in got["port"]["log"])
    assert got["port"]["sink"]                    # suppressed ones stay out
    assert not any(t.get("suppressed") for t in got["port"]["sink"])


def test_webhook_sink_deliveries_match_jax():
    """Each package's WebhookSink posts the redacted transitions of the
    same passes to a local receiver."""
    received: dict[str, list] = {"jax": [], "port": []}

    class Hook(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
            n = int(self.headers.get("Content-Length", 0) or 0)
            received[self.path.strip("/")].append(
                json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    secret = "a" * 64
    try:
        for pkg, A in ALERTS.items():
            clock = Clock()
            sink = A.WebhookSink(
                f"http://127.0.0.1:{httpd.server_port}/{pkg}",
                timeout_s=5.0, retries=1)
            eng = A.AlertEngine(
                [A.threshold_rule("t.hot", "M", ">", 5.0, for_ms=0,
                                  description=f"token {secret}")],
                default_for_ms=0, flap_suppress_ms=0, sinks=[sink],
                clock=clock)
            for value in (9.0, 9.0, 1.0, 7.0):
                eng.evaluate(A.AlertContext(
                    now_ms=int(clock.t * 1000),
                    gauges={"worker:0": {"M": value},
                            "worker:1": {"M": value - 3}}))
                clock.t += 1.0
            assert eng.drain(timeout_s=10)
            eng.close()
    finally:
        httpd.shutdown()
    assert received["port"] == received["jax"]
    assert [(p["key"], p["status"]) for p in received["port"]] == [
        ("worker:0", "firing"), ("worker:1", "firing"),
        ("worker:0", "resolved"), ("worker:1", "resolved"),
        ("worker:0", "firing")]


def test_burn_rate_math_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(50):
        n = int(rng.integers(0, 12))
        ts = np.sort(rng.integers(0, 10_000, n))
        points = [[int(t), float(v)] for t, v in
                  zip(ts, np.cumsum(rng.uniform(-1, 5, n)))]
        now = int(rng.integers(0, 12_000))
        window = int(rng.integers(1, 8000))
        thr = float(rng.uniform(0, 10))
        for f, args in (("counter_window_delta", (points, now, window)),
                        ("gauge_exceed_fraction",
                         (points, now, window, thr)),
                        ("burn_rate", (thr / 10, float(rng.uniform(0, 1))))):
            assert getattr(palerts, f)(*args) == getattr(jalerts, f)(*args)


@pytest.mark.parametrize("spec", [
    "hbm.high:TPU_MEMORY_USAGE_PCT>95:for=30s:severity=critical",
    "q:SERVING_QUEUE_DEPTH>=8",
    "j:goodput_pct<50:scope=job:for=1m",
    "nonsense", "id:METRIC~5", "id:M>5:for=xx", "id:M>5:severity=shouty",
    "id:M>5:scope=galaxy",
])
def test_parse_rule_spec_matches_jax(spec):
    out = {}
    for pkg, A in ALERTS.items():
        try:
            r = A.parse_rule_spec(spec)
        except ValueError as e:
            out[pkg] = ("error", str(e))
            continue
        ctx = A.AlertContext(now_ms=0, gauges={
            "worker:1": {"TPU_MEMORY_USAGE_PCT": 97.0,
                         "SERVING_QUEUE_DEPTH": 8.0}},
            job={"goodput_pct": 20.0})
        out[pkg] = (r.rule_id, r.severity, r.scope, r.for_ms,
                    r.description, r.evaluate(ctx))
    assert out["port"] == out["jax"]
    for text in ("500ms", "30s", "5m", "2h", "250"):
        assert palerts.parse_duration_ms(text) == \
            jalerts.parse_duration_ms(text)


def _conf_engines(pkg: str, settings: dict):
    if pkg == "jax":
        from tony_tpu.conf import TonyConfiguration
    else:
        from tony_tpu_torch.conf import TonyConfiguration
    conf = TonyConfiguration()
    for k, v in settings.items():
        conf.set(k, v, "test")
    A = ALERTS[pkg]
    out = []
    for eng in (A.engine_from_conf(conf), A.fleet_engine_from_conf(conf)):
        if eng is None:
            out.append(None)
            continue
        out.append({
            "rules": [(r.rule_id, r.severity, r.scope, r.for_ms,
                       r.description) for r in eng.rules],
            "for": eng._default_for_ms, "flap": eng._flap_suppress_ms,
            "log_max": eng._log_max,
            "sinks": [type(s).__name__ for s in eng._sinks]})
        eng.close()
    return out


@pytest.mark.parametrize("settings", [
    {},
    {"tony.alerts.enabled": "false",
     "tony.alerts.queue-depth-slo": 8},
    {"tony.alerts.queue-depth-slo": 4, "tony.alerts.for-ms": 500,
     "tony.alerts.fast-window-ms": 2000, "tony.alerts.slow-window-ms": 8000,
     "tony.alerts.burn-rate-factor": 7, "tony.alerts.flap-suppress-ms": 0,
     "tony.alerts.log-max-entries": 32},
    {"tony.slo.step-time-regression-pct": 20, "tony.slo.goodput-floor-pct":
     50, "tony.alerts.ttft-p95-slo-ms": "500ms",
     "tony.alerts.reject-rate-budget-pct": 1,
     "tony.alerts.webhook-url": "http://127.0.0.1:9/hook",
     "tony.alerts.file": "/nonexistent/sink.jsonl"},
    {"tony.alerts.rules": "a:M>5:severity=critical,bad spec,"
                          "b:Q<=1:for=2s",
     "tony.alerts.mfu-floor-pct": 30.5,
     "tony.alerts.queue-quota-saturation-pct": 80,
     "tony.alerts.idle-chips-for-ms": 1000},
])
def test_engines_from_conf_match_jax(settings):
    got = _conf_engines("port", settings)
    assert got == _conf_engines("jax", settings)
    assert palerts.BUILTIN_RULES == jalerts.BUILTIN_RULES
    # every built-in rule a conf turns on is named in the map
    for eng in got:
        for rule_id, *_ in (eng or {}).get("rules", []):
            assert rule_id in palerts.BUILTIN_RULES or rule_id in (
                "a", "b"), rule_id


def _fleet_ctx(A, F, seed: int):
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(12):
        requested = int(rng.integers(1, 17))
        jobs.append(F.job_summary(
            f"app_{i}", "u", str(rng.choice(["prod", "dev", "x"])),
            str(rng.choice(["RUNNING", "RUNNING", "LOST", "SUCCEEDED"])),
            gang_width=2, requested_chips=requested,
            allocated_chips=0 if rng.random() < 0.3 else requested,
            started_ms=1000, heartbeat_ms=2000,
            elastic_job="worker" if rng.random() < 0.3 else "",
            elastic_width=2, elastic_chips_per_task=1,
            elastic_max_width=int(rng.integers(2, 6))))
    return A.AlertContext(now_ms=0, fleet={
        "queues": {"prod": 32, "dev": 24}, "jobs": jobs})


@pytest.mark.parametrize("seed", [1, 2, 9])
def test_fleet_rules_match_jax(seed):
    out = {}
    for pkg, (A, F, _) in PKG.items():
        ctx = _fleet_ctx(A, F, seed)
        out[pkg] = [r.evaluate(ctx) for r in (
            A.queue_quota_rule(60.0), A.job_lost_rule(),
            A.idle_chips_rule())]
    assert out["port"] == out["jax"]
    assert out["port"][1]                     # a LOST job is named


def test_fleet_view_alerts_and_families_match_jax(tmp_path, monkeypatch):
    """The fleet-scope pass a FleetView runs on its refresh, with the
    wall clock the context reads held."""
    import time
    monkeypatch.setattr(time, "time", lambda: 5000.0)
    out = {}
    for pkg, (A, F, prom) in PKG.items():
        eng = A.AlertEngine([A.queue_quota_rule(50.0), A.job_lost_rule()],
                            default_for_ms=0, flap_suppress_ms=0,
                            clock=Clock())
        view = F.FleetView(str(tmp_path / pkg), queues={"prod": 32},
                           settle_accounting=False, alert_engine=eng,
                           clock=Clock(5000.0))
        for job in _fleet_ctx(A, F, 5).fleet["jobs"]:
            view.registry.observe(dict(job, alerts_firing=1))
        view.refresh(force=True)
        text = prom.render(view.families()
                           + A.alert_firing_families(
                               eng.firing(), {"app_id": "a"}))
        out[pkg] = (view.api_alerts(), text)
    assert out["port"] == out["jax"]
    assert "tony_alert_firing{" in out["port"][1]


def test_redact_payload_matches_jax():
    payload = {"message": "Authorization: Bearer abc.def.ghi",
               "annotations": {"token": "f" * 64,
                               "nested": ["password=hunter2", 3, None]},
               "value": 1.5}
    assert palerts.redact_payload(payload) == jalerts.redact_payload(payload)
    assert "f" * 64 not in json.dumps(palerts.redact_payload(payload))


def test_incident_timeline_matches_jax():
    bundle = {
        "firing": [],
        "log": [
            {"ts_ms": 5000, "rule_id": "train.goodput_floor", "key": "job",
             "status": "firing", "severity": "warning", "scope": "job",
             "value": 42.0, "threshold": 60.0, "message": "low",
             "suppressed": False, "for_ms": 1000},
            {"ts_ms": 9000, "rule_id": "train.goodput_floor", "key": "job",
             "status": "resolved", "severity": "warning", "scope": "job",
             "value": 65.0, "threshold": 60.0, "message": "",
             "suppressed": False, "active_ms": 4000}],
        "rules": ["train.goodput_floor"], "generated_ms": 9000}
    events = [
        {"type": "TASK_RELAUNCHED", "timestamp": 4000,
         "payload": {"task_type": "worker", "task_index": 1, "attempt": 1,
                     "generation": 2, "reason": "crash"}},
        {"type": "STRAGGLER_DETECTED", "timestamp": 7000,
         "payload": {"task_type": "worker", "task_index": 2,
                     "signal": "step_time_ms", "phase": "steady_state",
                     "span_ids": ["abc123"]}},
        {"type": "ALERT_FIRING", "timestamp": 5000,
         "payload": {"rule_id": "train.goodput_floor", "key": "job",
                     "severity": "warning"}},
        {"type": "AUTOSCALE_DECISION", "timestamp": 6000,
         "payload": {"job_name": "serving", "direction": "up",
                     "from_replicas": 1, "to_replicas": 2,
                     "arbiter_action": "admit", "reason": "queue"}},
        {"type": "TASK_FINISHED", "timestamp": 8000,
         "payload": {"task_type": "worker", "task_index": 0,
                     "status": "SUCCEEDED"}}]
    diagnostics = {"first_failure": {"task_id": "worker:1", "attempt": 0,
                                     "ts_ms": 3500, "reason": "exit 1",
                                     "signature": "device_oom"},
                   "first_failure_spans": [{"span_id": "def456"}]}
    got = {pkg: A.build_incident_timeline(
        events=events, alerts_bundle=bundle, diagnostics=diagnostics)
        for pkg, A in ALERTS.items()}
    assert got["port"] == got["jax"]
    assert [r["ts_ms"] for r in got["port"]] == sorted(
        r["ts_ms"] for r in got["port"])
    assert got["port"] == palerts.build_incident_timeline(
        events=events, alerts_bundle=bundle, diagnostics=diagnostics,
        limit=400)
