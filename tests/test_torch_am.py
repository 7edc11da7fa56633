"""The port's ApplicationMaster against the JAX package's.

The same jobs run under `python -m tony_tpu.am` (which launches the JAX
executor) and under `python -m tony_tpu_torch.am` (which launches the
port's), each from a `tony-final.json` its own package froze, with the
`tests/scripts/` programs as the tasks. The deterministic record of each
job is compared: the event types in order, `DIAGNOSTICS_READY`, the
final status and message, and diagnostics.json's first failure. The
last `TASK_FINISHED` is left out of the order: whether the JAX AM emits
it before it stops is a race of that AM.

Also here: a port AM killed mid-job and relaunched by its supervisor
(the recovery record of `tests/test_recovery.py`), the alert engine's
rules and a rule that fires and resolves, the replica autoscaler's
scale-up and queued ask, a job run where `tony_tpu` cannot be imported,
and the isolation probe of the AM core.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

from tony_tpu.conf import TonyConfiguration as JaxConf
from tony_tpu.events.handler import parse_events
from tony_tpu_torch import constants as C
from tony_tpu_torch.conf import TonyConfiguration as PortConf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "tests", "scripts")
# the port's own task programs (they import only the port)
PORT_SCRIPTS = os.path.join(REPO, "tests", "torch_scripts")

BASE = {
    "tony.am.monitor-interval-ms": 100,
    "tony.task.heartbeat-interval-ms": 200,
    "tony.task.metrics-interval-ms": 300,
    "tony.task.registration-timeout-sec": 60,
    "tony.am.stop-poll-timeout-ms": 0,
    "tony.am.retry-backoff-base-ms": 100,
    "tony.am.retry-backoff-max-ms": 200,
}


class Job:
    """One finished job: its exit code, history and status files."""

    def __init__(self, app_dir: str, rc: int, stderr: str):
        self.app_dir, self.rc, self.stderr = app_dir, rc, stderr
        finals = glob.glob(os.path.join(app_dir, C.HISTORY_DIR_NAME, "*",
                                        "*." + C.HISTORY_SUFFIX))
        assert len(finals) == 1, (finals, stderr[-4000:])
        self.events = parse_events(finals[0])
        with open(os.path.join(app_dir, C.AM_STATUS_FILE)) as f:
            self.status = json.load(f)
        diag = os.path.join(os.path.dirname(finals[0]), C.DIAGNOSTICS_FILE)
        self.diagnostics = None
        if os.path.exists(diag):
            with open(diag) as f:
                self.diagnostics = json.load(f)

    def of(self, etype: str) -> list:
        return [e.payload for e in self.events if e.type.name == etype]

    def record(self) -> dict:
        """What both AMs must agree on."""
        diag = [{k: v for k, v in vars(p).items() if k != "application_id"}
                for p in self.of("DIAGNOSTICS_READY")]
        first = (self.diagnostics or {}).get("first_failure") or {}
        return {
            "events": [e.type.name for e in self.events
                       if e.type.name != "TASK_FINISHED"],
            "status": self.status["status"],
            "message": self.status["message"],
            "diagnostics_ready": diag,
            "first_failure": {k: first.get(k) for k in (
                "task_id", "attempt", "exit_code", "signal", "reason",
                "source")},
            "bundle_message": (self.diagnostics or {}).get("message"),
        }


def _start(tmp_path, pkg: str, name: str, settings: dict, env=None,
           supervisor: bool = False, pythonpath: str = REPO):
    """Freeze the job with `pkg`'s own TonyConfiguration and start its AM
    (or its supervisor). Returns (process, app dir)."""
    app_id = f"application_{pkg}_{name}"
    app_dir = str(tmp_path / app_id)
    os.makedirs(app_dir)
    conf = PortConf() if pkg == "port" else JaxConf()
    for k, v in {**BASE, **settings}.items():
        conf.set(k, v, "test")
    conf.write(os.path.join(app_dir, C.TONY_FINAL_CONF))
    module = ("tony_tpu_torch.am" if pkg == "port" else "tony_tpu.am") \
        + (".supervisor" if supervisor else "")
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--app_id", app_id,
         "--app_dir", app_dir],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=app_dir,
        env=dict(os.environ, PYTHONPATH=pythonpath, JAX_PLATFORMS="cpu",
                 TONY_LOG_PLAIN="1", **(env or {})))
    return proc, app_dir


def _run(tmp_path, pkg: str, name: str, settings: dict, timeout=120,
         **kw) -> Job:
    proc, app_dir = _start(tmp_path, pkg, name, settings, **kw)
    try:
        _, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return Job(app_dir, proc.returncode, stderr)


def _both(tmp_path, name, settings, **kw) -> dict[str, Job]:
    return {pkg: _run(tmp_path, pkg, name, settings, **kw)
            for pkg in ("jax", "port")}


def _script(name: str) -> str:
    return f"{sys.executable} {os.path.join(SCRIPTS, name)}"


def _port_script(name: str) -> str:
    return f"{sys.executable} {os.path.join(PORT_SCRIPTS, name)}"


# ---------------------------------------------------------------------------
# the same job under both AMs
# ---------------------------------------------------------------------------

def test_two_workers_pass_alike(tmp_path):
    jobs = _both(tmp_path, "pass", {"tony.worker.instances": 2,
                                    "tony.task.command": _script("exit_0.py")})
    for pkg, job in jobs.items():
        assert job.rc == 0, (pkg, job.stderr[-4000:])
        assert job.status["status"] == "SUCCEEDED"
        # the port AM launched the port executor, the JAX AM its own
        started = {(p.task_type, p.task_index) for p in job.of("TASK_STARTED")}
        assert started == {("worker", 0), ("worker", 1)}
    assert jobs["port"].record() == jobs["jax"].record()
    assert jobs["port"].record()["events"] == [
        "APPLICATION_INITED", "TASK_STARTED", "TASK_STARTED",
        "APPLICATION_FINISHED"]
    with open(os.path.join(jobs["port"].app_dir, C.CONTAINERS_DIR_NAME,
                           "worker_0_s0", "stderr")) as f:
        assert "tony_tpu_torch.executor" in f.read()


def test_a_failing_worker_fails_the_job_alike(tmp_path):
    # the chief (worker:0) exits 3 after worker:1 has exited cleanly
    command = ('if [ "$TASK_INDEX" = 0 ]; then sleep 2; exit 3; fi; '
               'exit 0')
    jobs = _both(tmp_path, "fail", {"tony.worker.instances": 2,
                                    "tony.task.command": command})
    for job in jobs.values():
        assert job.rc == 1 and job.status["status"] == "FAILED"
    port, jax_ = jobs["port"].record(), jobs["jax"].record()
    assert port == jax_
    assert port["first_failure"]["task_id"] == "worker:0"
    assert port["first_failure"]["exit_code"] == 3
    assert port["diagnostics_ready"][0]["num_failures"] == 1


def test_a_session_retry_recovers_alike(tmp_path):
    jobs = _both(tmp_path, "retry", {
        "tony.worker.instances": 1, "tony.am.retry-count": 1,
        "tony.task.command": _script("exit_0_if_retry.py")})
    for job in jobs.values():
        assert job.rc == 0 and job.status["status"] == "SUCCEEDED"
        # one TASK_STARTED per session: the failed attempt and the retry
        assert len(job.of("TASK_STARTED")) == 2
    assert jobs["port"].record() == jobs["jax"].record()


def test_a_registration_timeout_fails_the_job_alike(tmp_path):
    # no executor boots and registers inside 50 ms
    jobs = _both(tmp_path, "regtimeout", {
        "tony.worker.instances": 2, "tony.container.allocation.timeout": 50,
        "tony.task.command": "sleep 30"})
    for job in jobs.values():
        assert job.rc == 1 and job.status["status"] == "FAILED"
    port, jax_ = jobs["port"].record(), jobs["jax"].record()
    assert port["message"] == jax_["message"] == (
        "Tasks failed to register within the allocation timeout.")
    assert port["events"] == jax_["events"]
    assert port["status"] == jax_["status"]
    assert port["bundle_message"] == jax_["bundle_message"]


# ---------------------------------------------------------------------------
# AM crash recovery under the supervisor
# ---------------------------------------------------------------------------

def _children(pid: int) -> list[int]:
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid:
                out.append(int(entry))
    return out


def _wait_for(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.1)


def _recovered(app_dir: str) -> bool:
    for path in glob.glob(os.path.join(app_dir, C.HISTORY_DIR_NAME, "*",
                                       "*" + C.HISTORY_INPROGRESS_SUFFIX)):
        try:
            if any(e.type.name == "AM_RECOVERY_COMPLETED"
                   for e in parse_events(path)):
                return True
        except (ValueError, KeyError):   # a line torn mid-write
            pass
    return False


def test_the_supervisor_recovers_a_killed_am_alike(tmp_path):
    """SIGKILL the AM while its gang is parked mid-training: the
    supervisor relaunches it, the new attempt replays the journal and
    adopts the running gang, and the record is `tests/test_recovery.py`'s
    (one restart, the whole gang adopted, nothing relaunched, one
    `.jhist`, the outage charged to am_downtime)."""
    width = 2
    records = {}
    for pkg in ("jax", "port"):
        markers = tmp_path / f"markers_{pkg}"
        release = tmp_path / f"release_{pkg}"
        sup, app_dir = _start(tmp_path, pkg, "recovery", {
            "tony.worker.instances": width,
            "tony.am.max-attempts": 2,
            "tony.task.hb-failure-budget": 2,
            "tony.am.orphan-grace-ms": 60_000,
            "tony.task.max-missed-heartbeats": 60,
            "tony.task.command": _script("recovery_gang_worker.py"),
        }, supervisor=True,
            env={"MARKER_DIR": str(markers), "RECOVERY_STEPS": "8",
                 "RECOVERY_STEP_SLEEP": "0.05",
                 "CHAOS_RECOVERY_HOLD": str(release)})
        try:
            # every trainer started (and parks at its hold mid-training)
            _wait_for(lambda: all((markers / f"worker_{i}").exists()
                                  for i in range(width)), 90, "the gang")
            [am] = _children(sup.pid)
            os.kill(am, signal.SIGKILL)
            _wait_for(lambda: _recovered(app_dir), 90,
                      "AM_RECOVERY_COMPLETED")
        finally:
            release.write_text("go")
        try:
            _, stderr = sup.communicate(timeout=120)
        finally:
            if sup.poll() is None:
                sup.kill()
                sup.communicate()
        job = Job(app_dir, sup.returncode, stderr)
        assert job.rc == 0, (pkg, job.stderr[-4000:])
        assert job.status["status"] == "SUCCEEDED"
        [started] = job.of("AM_RECOVERY_STARTED")
        [completed] = job.of("AM_RECOVERY_COMPLETED")
        assert started.am_attempt == 1 and started.replayed_records > 0
        assert completed.adopted == width and completed.lost == 0
        assert completed.replayed_records > 0 and completed.downtime_ms > 0
        # no user process relaunched: every slot started once
        for i in range(width):
            with open(markers / f"worker_{i}") as f:
                assert [json.loads(x) for x in f] == \
                    [{"attempt": 0, "generation": 1}]
        assert job.of("TASK_RELAUNCHED") == []
        with open(os.path.join(app_dir, C.HISTORY_DIR_NAME,
                               f"application_{pkg}_recovery",
                               C.GOODPUT_FILE)) as f:
            assert json.load(f)["job"]["am_downtime_s"] > 0
        records[pkg] = (job.record(), started.am_attempt, completed.adopted,
                        completed.lost)
    assert records["port"] == records["jax"]


# ---------------------------------------------------------------------------
# the alert engine and the replica autoscaler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key,value", [
    ("tony.alerts.step-regression-pct", "20"),
    ("tony.slo.step-time-regression-pct", "20"),
    ("tony.alerts.goodput-floor-pct", "50"),
    ("tony.slo.goodput-floor-pct", "50"),
    ("tony.alerts.mfu-floor-pct", "30.5"),
    ("tony.alerts.ttft-p95-slo-ms", "500ms"),
    ("tony.alerts.queue-depth-slo", "8"),
    ("tony.alerts.reject-rate-budget-pct", "1"),
    ("tony.alerts.rules", "r1:TRAIN_STEP_TIME_MS>500:severity=warning"),
])
def test_every_alert_key_builds_the_jax_rule_set(key, value):
    """Each key that gives the JAX AM's engine a rule gives the port's
    AM the same rule set: ids, severities, scopes, for-durations and
    descriptions, and the engine's own knobs."""
    from tony_tpu.observability import alerts as jalerts
    from tony_tpu_torch.observability import alerts as palerts
    got = {}
    for pkg, Conf, A in (("jax", JaxConf, jalerts),
                         ("port", PortConf, palerts)):
        conf = Conf()
        conf.set(key, value, "test")
        eng = A.engine_from_conf(conf)
        got[pkg] = ([(r.rule_id, r.severity, r.scope, r.for_ms,
                      r.description) for r in eng.rules],
                    eng._default_for_ms, eng._flap_suppress_ms)
        eng.close()
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 1


def _alert_log(job: Job) -> list:
    with open(os.path.join(os.path.dirname(glob.glob(os.path.join(
            job.app_dir, C.HISTORY_DIR_NAME, "*", "*." + C.HISTORY_SUFFIX))[
                0]), C.ALERTS_FILE)) as f:
        bundle = json.load(f)
    return [{k: t[k] for k in ("rule_id", "key", "status", "severity",
                               "scope", "value", "threshold", "message",
                               "suppressed")} for t in bundle["log"]] + [
        {"rules": bundle["rules"], "firing": bundle["firing"]}]


def test_an_alert_rule_fires_and_resolves_alike(tmp_path):
    """A custom rule on a gauge the task pushes high, then low: both AMs
    record ALERT_FIRING then ALERT_RESOLVED in the same place among the
    job's events, and write the same transitions to alerts.json."""
    jobs = _both(tmp_path, "alert", {
        "tony.worker.instances": 1,
        "tony.task.command": _port_script("alert_gauge_task.py"),
        "tony.alerts.rules": "t.gauge:TEST_GAUGE>5:for=200ms",
        "tony.alerts.flap-suppress-ms": 0})
    records = {pkg: job.record() for pkg, job in jobs.items()}
    assert records["port"] == records["jax"]
    assert records["port"]["status"] == "SUCCEEDED"
    events = records["port"]["events"]
    assert events.index("ALERT_FIRING") < events.index("ALERT_RESOLVED")
    logs = {pkg: _alert_log(job) for pkg, job in jobs.items()}
    assert logs["port"] == logs["jax"]
    assert [t["status"] for t in logs["port"][:-1]] == ["firing",
                                                        "resolved"]
    fired = jobs["port"].of("ALERT_FIRING")[0]
    assert (fired.rule_id, fired.key) == ("t.gauge", "worker:0")


def _events_so_far(app_dir: str) -> list:
    found = glob.glob(os.path.join(app_dir, C.HISTORY_DIR_NAME, "*",
                                   "*.inprogress"))
    return parse_events(found[0]) if found else []


def _write_holder(stage: str, now_ms: int) -> None:
    """Another tenant's live jobstate, holding the whole inventory."""
    path = os.path.join(stage, "application_holder", C.FLEET_DIR_NAME,
                        C.JOBSTATE_FILE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    from tony_tpu_torch.observability.fleet import job_summary
    with open(path, "w") as f:
        json.dump(job_summary("application_holder", "other", "default",
                              "RUNNING", gang_width=1, allocated_chips=2,
                              started_ms=now_ms, heartbeat_ms=now_ms), f)


def test_the_autoscaler_scales_up_then_queues_alike(tmp_path):
    """A serving job on stub replicas whose pushed queue stays deep:
    each AM's first ask is admitted by the arbiter (an empty book of 2
    chips) and launches serving:1; once another tenant's jobstate holds
    the 2 chips, the next ask is queued. Both AMs record the same
    decisions in the same place among their events."""
    procs = {}
    for pkg in ("jax", "port"):
        procs[pkg] = _start(tmp_path, pkg, "scale", {
            "tony.serving.instances": 1, "tony.serving.tpus": 1,
            "tony.serving.command": _port_script("stub_serving_replica.py"),
            "tony.task.term-grace-ms": 1000,
            "tony.autoscaler.enabled": "true",
            "tony.autoscaler.hysteresis-passes": 1,
            "tony.autoscaler.queue-depth-up": 8,
            "tony.autoscaler.cooldown-ms": 4000,
            "tony.autoscaler.max-replicas": 3,
            "tony.arbiter.total-tpus": 2,
            "tony.staging.location": str(tmp_path / f"stage_{pkg}"),
            "tony.fleet.publish-interval-ms": 200})
    jobs = {}
    try:
        for pkg, (proc, app_dir) in procs.items():
            _wait_for(lambda: proc.poll() is not None or [
                e for e in _events_so_far(app_dir)
                if e.type.name == "AUTOSCALE_DECISION"], 60,
                f"{pkg}: the first AUTOSCALE_DECISION")
            _write_holder(str(tmp_path / f"stage_{pkg}"),
                          int(time.time() * 1000))
        for pkg, (proc, app_dir) in procs.items():
            _wait_for(lambda: proc.poll() is not None or len(
                [e for e in _events_so_far(app_dir)
                 if e.type.name == "AUTOSCALE_DECISION"]) >= 2, 60,
                f"{pkg}: the second AUTOSCALE_DECISION")
            proc.send_signal(signal.SIGTERM)
        for pkg, (proc, app_dir) in procs.items():
            _, stderr = proc.communicate(timeout=120)
            jobs[pkg] = Job(app_dir, proc.returncode, stderr)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    keep = ("APPLICATION_INITED", "TASK_STARTED", "AUTOSCALE_DECISION",
            "APPLICATION_FINISHED")
    got = {}
    for pkg, job in jobs.items():
        got[pkg] = {
            "events": [e.type.name for e in job.events
                       if e.type.name in keep],
            "decisions": [vars(p) for p in job.of("AUTOSCALE_DECISION")],
            "registered": sorted({p.task_index for p in
                                  job.of("SERVING_ENDPOINT_REGISTERED")}),
            "status": job.status["status"]}
    assert got["port"] == got["jax"]
    assert got["port"]["events"][:5] == [
        "APPLICATION_INITED", "TASK_STARTED", "AUTOSCALE_DECISION",
        "TASK_STARTED", "AUTOSCALE_DECISION"]
    first, second = got["port"]["decisions"][:2]
    assert (first["direction"], first["from_replicas"],
            first["to_replicas"], first["chips"],
            first["arbiter_action"]) == ("up", 1, 2, 1, "admit")
    assert (second["from_replicas"], second["arbiter_action"]) == (
        2, "queue")
    assert got["port"]["registered"] == [0, 1]


# ---------------------------------------------------------------------------
# a whole job with no module of tony_tpu importable
# ---------------------------------------------------------------------------

def test_a_job_runs_where_tony_tpu_cannot_be_imported(tmp_path):
    lone = tmp_path / "lone"
    shutil.copytree(os.path.join(REPO, "tony_tpu_torch"),
                    str(lone / "tony_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "_build",
                                                  "csrc"))
    probe = (f"{sys.executable} -c \"import importlib.util, sys; "
             f"sys.exit(importlib.util.find_spec('tony_tpu') is not None)\"")
    job = _run(tmp_path, "port", "lone", {
        "tony.worker.instances": 1, "tony.task.command": probe},
        pythonpath=str(lone))
    assert job.rc == 0, job.stderr[-4000:]
    assert job.status["status"] == "SUCCEEDED"


def test_the_am_core_imports_no_torch_jax_grpc_or_tony_tpu():
    probe = (
        "import sys\n"
        "import tony_tpu_torch.am, tony_tpu_torch.am.__main__\n"
        "import tony_tpu_torch.am.supervisor, tony_tpu_torch.am.journal\n"
        "import tony_tpu_torch.am.liveliness\n"
        "import tony_tpu_torch.session, tony_tpu_torch.cluster\n"
        "import tony_tpu_torch.cluster.elastic, tony_tpu_torch.cluster.docker\n"
        "import tony_tpu_torch.conf, tony_tpu_torch.conf.queues\n"
        "import tony_tpu_torch.events, tony_tpu_torch.rpc.service\n"
        "import tony_tpu_torch.observability.skew\n"
        "import tony_tpu_torch.observability.http\n"
        "import tony_tpu_torch.observability.fleet\n"
        "import tony_tpu_torch.client, tony_tpu_torch.client.tony_client\n"
        "import tony_tpu_torch.cli, tony_tpu_torch.cli.__main__\n"
        "import tony_tpu_torch.cli.local_submitter\n"
        "import tony_tpu_torch.cli.cluster_submitter\n"
        "import tony_tpu_torch.cli.notebook_submitter\n"
        "import tony_tpu_torch.cluster.remote\n"
        "import tony_tpu_torch.cluster.warmpool, tony_tpu_torch.proxy\n"
        "import tony_tpu_torch.utils.native, tony_tpu_torch.events.render\n"
        "import tony_tpu_torch.version\n"
        "import tony_tpu_torch.observability.alerts\n"
        "import tony_tpu_torch.cluster.arbiter\n"
        "import tony_tpu_torch.serve.autoscaler\n"
        "import tony_tpu_torch.serve.router\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'torch', 'jax', 'jaxlib', 'grpc', 'tony_tpu'}))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=60, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_launch_command_names_the_jax_package():
    import re
    pattern = re.compile(r"tony_tpu\.(executor|serve|am)\b")
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "tony_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    hits += [f"{path}:{i}" for i, line in enumerate(f, 1)
                             if pattern.search(line)]
    assert hits == []


@pytest.mark.parametrize("job", ["worker", "serving"])
def test_the_container_env_is_the_jax_ams(tmp_path, job):
    """The env each AM renders into a container: the same keys and values,
    but for the PYTHONPATH that makes its own package importable and, for
    the serving jobtype, the server the AM launches by default (each
    package's own `-m <package>.serve`)."""
    from tony_tpu.am.application_master import ApplicationMaster as JaxAM
    from tony_tpu.cluster.backend import Container as JaxContainer
    from tony_tpu.session.session import TonySession as JaxSession
    from tony_tpu_torch.am.application_master import ApplicationMaster
    from tony_tpu_torch.cluster.backend import Container
    from tony_tpu_torch.session.session import TonySession

    settings = {"tony.worker.instances": 2, "tony.serving.instances": 1,
                "tony.task.command": "python train.py",
                "tony.execution.env": "A=1,B=x=y"}
    envs = {}
    for pkg, am_cls, session_cls, container_cls in (
            ("jax", JaxAM, JaxSession, JaxContainer),
            ("port", ApplicationMaster, TonySession, Container)):
        conf = PortConf() if pkg == "port" else JaxConf()
        for k, v in {**BASE, **settings}.items():
            conf.set(k, v, "test")
        app_dir = str(tmp_path / pkg)
        am = am_cls(conf, "application_env", app_dir)
        am._auth_token, am._conf_uri = "5e" * 32, ""
        am.session = session_cls(conf, session_id=2)
        task = am.session.get_task(job, 0)
        envs[pkg] = am._container_env(
            task, am.session.requests[job],
            container_cls(container_id="container_env_000001", host="h0",
                          priority=0))
        am.backend.stop()
    port, jax_ = envs["port"], envs["jax"]
    assert port.pop("PYTHONPATH").split(os.pathsep)[0] == REPO
    jax_.pop("PYTHONPATH")
    for env in (port, jax_):
        env["TONY_APP_DIR"] = env["TONY_CONF_PATH"] = ""
    if job == "serving":
        assert port.pop(C.TASK_COMMAND) == \
            f"{sys.executable} -m tony_tpu_torch.serve"
        assert jax_.pop(C.TASK_COMMAND) == f"{sys.executable} -m tony_tpu.serve"
    assert port == jax_
    assert port["TONY_SECURITY_TOKEN"] and port["A"] == "1"


def test_a_serving_job_stops_on_sigterm_to_the_am(tmp_path):
    """The port's server as the serving task of a port AM (the chip
    smoke's serving job, on the CPU): SERVING_UP, one /v1/generate, then
    SIGTERM to the AM closes the port and the history holds the
    endpoint's registration."""
    import socket
    import urllib.request

    proc, app_dir = _start(tmp_path, "port", "serve", {
        "tony.serving.instances": 1, "tony.serving.slots": 2,
        "tony.task.term-grace-ms": 1000,
        "tony.serving.command": f"{sys.executable} -m tony_tpu_torch.serve "
                                f"--device cpu --config tiny"})
    stdout = os.path.join(app_dir, C.CONTAINERS_DIR_NAME, "serving_0_s0",
                          "stdout")
    url = []

    def _up():
        assert proc.poll() is None, proc.communicate()[1][-4000:]
        if os.path.exists(stdout):
            with open(stdout) as f:
                url.extend(line.split()[1] for line in f
                           if line.startswith("SERVING_UP "))
        return bool(url)
    try:
        _wait_for(_up, 120, "SERVING_UP")
        req = urllib.request.Request(
            url[0] + "/v1/generate", method="POST",
            data=json.dumps({"prompt": [1, 2, 3],
                             "max_new_tokens": 4}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert len(json.loads(resp.read())["tokens"]) == 4
        proc.send_signal(signal.SIGTERM)
        _, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    job = Job(app_dir, proc.returncode, stderr)
    assert job.status["status"] == "KILLED"
    [reg] = [p for p in job.of("SERVING_ENDPOINT_REGISTERED")
             if not getattr(p, "draining", False)][:1]
    assert reg.url == url[0]
    port = url[0].rsplit(":", 1)[1]
    with socket.socket() as s:
        assert s.connect_ex(("127.0.0.1", int(port))) != 0
