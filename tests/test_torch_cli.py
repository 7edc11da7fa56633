"""`python -m tony_tpu_torch.cli` against `python -m tony_tpu.cli`.

- `local` on the same tiny 2-worker job, once passing and once failing:
  the same exit code, final status and message, event types in order
  (without `TASK_FINISHED`, whose emission before the AM stops is a race
  of the JAX AM) and first failure.
- The offline subcommands (`diagnose`, `stragglers`, `trace`, `flame`)
  print the same text from the same history, and the live ones (`logs`,
  `resize`, `rollout`) the same text from the same running AM.
- The fleet subcommands (`alerts`, `top --once`, `arbiter`, `router
  --status`) print the same text from the same history, staging store
  and running router.
- `submit` runs a job where `tony_tpu` cannot be imported.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tony_tpu.cli import __main__ as jcli
from tony_tpu.events.handler import parse_events
from tony_tpu.events.history import (
    write_serving_traces_file, write_skew_file,
)
from tony_tpu.observability.skew import SkewTracker, StragglerAnalyzer
from tony_tpu_torch import constants as C
from tony_tpu_torch.cli import __main__ as pcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "tests", "scripts")
MODULES = {"jax": "tony_tpu.cli", "port": "tony_tpu_torch.cli"}
CLIS = {"jax": jcli, "port": pcli}

FAST = ["--conf", "tony.am.monitor-interval-ms=100",
        "--conf", "tony.task.heartbeat-interval-ms=200",
        "--conf", "tony.task.metrics-interval-ms=300",
        "--conf", "tony.task.registration-timeout-sec=60",
        "--conf", "tony.am.stop-poll-timeout-ms=0"]
FINISHED = re.compile(r"application (\S+) finished: (\S+) \((.*)\)$")


def _env(pythonpath: str = REPO) -> dict:
    return dict(os.environ, PYTHONPATH=pythonpath, JAX_PLATFORMS="cpu",
                TONY_LOG_PLAIN="1")


def _cli(pkg: str, argv: list[str], cwd, timeout: float = 120,
         pythonpath: str = REPO) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", MODULES[pkg], *argv],
                          cwd=str(cwd), env=_env(pythonpath),
                          capture_output=True, text=True, timeout=timeout)


def _in_process(pkg: str, verb: str, argv: list[str]) -> tuple:
    """(rc, stdout, stderr) of one subcommand called in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = getattr(CLIS[pkg], verb)(argv)
    return rc, out.getvalue(), err.getvalue()


# ---------------------------------------------------------------------------
# `local`, the same job under both packages
# ---------------------------------------------------------------------------

COMMANDS = {
    "pass": os.path.join(SCRIPTS, "exit_0.py"),
    # the chief (worker:0) exits 3 after worker:1 has exited cleanly
    "fail": ('if [ "$TASK_INDEX" = 0 ]; then sleep 2; exit 3; fi; '
             'exit 0'),
}


def _local(pkg: str, outcome: str, tmp_path) -> dict:
    hist = tmp_path / pkg / "hist"
    proc = _cli(pkg, ["local", "--executes", COMMANDS[outcome],
                      "--conf", "tony.worker.instances=2",
                      "--conf", f"tony.history.intermediate={hist}"] + FAST,
                tmp_path)
    [line] = [m for m in (FINISHED.search(x) for x in
                          proc.stderr.splitlines()) if m]
    [jhist] = glob.glob(str(hist / "*" / f"*.{C.HISTORY_SUFFIX}"))
    diag = os.path.join(os.path.dirname(jhist), C.DIAGNOSTICS_FILE)
    first = {}
    if os.path.exists(diag):
        with open(diag) as f:
            first = json.load(f).get("first_failure") or {}
    return {"rc": proc.returncode, "status": line.group(2),
            "message": line.group(3),
            "events": [e.type.name for e in parse_events(jhist)
                       if e.type.name != "TASK_FINISHED"],
            "first_failure": {k: first.get(k) for k in (
                "task_id", "attempt", "exit_code", "signal", "reason",
                "source")},
            "history": os.path.dirname(jhist),
            "stderr": proc.stderr}


@pytest.mark.parametrize("outcome", sorted(COMMANDS))
def test_local_runs_the_job_as_the_jax_cli(outcome, tmp_path):
    jobs = {pkg: _local(pkg, outcome, tmp_path) for pkg in MODULES}
    records = {pkg: {k: v for k, v in job.items()
                     if k not in ("history", "stderr")}
               for pkg, job in jobs.items()}
    assert records["port"] == records["jax"], jobs["port"]["stderr"][-3000:]
    port = records["port"]
    if outcome == "pass":
        assert port["rc"] == 0 and port["status"] == "SUCCEEDED"
        assert port["events"] == ["APPLICATION_INITED", "TASK_STARTED",
                                  "TASK_STARTED", "APPLICATION_FINISHED"]
        return
    assert port["rc"] == 255 and port["status"] == "FAILED"
    assert port["first_failure"]["task_id"] == "worker:0"
    assert port["first_failure"]["exit_code"] == 3
    # diagnose and flame print the same text from each job's history
    for job in jobs.values():
        for verb in ("diagnose", "flame"):
            said = {pkg: _in_process(pkg, verb, [job["history"]])
                    for pkg in MODULES}
            assert said["port"] == said["jax"], verb
            assert said["port"][0] == 0, said["port"]
        assert "first failing task: worker:0" in said["port"][1] \
            or "samples across" in said["port"][1]


# ---------------------------------------------------------------------------
# the offline renderers on one synthetic history
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _skew_bundle() -> dict:
    clock = _Clock()
    tracker = SkewTracker(clock=clock)
    analyzer = StragglerAnalyzer(threshold_pct=50, windows=1, min_tasks=3)
    for _ in range(3):
        for i in range(8):
            for _ in range(4):
                tracker.observe_metric(f"worker:{i}", "TRAIN_STEP_TIME_MS",
                                       300.0 if i == 4 else 100.0)
        clock.t += 1.0
        analyzer.analyze(tracker.maybe_roll(window_ms=500),
                         tracker.startup_values())
    return tracker.bundle(analyzer)


def _trace(process: str, reason: str, duration: float, hops) -> dict:
    tid = "feedface" * 4
    return {"trace_id": tid, "request_id": "7", "process": process,
            "kept_reason": reason, "duration_ms": duration,
            "hops": [{"trace_id": tid, "span_id": sid, "parent_id": "",
                      "name": name, "process": process, "start_ms": a,
                      "end_ms": b, "status": "OK", "attrs": {}}
                     for sid, name, a, b in hops]}


@pytest.fixture
def history(tmp_path):
    hist = tmp_path / "history" / "application_x_1"
    write_skew_file(str(hist), _skew_bundle())
    write_serving_traces_file(str(hist), [
        _trace("prefill:0", "migrated", 600.0,
               [("s1", "queue_wait", 1000, 1010),
                ("s2", "prefill_suffix", 1010, 1050)]),
        _trace("decode:0", "migrated", 580.0,
               [("s4", "migrate.install", 1070, 1090),
                ("s5", "decode", 1090, 1600)])])
    (hist / C.PROFILE_FOLDED_FILE).write_text(
        "MainThread;am.py:run;am.py:_monitor 40\n"
        "MainThread;am.py:run;rpc.py:serve 7\n"
        "rpc-0;grpc.py:poll 13\n")
    (hist / C.DIAGNOSTICS_FILE).write_text(json.dumps({
        "app_id": "application_x_1", "status": "FAILED", "message": "boom",
        "first_failure": {"task_id": "worker:1", "attempt": 0,
                          "exit_code": -9, "signal_name": "SIGKILL",
                          "signature": "device_oom", "hint": "shrink",
                          "reason": "exit -9", "line": "CUDA out of memory",
                          "tail": {"stderr": ["a", "b"]}},
        "failures": [{"task_id": "worker:1", "attempt": 0},
                     {"task_id": "worker:2", "attempt": 1,
                      "reason": "exit 1"}],
        "stacks": {"worker:3": {"attempt": 0, "reason": "wedged",
                                "blocking_frame": "nccl.py:wait"}}}))
    return tmp_path


OFFLINE = [("diagnose", []), ("diagnose", ["--json"]),
           ("stragglers", []), ("stragglers", ["--json"]),
           ("trace", []), ("trace", ["--json"]),
           ("trace", ["--trace-id", "0000"]), ("flame", []),
           ("flame", ["--folded"]), ("flame", ["--top", "1"])]


@pytest.mark.parametrize("verb,flags", OFFLINE,
                         ids=[f"{v}{''.join(f)}" for v, f in OFFLINE])
def test_offline_subcommands_print_the_jax_text(verb, flags, history):
    said = {pkg: _in_process(pkg, verb, [str(history)] + flags)
            for pkg in MODULES}
    assert said["port"] == said["jax"]
    assert said["port"][1] or said["port"][2]


@pytest.mark.parametrize("verb", ["diagnose", "stragglers", "trace",
                                  "flame"])
def test_a_missing_bundle_is_reported_alike(verb, tmp_path):
    said = {pkg: _in_process(pkg, verb, [str(tmp_path)]) for pkg in MODULES}
    assert said["port"] == said["jax"]
    assert said["port"][0] == 1


# ---------------------------------------------------------------------------
# the live subcommands, both packages' CLIs against one running port AM
# ---------------------------------------------------------------------------

def test_live_subcommands_print_the_jax_text(tmp_path):
    release = tmp_path / "release"
    command = (f"echo line-one; echo line-two; "
               f"while [ ! -e {release} ]; do sleep 0.1; done")
    workdir = tmp_path / "work"
    proc = subprocess.Popen(
        [sys.executable, "-m", MODULES["port"], "submit", "--executes",
         command, "--conf", "tony.worker.instances=1",
         "--conf", f"tony.cluster.workdir={workdir}"] + FAST,
        cwd=str(tmp_path), env=_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 90
        stdout = None
        while time.monotonic() < deadline:
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            found = glob.glob(str(workdir / "*" / C.CONTAINERS_DIR_NAME
                                  / "worker_0_s0" / "stdout"))
            if found and "line-two" in open(found[0]).read():
                stdout = found[0]
                break
            time.sleep(0.1)
        assert stdout, "the worker never printed"
        [app_dir] = glob.glob(str(workdir / "application_*"))
        for argv in (["logs", app_dir, "worker:0", "--stream", "stdout"],
                     ["logs", app_dir, "worker:0", "--stream", "stdout",
                      "--max-bytes", "5"],
                     ["resize", app_dir, "worker", "3"],
                     ["rollout", app_dir]):
            said = {pkg: _cli(pkg, argv, tmp_path) for pkg in MODULES}
            assert (said["port"].returncode, said["port"].stdout) \
                == (said["jax"].returncode, said["jax"].stdout), argv
        logs = _cli("port", ["logs", app_dir, "worker:0", "--stream",
                             "stdout"], tmp_path)
        assert logs.returncode == 0
        assert logs.stdout == "line-one\nline-two\n"
    finally:
        release.write_text("go")
        try:
            _, stderr = proc.communicate(timeout=90)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]


# ---------------------------------------------------------------------------
# the fleet subcommands, the usage line
# ---------------------------------------------------------------------------

def _alerts_history(root) -> str:
    """A history dir with an event log (the JAX handler's), an alert
    bundle and a diagnostics bundle: what `alerts` renders."""
    from tony_tpu.events.handler import EventHandler
    from tony_tpu.events.history import JobMetadata, write_alerts_file
    from tony_tpu.events.schema import (
        AlertFiring, AlertResolved, Event, EventType,
    )
    hist = os.path.join(root, "history", "application_alerts_1")
    handler = EventHandler(hist, JobMetadata(
        application_id="application_alerts_1", started=1000))
    handler.start()
    handler.emit(Event(EventType.ALERT_FIRING, AlertFiring(
        rule_id="serve.queue_depth_burn", key="serving:0",
        severity="critical", scope="task", value=28.0, threshold=14.0,
        message="burning", for_ms=600), timestamp=5000))
    handler.emit(Event(EventType.ALERT_RESOLVED, AlertResolved(
        rule_id="serve.queue_depth_burn", key="serving:0",
        active_ms=4000), timestamp=9000))
    handler.stop("SUCCEEDED")
    write_alerts_file(hist, {
        "firing": [{"rule_id": "t.hot", "key": "serving:1",
                    "severity": "warning", "scope": "task",
                    "since_ms": 9500, "value": 9.0, "threshold": 5.0,
                    "message": "M 9.0 > 5.0 on serving:1", "flaps": 0}],
        "log": [{"ts_ms": 5000, "rule_id": "serve.queue_depth_burn",
                 "key": "serving:0", "status": "firing",
                 "severity": "critical", "scope": "task", "value": 28.0,
                 "threshold": 14.0, "message": "burning",
                 "suppressed": False, "for_ms": 600},
                {"ts_ms": 9000, "rule_id": "serve.queue_depth_burn",
                 "key": "serving:0", "status": "resolved",
                 "severity": "critical", "scope": "task", "value": 28.0,
                 "threshold": 14.0, "message": "", "suppressed": False,
                 "active_ms": 4000}],
        "rules": ["serve.queue_depth_burn", "t.hot"],
        "generated_ms": 9600})
    with open(os.path.join(hist, C.DIAGNOSTICS_FILE), "w") as f:
        json.dump({"first_failure": {"task_id": "serving:1", "attempt": 0,
                                     "ts_ms": 9700, "reason": "exit 1"}}, f)
    return hist


def _fleet_store(root) -> tuple[str, str, str]:
    """A staging location of published jobstates, and the two conf files
    `top --queues-conf` (a frozen conf) and `arbiter --queues-conf`
    (properties) read."""
    from tony_tpu.conf import TonyConfiguration
    from tony_tpu.observability import fleet
    from tony_tpu.storage import staging_store
    stage = os.path.join(root, "stage")
    now = int(time.time() * 1000)
    for app, state, chips, queue in (("app_serve", "RUNNING", 2, "prod"),
                                     ("app_train", "RUNNING", 4, "dev"),
                                     ("app_done", "SUCCEEDED", 8, "prod")):
        fleet.publish_job_state(
            staging_store(stage, os.path.join(root, "apps", app)),
            fleet.job_summary(app, "alice", queue, state, gang_width=2,
                              allocated_chips=chips, started_ms=now - 5000,
                              heartbeat_ms=now, goodput_pct=80.0,
                              serving_tokens_per_sec=(
                                  120.0 if app == "app_serve" else None)),
            root)
    top_conf = os.path.join(root, "queues.json")
    conf = TonyConfiguration()
    conf.set("tony.queues.prod.max-tpus", 4, "test")
    conf.set("tony.queues.dev.max-tpus", 8, "test")
    conf.write(top_conf)
    arb_conf = os.path.join(root, "arbiter.properties")
    with open(arb_conf, "w") as f:
        f.write("tony.arbiter.total-tpus=8\n"
                "tony.queues.prod.capacity-share=50\n"
                "tony.queues.dev.capacity-share=75\n")
    return stage, top_conf, arb_conf


@pytest.mark.parametrize("verb", ["alerts", "top", "arbiter", "router"])
def test_fleet_subcommands_print_alike(verb, tmp_path, monkeypatch):
    """`alerts` (offline, with its incident timeline), `top --once`,
    `arbiter` and `router --status` print the JAX CLI's text on the same
    inputs, with the wall clock held for `top`'s heartbeat ages."""
    root = str(tmp_path)
    stop = []
    if verb == "alerts":
        hist = _alerts_history(root)
        argvs = [[hist], [hist, "--json"],
                 [os.path.join(root, "nothing-here")]]
    elif verb == "top":
        stage, top_conf, _ = _fleet_store(root)
        argvs = [[stage, "--once"], [stage, "--once", "--queues-conf",
                                     top_conf]]
    elif verb == "arbiter":
        stage, _, arb_conf = _fleet_store(root)
        argvs = [[stage, "--chips", n, "--queue", q, "--queues-conf",
                  arb_conf] for n, q in (("1", "prod"), ("2", "dev"),
                                         ("6", "dev"))] + [[stage]]
    else:
        from tony_tpu_torch.serve.router import FleetRouter
        stubs = [_LoadStub(queue_depth=1, slots_free=1),
                 _LoadStub(queue_depth=0, slots_free=2,
                           kv_pages_total=64, kv_pages_free=16,
                           kv_hit_rate_pct=40.0, role="prefill")]
        rtr = FleetRouter([s.url for s in stubs], port=0,
                          host="127.0.0.1", probe_ttl_ms=30)
        rtr.start()
        stop = [rtr.stop] + [s.stop for s in stubs]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not all(
                e["load"] for e in rtr.endpoints()):
            time.sleep(0.05)
        argvs = [["--status", f"http://127.0.0.1:{rtr.port}"],
                 ["--status", "http://127.0.0.1:9"]]
    now = time.time() + 2.0
    outs = []
    try:
        for argv in argvs:
            said = {}
            for pkg in MODULES:
                monkeypatch.setattr(time, "time", lambda: now)
                said[pkg] = _in_process(pkg, verb, argv)
                monkeypatch.undo()
            assert said["port"][:2] == said["jax"][:2], argv
            assert said["port"][2].replace("tony_tpu_torch.cli",
                                           "tony_tpu.cli") == said["jax"][2]
            outs.append(said["port"])
    finally:
        for f in stop:
            f()
    rc, out, _ = outs[0]
    assert rc == 0 and out
    if verb == "router":
        assert out.count(" UP ") == 2
    if verb == "top":
        assert "2 live job(s), 6 chip(s) in use" in out


class _LoadStub:
    """A replica answering /v1/load with a fixed load."""

    def __init__(self, **load):
        body = json.dumps({"ok": True, "active_slots": 0, "n_slots": 2,
                           "draining": False, **load}).encode()

        class H(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.mark.parametrize("argv", [[], ["no-such-verb"]])
def test_usage_exits_2_alike(argv, tmp_path):
    said = {pkg: _in_process(pkg, "main", argv) for pkg in MODULES}
    assert said["port"][0] == said["jax"][0] == 2
    assert said["port"][2] == said["jax"][2].replace("tony_tpu.cli",
                                                     "tony_tpu_torch.cli")


# ---------------------------------------------------------------------------
# a job with no module of tony_tpu importable
# ---------------------------------------------------------------------------

def test_submit_runs_where_tony_tpu_cannot_be_imported(tmp_path):
    lone = tmp_path / "lone"
    shutil.copytree(os.path.join(REPO, "tony_tpu_torch"),
                    str(lone / "tony_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "_build",
                                                  "csrc"))
    probe = (f"{sys.executable} -c \"import importlib.util, sys; "
             f"sys.exit(importlib.util.find_spec('tony_tpu') is not None)\"")
    out = _cli("port", ["submit", "--executes", probe,
                        "--conf", "tony.worker.instances=1",
                        "--conf", f"tony.cluster.workdir={tmp_path}/work"]
               + FAST, tmp_path, pythonpath=str(lone))
    assert out.returncode == 0, out.stderr[-3000:]
    [line] = [m for m in (FINISHED.search(x) for x in
                          out.stderr.splitlines()) if m]
    assert line.group(2) == "SUCCEEDED"
    assert "tony_tpu_torch.client.tony_client" in out.stderr
