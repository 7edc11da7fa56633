"""The port's task executor, on the CPU, against the JAX package's.

- The executor's unit cases of the JAX package (heartbeat jitter, the
  spec-diff respec, the refetch verdict, no heartbeater, a stale diff),
  run on both executor classes.
- The TaskLogService: the JAX package's AM-side client reads the port
  executor's live tail and stacks behind the task's token, and a wrong
  token is refused.
- A whole job under the JAX package's real AM, in this process: a
  backend that launches ``-m tony_tpu_torch.executor`` in place of ``-m
  tony_tpu.executor`` (a swap on the test side; the AM is unchanged). Two
  pytorch workers train `tiny` on gloo; both report 0, and the AM's task
  events and metric names equal those of the same job under the JAX
  executors. A worker whose command exits 3 is reported as 3 by both,
  with the same diagnostics.
- Isolation: importing the executor loads neither torch, nor jax, nor
  grpc.
"""

import os
import subprocess
import sys
import time

import grpc
import pytest

from tony_tpu import constants as JC
from tony_tpu.executor import task_executor as jexec
from tony_tpu.rpc.client import TaskLogServiceClient as JaxLogClient
from tony_tpu.security.tokens import derive_task_token
from tony_tpu_torch import constants as C
from tony_tpu_torch.executor import task_executor as pexec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXECUTORS = {"jax": jexec, "port": pexec}


# ---------------------------------------------------------------------------
# the JAX package's executor unit cases, on both classes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", sorted(EXECUTORS))
def test_heartbeat_jitter_deterministic_and_spread(which):
    jitter = EXECUTORS[which].heartbeat_jitter_sec
    phases = [jitter(i, 1.0) for i in range(1024)]
    assert phases == [jexec.heartbeat_jitter_sec(i, 1.0)
                      for i in range(1024)]
    assert all(0.0 <= p < 1.0 for p in phases)
    buckets = [0] * 10
    for p in phases:
        buckets[int(p * 10)] += 1
    assert max(buckets) <= 2 * (1024 // 10), buckets
    assert jitter(0, 1.0) == 0.0


@pytest.mark.parametrize("removed", [None, {"worker": [2]}, {"ps": [0]}])
def test_apply_spec_diff_equals_jax(removed):
    spec = {"worker": ["h0:1", "h1:2", "h2:3"], "ps": ["p0:9"]}
    changed = {"worker": {"1": "r1:7", "4": "n4:8"}}
    assert pexec.apply_spec_diff(spec, changed, removed) \
        == jexec.apply_spec_diff(spec, changed, removed)


def _executor(which, env_extra=None):
    env = {JC.JOB_NAME: "worker", JC.TASK_INDEX: "0", JC.TASK_NUM: "2",
           JC.AM_HOST: "127.0.0.1", JC.AM_PORT: "1",
           JC.TASK_COMMAND: "true"}
    env.update(env_extra or {})
    return EXECUTORS[which].TaskExecutor(env=env)


def _close(ex):
    ex.client.close()
    ex.metrics_client.close()


class _AliveHB:
    _silent = False

    def is_alive(self):
        return True


@pytest.mark.parametrize("which", sorted(EXECUTORS))
def test_executor_applies_diff_without_reregister(which, monkeypatch):
    """A survivor whose heartbeater delivered the diff re-joins the gang
    by patching its held spec: register_worker_spec is never called."""
    ex = _executor(which)
    ex.heartbeater = _AliveHB()
    ex._cluster_spec = {"worker": ["h0:1000", "h1:1001"]}
    ex._spec_generation = 1
    monkeypatch.setattr(
        ex, "register_and_get_cluster_spec",
        lambda: pytest.fail("survivor re-polled the rendezvous barrier"))
    ex._on_spec_diff({"generation": 2,
                      "changed": {"worker": {"1": "r1:2001"}}})
    assert ex._respec_pending or ex._latest_generation == 2
    spec = ex._await_respec_spec()
    assert spec == {"worker": ["h0:1000", "r1:2001"]}
    assert ex._spec_generation == 2 and not ex._respec_pending
    _close(ex)


@pytest.mark.parametrize("which", sorted(EXECUTORS))
def test_executor_refetch_verdict_falls_back(which):
    ex = _executor(which)
    ex.heartbeater = _AliveHB()
    ex._cluster_spec = {"worker": ["h0:1000", "h1:1001"]}
    ex._spec_generation = 1
    ex._on_generation(2)
    ex._on_spec_refetch()
    assert ex._await_respec_spec() is None
    _close(ex)


@pytest.mark.parametrize("which", sorted(EXECUTORS))
def test_executor_without_heartbeater_skips_diff_wait(which):
    ex = _executor(which)
    assert ex._await_respec_spec() is None
    _close(ex)


@pytest.mark.parametrize("which", sorted(EXECUTORS))
def test_stale_diff_is_ignored(which):
    ex = _executor(which)
    ex.heartbeater = _AliveHB()
    ex._cluster_spec = {"worker": ["h0:1000"]}
    ex._spec_generation = 3
    ex._on_spec_diff({"generation": 2, "changed": {"worker": {"0": "x:1"}}})
    assert ex._pending_diff is None and not ex._respec_pending
    _close(ex)


@pytest.mark.parametrize("which", sorted(EXECUTORS))
def test_executor_reads_the_same_env_and_conf(which, tmp_path):
    """The same env and frozen conf give both executors the same
    identity, cadences and budgets."""
    from tony_tpu.conf import TonyConfiguration
    conf = TonyConfiguration()
    for k, v in {"tony.application.framework": "pytorch",
                 "tony.task.heartbeat-interval-ms": "300ms",
                 "tony.task.metrics-interval-ms": "2s",
                 "tony.task.hb-failure-budget": 3,
                 "tony.task.term-grace-ms": 4000,
                 "tony.logs.tail-bytes": 4096}.items():
        conf.set(k, v, "test")
    path = str(tmp_path / "tony-final.json")
    conf.write(path)
    env = {JC.TONY_CONF_PATH: path, JC.IS_CHIEF: "true", JC.SESSION_ID: "4",
           JC.TASK_ATTEMPT: "2", JC.METRICS_RPC_PORT: "7",
           JC.ELASTIC_MESH_SHAPE: "2,1"}
    got, want = _executor(which, env), _executor("jax", env)
    fields = ("task_id", "task_num", "is_chief", "session_id",
              "task_attempt", "metrics_port", "framework", "hb_interval_sec",
              "metrics_interval_sec", "registration_timeout_sec",
              "HB_FAILURE_BUDGET", "_orphan_grace_sec", "_term_grace_sec",
              "_mesh_override", "_log_tail_bytes", "_diag_lines")
    assert {f: getattr(got, f) for f in fields} \
        == {f: getattr(want, f) for f in fields}
    for ex in (got, want):
        _close(ex)


@pytest.mark.parametrize("which", sorted(EXECUTORS))
def test_drain_ask_terms_the_user_process_once(which, tmp_path,
                                               monkeypatch):
    """A heartbeat's drain ask TERMs the user process group (its trap
    runs) and marks the run drained; a second ask is a no-op."""
    from tony_tpu.utils import shell as jshell
    from tony_tpu_torch.utils import shell as pshell
    monkeypatch.chdir(tmp_path)
    ex = _executor(which)
    shell = pshell if which == "port" else jshell
    ex._user_proc = shell.launch_shell(
        "trap 'exit 7' TERM; touch trapped; sleep 30 & wait",
        cwd=str(tmp_path))
    deadline = time.monotonic() + 10
    while not (tmp_path / "trapped").exists() \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    ex._on_drain_request({"grace_ms": 10_000, "reason": "test"})
    assert ex._user_proc.wait(timeout=20) == 7
    assert ex._drain_requested
    ex._on_drain_request({"grace_ms": 0})
    _close(ex)


@pytest.mark.parametrize("which", sorted(EXECUTORS))
def test_resize_ask_quiesces_and_acks(which):
    """A survivor's resize ask with no user process running: the mesh
    override is taken, the re-entry armed and the id acked; an older id
    is ignored."""
    ex = _executor(which)
    ex._on_resize_request({"id": 3, "mesh_shape": "4,1", "grace_ms": 0})
    deadline = time.monotonic() + 10
    while ex._resize_ack != 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert (ex._resize_ack, ex._mesh_override, ex._respec_pending,
            ex._resize_release) == (3, "4,1", True, False)
    ex._on_resize_request({"id": 2, "release": True})
    assert not ex._resize_release
    _close(ex)


def test_hooks_and_reports_equal_jax(tmp_path, monkeypatch):
    """The profile-request relay file, the TEST_TRAINER_STEP_DELAY env and
    a failing exit's diagnostics are the JAX executor's."""
    monkeypatch.setenv(JC.TEST_TRAINER_STEP_DELAY, "worker#0#25#*")
    out = {}
    for which in EXECUTORS:
        d = tmp_path / which
        d.mkdir()
        (d / "stderr").write_text("Traceback (most recent call last):\n"
                                  "ModuleNotFoundError: No module named "
                                  "'x'\n")
        monkeypatch.chdir(d)
        ex = _executor(which)
        ex._on_profile_request({"request_id": "r7", "num_steps": 3})
        with open(d / JC.PROFILE_REQUEST_FILE) as f:
            relay = f.read()
        env = {}
        ex._step_delay_if_testing(env)
        out[which] = (relay, env, ex._failure_diagnostics(1))
        _close(ex)
    assert out["port"] == out["jax"]
    assert out["port"][1] == {JC.TRAINER_STEP_DELAY_MS: "25"}
    assert out["port"][2]["signature"] == "import_error"


# ---------------------------------------------------------------------------
# the TaskLogService behind the task token
# ---------------------------------------------------------------------------

def test_task_log_service_serves_the_jax_reader(tmp_path, monkeypatch):
    secret = "5e" * 32
    token = derive_task_token(secret, "worker:0")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "stderr").write_text("booting\nTONY_SECURITY_TOKEN=" + token
                                     + "\nready\n")
    ex = _executor("port", {JC.JOB_NAME: "worker", "TONY_SECURITY_TOKEN":
                            token})
    ex._start_log_service()
    try:
        assert ex._log_port > 0 and ex.log_addr.endswith(
            f":{ex._log_port}")
        reader = JaxLogClient("127.0.0.1", ex._log_port, auth_token=token,
                              task_auth_id="worker:0")
        chunk = reader.read_log("stderr")
        assert chunk["data"] == ("booting\nTONY_SECURITY_TOKEN=<redacted>\n"
                                 "ready\n")
        assert chunk["task_id"] == "worker:0" and chunk["stream"] == "stderr"
        assert reader.read_log("nope") == {"error": "unknown stream 'nope'"}
        stacks = reader.read_stacks()
        assert stacks["task_id"] == "worker:0" and any(
            t["name"] == "MainThread" for t in stacks["threads"])
        reader.close()
        wrong = JaxLogClient("127.0.0.1", ex._log_port, auth_token="0" * 64)
        with pytest.raises(grpc.RpcError) as err:
            wrong.read_log("stderr")
        assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
        wrong.close()
    finally:
        ex._stop_log_service()
        _close(ex)


# ---------------------------------------------------------------------------
# a whole job under the JAX package's real AM
# ---------------------------------------------------------------------------

def _run_job(tmp_path, executor: str, command: str, workers: int = 2,
             am: str = "jax"):
    """One job of pytorch workers under an in-process AM. With the JAX
    package's AM (`am="jax"`), its local backend launches `executor`'s
    package; the port's AM launches the port's executor. Returns
    (succeeded, events, app dir)."""
    if am == "port":
        from tony_tpu_torch.am.application_master import ApplicationMaster
        from tony_tpu_torch.cluster.local import LocalClusterBackend
        from tony_tpu_torch.conf import TonyConfiguration
        from tony_tpu_torch.events.handler import parse_events
    else:
        from tony_tpu.am.application_master import ApplicationMaster
        from tony_tpu.cluster.local import LocalClusterBackend
        from tony_tpu.conf import TonyConfiguration
        from tony_tpu.events.handler import parse_events

    class _Backend(LocalClusterBackend):
        def launch_container(self, container, cmd, env, cwd):
            if executor == "port" \
                    and list(cmd[-2:]) == ["-m", "tony_tpu.executor"]:
                cmd = list(cmd[:-1]) + ["tony_tpu_torch.executor"]
            super().launch_container(container, cmd, env, cwd)

    conf = TonyConfiguration()
    for k, v in {"tony.worker.instances": workers,
                 "tony.application.framework": "pytorch",
                 "tony.task.command": command,
                 "tony.am.monitor-interval-ms": 100,
                 "tony.task.heartbeat-interval-ms": 200,
                 "tony.task.metrics-interval-ms": 300,
                 "tony.task.registration-timeout-sec": 60,
                 "tony.am.stop-poll-timeout-ms": 3000}.items():
        conf.set(k, v, "test")
    app_id = f"app_{executor}" if am == "jax" else f"app_{am}_am"
    app_dir = str(tmp_path / app_id)
    os.makedirs(app_dir)
    conf.write(os.path.join(app_dir, JC.TONY_FINAL_CONF))
    am_ = ApplicationMaster(conf, app_id, app_dir,
                            backend=_Backend(app_id=app_id))
    ok = am_.run()
    hist = os.path.join(app_dir, JC.HISTORY_DIR_NAME)
    finals = [os.path.join(d, f) for d, _, files in os.walk(hist)
              for f in files if f.endswith(".jhist")]
    assert len(finals) == 1, finals
    return ok, parse_events(finals[0]), app_dir


def _task_view(events) -> dict:
    """Per task: its events in order and the metric names each carries
    (the executor-side view; app-level events are listed apart)."""
    tasks: dict = {}
    app = []
    for e in events:
        p = e.payload
        names = sorted({m.get("name") for m in getattr(p, "metrics", None)
                        or []})
        if hasattr(p, "task_type"):
            tasks.setdefault((p.task_type, p.task_index), []).append(
                (e.type.name, getattr(p, "status", None), names))
        else:
            app.append((e.type.name, getattr(p, "status", None), names))
    return {"tasks": tasks, "app": app}


def test_gang_job_under_the_jax_am_reports_as_the_jax_executors(tmp_path):
    command = (f"{sys.executable} -m tony_tpu_torch.train --device cpu "
               f"--config tiny --steps 2 --batch-size 2 --seq-len 32 "
               f"--log-every 1")
    views = {}
    for executor in ("jax", "port"):
        ok, events, app_dir = _run_job(tmp_path, executor, command)
        assert ok, f"{executor} executors' job failed"
        views[executor] = _task_view(events)
    port, jax_view = views["port"], views["jax"]
    assert set(port["tasks"]) == {("worker", 0), ("worker", 1)}
    for task, seq in port["tasks"].items():
        assert seq[-1][:2] == ("TASK_FINISHED", "SUCCEEDED"), seq
        assert {"MAX_MEMORY_BYTES", "TRAIN_STEP_TIME_MS",
                "GOODPUT_RENDEZVOUS_WAIT_SECONDS"} <= set(seq[-1][2])
    assert port == jax_view
    # rank 0 trained, through the port executor's rendered rendezvous
    with open(os.path.join(app_dir, JC.CONTAINERS_DIR_NAME, "worker_0_s0",
                           "stdout")) as f:
        assert "final loss" in f.read()


def test_gang_job_under_the_port_am_reports_as_under_the_jax_am(tmp_path):
    """The same 2-worker gang of the port's trainer under the port's AM
    (which launches the port's executor) and under the JAX package's AM
    with the port's executor: both succeed, rank 0 trains, and each
    task's events agree. A task's last TASK_FINISHED is compared only
    where both AMs emitted it, and the application's events by type and
    status: whether an AM emits that event and takes the last metrics
    push before it stops is the JAX AM's race, which the port's copy
    keeps."""
    command = (f"{sys.executable} -m tony_tpu_torch.train --device cpu "
               f"--config tiny --steps 2 --batch-size 2 --seq-len 32 "
               f"--log-every 1")
    views = {}
    for am in ("jax", "port"):
        ok, events, app_dir = _run_job(tmp_path, "port", command, am=am)
        assert ok, f"the job under the {am} AM failed"
        views[am] = _task_view(events)
        with open(os.path.join(app_dir, JC.CONTAINERS_DIR_NAME,
                               "worker_0_s0", "stdout")) as f:
            assert "final loss" in f.read()
    port, jax_ = views["port"], views["jax"]
    assert set(port["tasks"]) == set(jax_["tasks"]) \
        == {("worker", 0), ("worker", 1)}
    assert [e[:2] for e in port["app"]] == [e[:2] for e in jax_["app"]]
    for task, seq in port["tasks"].items():
        other = jax_["tasks"][task]
        assert [e for e in seq if e[0] != "TASK_FINISHED"] \
            == [e for e in other if e[0] != "TASK_FINISHED"], (seq, other)
        finished = [e for e in seq if e[0] == "TASK_FINISHED"]
        if finished and other[-1][0] == "TASK_FINISHED":
            assert finished[-1] == other[-1]
            assert finished[-1][1] == "SUCCEEDED"
            assert {"MAX_MEMORY_BYTES", "TRAIN_STEP_TIME_MS",
                    "GOODPUT_RENDEZVOUS_WAIT_SECONDS"} <= set(finished[-1][2])


def test_an_exit_code_is_reported_as_by_the_jax_executor(tmp_path):
    """A worker whose command exits 3: the AM records the executor's
    report, exit code and classified diagnostics, as it does the JAX
    executor's. (Whether its TASK_FINISHED event and a metrics push land
    before the AM stops is the AM's race, under either executor.)"""
    import json
    seen = {}
    for executor in ("jax", "port"):
        ok, events, app_dir = _run_job(tmp_path, executor, "exit 3",
                                       workers=1)
        assert not ok
        diag = [vars(e.payload) for e in events
                if e.type.name == "DIAGNOSTICS_READY"]
        assert len(diag) == 1 and diag[0]["exit_code"] == 3, diag
        with open(os.path.join(app_dir, JC.HISTORY_DIR_NAME, f"app_{executor}",
                               JC.DIAGNOSTICS_FILE)) as f:
            bundle = json.load(f)
        first = bundle["first_failure"]
        seen[executor] = (
            {k: v for k, v in diag[0].items() if k != "application_id"},
            {k: first.get(k) for k in ("task_id", "attempt", "exit_code",
                                       "signal", "reason", "source")})
    assert seen["port"] == seen["jax"]
    assert seen["port"][1]["source"] == "executor"


# ---------------------------------------------------------------------------
# isolation
# ---------------------------------------------------------------------------

def test_executor_imports_no_torch_jax_or_grpc():
    probe = (
        "import sys\n"
        "import tony_tpu_torch.executor.task_executor\n"
        "import tony_tpu_torch.executor.__main__\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'torch', 'jax', 'jaxlib', 'grpc', 'tony_tpu'}))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=60, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_exit_codes_and_hooks_are_the_jax_names():
    for name in ("EXIT_SUCCESS", "EXIT_FAILURE", "EXIT_HEARTBEAT_FAILURE",
                 "EXIT_RENDEZVOUS_TIMEOUT", "EXIT_PREEMPTED",
                 "EXIT_KILLED_BY_AM", "MAX_CONSECUTIVE_FAILED_HEARTBEATS",
                 "TEST_TASK_EXECUTOR_NUM_HB_MISS", "TEST_TASK_EXECUTOR_SKEW",
                 "TEST_TASK_KILL", "TEST_TASK_HB_SILENCE", "TEST_TASK_WEDGE",
                 "TEST_TRAINER_STEP_DELAY", "TASK_COMMAND", "TASK_NUM",
                 "SESSION_ID", "CONTAINER_ID", "APP_ID", "ATTEMPT_NUMBER",
                 "TONY_APP_DIR", "TONY_CONF_URI", "MODEL_PARAMS",
                 "ELASTIC_MESH_SHAPE", "TF_CONFIG", "DMLC_ROLE",
                 "FRAMEWORK_PYTORCH", "SPEC_GENERATION", "AM_HOSTPORT_FILE"):
        assert getattr(C, name) == getattr(JC, name), name
