"""The port's workflow adapter against the JAX package's.

`TonyWorkflowJob` maps a workflow engine's flat properties to a job conf
file and the client's argv, then submits in process. The same props go
through both adapters: the conf entries, the `tony.json` bytes and the
argv (apart from the conf path) are equal; `run()` and `cancel()` end to
end give the same exit code, final status and AM record (event types in
order without TASK_FINISHED, the status, the first failure). The JAX
adapter launches `-m tony_tpu.am`, the port's `-m tony_tpu_torch.am`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import pytest

from tests.test_torch_am import Job
from tony_tpu.workflow import TonyWorkflowJob as JaxJob
from tony_tpu.workflow import adapter as jax_adapter
from tony_tpu_torch.workflow import TonyWorkflowJob as PortJob
from tony_tpu_torch.workflow import adapter as port_adapter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "tests", "scripts")
ADAPTERS = {"jax": JaxJob, "port": PortJob}

PROPS = {
    "tony.worker.instances": "2",
    "tony.am.memory": "1g",
    "type": "tony",                      # engine-internal, dropped
    "executes": "python train.py",
    "task_params": "--epochs 1",
    "src_dir": "/src",
    "hdfs_classpath": "/hdfs",           # no flag: dropped
    "python_venv": "venv.zip",
    "python_binary_path": "venv/bin/python",
}


def test_the_module_constants_are_the_jax_adapters():
    assert port_adapter.ARG_PROPS == jax_adapter.ARG_PROPS
    assert port_adapter.CONF_FILE_NAME == jax_adapter.CONF_FILE_NAME


@pytest.mark.parametrize("props", [
    PROPS,
    {"tony.worker.instances": "1"},
    {"executes": "x.py", "tony.b": "2", "tony.a": "1", "src_dir": ""},
], ids=["every-special", "conf-only", "empty-special"])
def test_conf_entries_conf_file_and_argv_are_the_jax_adapters(tmp_path,
                                                              props):
    jobs = {pkg: cls(props, working_dir=str(tmp_path / pkg))
            for pkg, cls in ADAPTERS.items()}
    entries = {pkg: job.tony_conf_entries() for pkg, job in jobs.items()}
    assert entries["port"] == entries["jax"]
    assert list(entries["port"]) == sorted(entries["port"])
    argv = {pkg: job.build_argv() for pkg, job in jobs.items()}
    for pkg, job in jobs.items():
        path = os.path.join(str(tmp_path / pkg), "tony.json")
        assert argv[pkg][:2] == ["--conf_file", path]
    assert argv["port"][2:] == argv["jax"][2:]
    with open(tmp_path / "jax" / "tony.json", "rb") as a, \
            open(tmp_path / "port" / "tony.json", "rb") as b:
        assert b.read() == a.read()


def test_the_working_dir_defaults_to_the_cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for cls in ADAPTERS.values():
        assert cls({}).working_dir == str(tmp_path)
        assert cls({}).client is None
        cls({}).cancel()                 # nothing submitted: a no-op


def _props(tmp_path, pkg: str, executes: str, **extra) -> dict:
    return {"tony.worker.instances": "1",
            "tony.cluster.workdir": str(tmp_path / pkg / "cluster"),
            "tony.task.heartbeat-interval-ms": "200",
            "tony.am.monitor-interval-ms": "200",
            "tony.am.stop-poll-timeout-ms": "2000",
            "executes": executes, **extra}


def _run_both(tmp_path, executes: str, cancel_after_registration=False):
    """The same props through both adapters at once (one thread each).
    Returns {pkg: (run()'s return, the job, its AM record)}."""
    out: dict = {}

    def one(pkg: str) -> None:
        job = ADAPTERS[pkg](_props(tmp_path, pkg, executes),
                            working_dir=str(tmp_path / pkg / "wd"))
        if cancel_after_registration:
            threading.Thread(target=_cancel_when_registered, args=(job,),
                             daemon=True).start()
        out[pkg] = [job.run(), job]

    threads = [threading.Thread(target=one, args=(pkg,))
               for pkg in ADAPTERS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=150)
    assert set(out) == set(ADAPTERS), out
    for pkg, (rc, job) in out.items():
        out[pkg].append(Job(job.client.app_dir, rc, "").record())
    return out


def _cancel_when_registered(job) -> None:
    """The engine's kill once worker:0 has registered with the AM."""
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        client = job.client
        if client is not None and any(
                i.task_id == "worker:0" and i.status.value == "RUNNING"
                for i in client.get_task_infos()):
            job.cancel()
            return
        time.sleep(0.1)


def test_run_trains_a_port_job_alike(tmp_path):
    """The port's trainer as the task: 0 under both adapters."""
    runs = _run_both(tmp_path, f"{sys.executable} -m tony_tpu_torch.train "
                               f"--device cpu --config tiny --steps 2 "
                               f"--batch-size 2 --seq-len 16")
    for pkg, (rc, job, record) in runs.items():
        assert rc == 0, (pkg, job.client.final_message)
        assert job.client.final_status == "SUCCEEDED"
        with open(os.path.join(job.client.app_dir, "containers",
                               "worker_0_s0", "stdout")) as f:
            assert "final loss " in f.read()
    assert runs["port"][2] == runs["jax"][2]
    assert runs["port"][2]["events"] == [
        "APPLICATION_INITED", "TASK_STARTED", "APPLICATION_FINISHED"]


def test_run_propagates_a_failure_alike(tmp_path):
    runs = _run_both(tmp_path, os.path.join(SCRIPTS, "exit_1.py"))
    for pkg, (rc, job, record) in runs.items():
        assert rc == 1, pkg
        assert job.client.final_status == "FAILED"
    assert runs["port"][2] == runs["jax"][2]
    assert runs["port"][2]["first_failure"]["exit_code"] == 1


def test_cancel_after_registration_ends_the_job_alike(tmp_path):
    runs = _run_both(tmp_path, os.path.join(SCRIPTS, "sleep_30.py"),
                     cancel_after_registration=True)
    statuses = {pkg: job.client.final_status
                for pkg, (_, job, _) in runs.items()}
    assert {pkg: rc for pkg, (rc, _, _) in runs.items()} == {
        "jax": 1, "port": 1}
    assert statuses == {"jax": "KILLED", "port": "KILLED"}
    assert runs["port"][2] == runs["jax"][2]


WORKFLOW_ISOLATION_PROBE = """
import sys
import tony_tpu_torch.workflow
bad = sorted({n.split(".")[0] for n in sys.modules}
             & {"torch", "jax", "jaxlib", "tony_tpu", "grpc"})
print(",".join(bad))
"""


def test_the_adapter_imports_no_torch_jax_grpc_or_tony_tpu():
    out = subprocess.run([sys.executable, "-c", WORKFLOW_ISOLATION_PROBE],
                         capture_output=True, text=True, timeout=60,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
