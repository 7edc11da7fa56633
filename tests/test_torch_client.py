"""The port's submission client against the JAX package's.

- `TonyClient.init` on the same argv freezes the same `tony-final.json`
  (the version stamp's entries are each package's own reading of the
  same checkout; every other entry byte for byte), builds the same task
  command and raises the same validation errors.
- `render_event` gives every event type the JAX package's line of text.
- The client-side helpers the port gained (zip and staging, tokens,
  polling, env parsing) equal the JAX ones.
- The application-side RPC calls (the client's and the CLI's) send the
  JAX client's payloads to the JAX AM's real RPC server.
- A job staged through `tony.staging.location`, submitted by each
  package's client to its own AM: the same record, the conf read by the
  AM from the store, and `fleet/jobstate.json` published with the JAX
  package's keys.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import stat
import sys
import threading
import zipfile

import pytest

from tony_tpu import version as jversion
from tony_tpu.client.tony_client import TonyClient as JaxClient
from tony_tpu.events import render as jrender
from tony_tpu.events import schema as jschema
from tony_tpu.events.handler import parse_events
from tony_tpu.observability.fleet import job_summary as jax_job_summary
from tony_tpu.rpc.client import ClusterServiceClient as JaxRpc
from tony_tpu.rpc.service import serve as jax_rpc_serve
from tony_tpu.security import tokens as jtokens
from tony_tpu.utils import common as jcommon
from tony_tpu.utils import fs as jfs
from tony_tpu.utils import localization as jloc
from tony_tpu_torch import constants as C
from tony_tpu_torch import version as pversion
from tony_tpu_torch.client.tony_client import TonyClient as PortClient
from tony_tpu_torch.events import render as prender
from tony_tpu_torch.events import schema as pschema
from tony_tpu_torch.rpc.client import ClusterServiceClient as PortRpc
from tony_tpu_torch.security import tokens as ptokens
from tony_tpu_torch.utils import common as pcommon
from tony_tpu_torch.utils import fs as pfs
from tony_tpu_torch.utils import localization as ploc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENTS = {"jax": JaxClient, "port": PortClient}
STAMP = {"tony.version", "tony.version.git-ref", "tony.version.user",
         "tony.version.build-time"}


def _init(pkg: str, argv: list[str]):
    client = CLIENTS[pkg]()
    client.init(argv)
    return client


def _frozen(client, path: str) -> dict:
    client.conf.write(path)
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# init: the frozen conf, the task command, the validation errors
# ---------------------------------------------------------------------------

ARGVS = {
    "plain": ["--executes", "train.py",
              "--conf", "tony.worker.instances=2"],
    "conf-file": ["--executes", "python -m trainer", "--conf_file", "{conf}",
                  "--conf", "tony.ps.instances=1"],
    "flags": ["--executes", "train.py", "--task_params", "--lr 0.1",
              "--app_name", "nightly", "--queue", "research",
              "--shell_env", "A=1", "--shell_env", "B=x=y",
              "--src_dir", "{src}", "--python_binary_path", "bin/python",
              "--conf", "tony.worker.gpus=1"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_the_frozen_conf_is_the_jax_clients(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "src").mkdir()
    (tmp_path / "job.json").write_text(json.dumps(
        {"tony.worker.instances": 3, "tony.application.framework":
         "pytorch"}))
    argv = [a.format(conf=tmp_path / "job.json", src=tmp_path / "src")
            for a in ARGVS[case]]
    jax_ = _frozen(_init("jax", argv), str(tmp_path / "jax.json"))
    port = _frozen(_init("port", argv), str(tmp_path / "port.json"))
    for key in STAMP:
        assert port["sources"].pop(key) == jax_["sources"].pop(key) \
            == "version-info"
        jax_["values"].pop(key)
    assert port["values"].pop("tony.version") == pversion.VERSION \
        == jversion.VERSION
    assert port["values"].pop("tony.version.git-ref") == pversion._git_ref()
    assert port["values"].pop("tony.version.user") == pversion._user()
    assert port["values"].pop("tony.version.build-time") \
        == pversion._build_time()
    assert json.dumps(port, sort_keys=True) == json.dumps(jax_,
                                                          sort_keys=True)


TASK_COMMANDS = {
    "python-file": ["--executes", "{script}"],
    "relative-file": ["--executes", "train.py"],
    "module": ["--executes", "python -m trainer --x 1"],
    "task-params": ["--executes", "{script}", "--task_params", "--a b"],
    "command-params": ["--executes", "./run.sh", "--task_params", "--a b"],
    "venv": ["--executes", "train.py", "--python_venv", "{venv}",
             "--python_binary_path", "bin/python3"],
    "src-dir": ["--executes", "train.py", "--src_dir", "{src}"],
    "none": [],
}


@pytest.mark.parametrize("case", sorted(TASK_COMMANDS))
def test_the_task_command_is_the_jax_clients(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "train.py").write_text("print(1)\n")
    (tmp_path / "venv.zip").write_bytes(b"")
    (tmp_path / "src").mkdir()
    argv = [a.format(script=tmp_path / "train.py", venv=tmp_path / "venv.zip",
                     src=tmp_path / "src") for a in TASK_COMMANDS[case]]
    commands = {pkg: _init(pkg, argv).task_command for pkg in CLIENTS}
    assert commands["port"] == commands["jax"]
    if case == "relative-file":
        assert commands["port"] == f"{sys.executable} {tmp_path}/train.py"


INVALID = {
    "instances-over-max": {"tony.worker.instances": 3,
                           "tony.worker.max-instances": 2},
    "total-instances": {"tony.worker.instances": 3, "tony.ps.instances": 2,
                        "tony.application.max-total-instances": 4},
    "total-tpus": {"tony.worker.instances": 2, "tony.worker.tpus": 4,
                   "tony.application.max-total-tpus": 4},
    "total-gpus": {"tony.worker.instances": 2, "tony.worker.gpus": 2,
                   "tony.application.max-total-gpus": 3},
    "queue-quota": {"tony.worker.instances": 2, "tony.worker.tpus": 4,
                    "tony.application.queue": "research",
                    "tony.queues.research.max-tpus": 4},
    "unknown-queue": {"tony.worker.instances": 1,
                      "tony.application.queue": "nope",
                      "tony.queues.research.max-tpus": 4},
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validation_errors_are_the_jax_clients(case):
    argv = []
    for k, v in INVALID[case].items():
        argv += ["--conf", f"{k}={v}"]
    errors = {}
    for pkg in CLIENTS:
        with pytest.raises(ValueError) as ei:
            _init(pkg, argv)
        errors[pkg] = str(ei.value)
    assert errors["port"] == errors["jax"]


def test_unknown_arguments_are_refused_alike():
    errors = {}
    for pkg in CLIENTS:
        with pytest.raises(ValueError) as ei:
            _init(pkg, ["--executes", "x", "--bogus", "1"])
        errors[pkg] = str(ei.value)
    assert errors["port"] == errors["jax"] == "unknown arguments: " \
                                              "['--bogus', '1']"


# ---------------------------------------------------------------------------
# events/render.py
# ---------------------------------------------------------------------------

def _value(f: dataclasses.Field, salt: int):
    kind = str(f.type)
    if kind.startswith("list"):
        return [f"v{salt}", f"w{salt}"]
    if kind.startswith("dict"):
        return {"k": salt}
    if kind == "bool":
        return bool(salt % 2)
    if kind == "int":
        return 100 + salt
    if kind == "float":
        return salt + 0.25
    return f"{f.name}-{salt}"


@pytest.mark.parametrize("etype", [t.value for t in jschema.EventType])
def test_every_event_renders_as_the_jax_package(etype):
    cls = pschema._PAYLOADS[pschema.EventType(etype)]
    full = {f.name: _value(f, i)
            for i, f in enumerate(dataclasses.fields(cls))}
    for payload in (full, {}, None):
        port = prender.render_event(pschema.EventType(etype), payload)
        assert port == jrender.render_event(jschema.EventType(etype),
                                            payload)
        assert port == prender.render_event(etype, payload)
    assert prender.render_event("NO_SUCH_EVENT", {"a": 1}) \
        == jrender.render_event("NO_SUCH_EVENT", {"a": 1})


# ---------------------------------------------------------------------------
# the client-side helpers
# ---------------------------------------------------------------------------

def _tree(root):
    (root / "pkg" / "sub").mkdir(parents=True)
    (root / "pkg" / "a.py").write_text("A = 1\n")
    (root / "pkg" / "sub" / "b.txt").write_bytes(bytes(range(256)))


def test_zip_dir_and_stage_resource_equal_jax(tmp_path):
    _tree(tmp_path)
    zips = {}
    for pkg, fs in (("jax", jfs), ("port", pfs)):
        path = fs.zip_dir(str(tmp_path / "pkg"), str(tmp_path / pkg / "x.zip"))
        with zipfile.ZipFile(path) as zf:
            zips[pkg] = sorted((i.filename, zf.read(i)) for i in zf.infolist())
    assert zips["port"] == zips["jax"]
    assert [n for n, _ in zips["port"]] == ["a.py", "sub/b.txt"]
    for spec in (f"{tmp_path}/pkg", f"{tmp_path}/pkg/a.py::main.py",
                 f"{tmp_path}/pkg/sub/b.txt#archive"):
        staged = {pkg: loc.stage_resource(spec, str(tmp_path / f"st_{pkg}"))
                  for pkg, loc in (("jax", jloc), ("port", ploc))}
        assert staged["port"].replace("st_port", "st_jax") == staged["jax"]
    with pytest.raises(FileNotFoundError):
        ploc.stage_resource(f"{tmp_path}/missing", str(tmp_path / "st"))
    d = tmp_path / "clean"
    (d / "old").mkdir(parents=True)
    assert pfs.ensure_clean_dir(str(d)) == str(d) and os.listdir(d) == []


def test_tokens_equal_jax(tmp_path):
    secret = ptokens.generate_token()
    assert len(secret) == 64 and int(secret, 16) >= 0
    assert secret != ptokens.generate_token()
    for name in ("portal", "notebook"):
        assert ptokens.derive_proxy_token(secret, name) \
            == jtokens.derive_proxy_token(secret, name)
        assert ptokens.derive_proxy_token(secret, name) \
            != ptokens.derive_task_token(secret, name)
    path = ptokens.write_token_file(str(tmp_path), secret)
    assert path == os.path.join(str(tmp_path), jtokens.TOKEN_FILE)
    assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
    assert jtokens.read_token_file(str(tmp_path)) == secret


def test_poll_and_env_parsing_equal_jax():
    entries = ["A=1", "B=x=y", "", " C =", "D"]
    assert pcommon.parse_env_list(entries) == jcommon.parse_env_list(entries)
    for mod in (pcommon, jcommon):
        seen = []
        assert mod.poll(lambda: seen.append(1) or len(seen) >= 3, 0.001, 5)
        assert not mod.poll(lambda: False, 0.001, 0.01)
        vals = iter([None, None, 7])
        assert mod.poll_till_non_null(lambda: next(vals), 0.001, 5) == 7
        assert mod.poll_till_non_null(lambda: None, 0.001, 0.01) is None


# ---------------------------------------------------------------------------
# the application-side RPC calls, against the JAX AM's real server
# ---------------------------------------------------------------------------

class _Recorder:
    """Duck-typed handler for every cluster method: records (method,
    request) and answers {} (a list for get_task_infos)."""

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()

    def __getattr__(self, method):
        if method.startswith("_"):
            raise AttributeError(method)

        def handler(req):
            with self._lock:
                self.calls.append((method, req))
            return [] if method == "get_task_infos" else {}
        return handler


def _app_calls(client) -> None:
    assert client.get_task_infos() == []
    client.finish_application()
    client.read_task_logs("worker:0", "stdout", 12, 4096)
    client.request_preemption(grace_ms=500, reason="r", requested_by="op")
    client.request_profile(task_id="worker:1", num_steps=3)
    client.request_resize(job_name="worker", width=4, grace_ms=10,
                          reason="grow", session_attempt=1)
    client.request_rolling_update(generation=2)
    client.get_profile()
    client.get_skew()
    client.get_alerts()


def test_application_calls_send_the_jax_clients_payloads():
    got = {}
    for pkg, cls in (("jax", JaxRpc), ("port", PortRpc)):
        rec = _Recorder()
        server, port = jax_rpc_serve(cluster_handler=rec,
                                     metrics_handler=rec, host="127.0.0.1",
                                     auth_token="s3cret")
        client = cls("127.0.0.1", port, auth_token="s3cret", retries=2,
                     retry_sleep_sec=0.05)
        try:
            _app_calls(client)
        finally:
            client.close()
            server.stop(grace=None)
        got[pkg] = rec.calls
    assert got["port"] == got["jax"]
    assert [m for m, _ in got["port"]] == [
        "get_task_infos", "finish_application", "read_task_logs",
        "request_preemption", "request_profile", "request_resize",
        "request_rolling_update", "get_profile", "get_skew", "get_alerts"]


@pytest.mark.parametrize("seed", ["1", "2"])
def test_the_retry_backoff_is_the_jax_clients(seed, monkeypatch):
    monkeypatch.setenv("TONY_TEST_SEED", seed)
    delays = {}
    for pkg, cls in (("jax", JaxRpc), ("port", PortRpc)):
        client = cls("127.0.0.1", 1, retry_sleep_sec=0.1,
                     retry_max_sleep_sec=0.8)
        delays[pkg] = [client._backoff_sec(a) for a in range(6)]
        client.close()
    assert delays["port"] == delays["jax"]


# ---------------------------------------------------------------------------
# a staged job, each package's client to its own AM
# ---------------------------------------------------------------------------

FAST = ["--conf", "tony.am.monitor-interval-ms=100",
        "--conf", "tony.task.heartbeat-interval-ms=200",
        "--conf", "tony.task.metrics-interval-ms=300",
        "--conf", "tony.am.stop-poll-timeout-ms=0",
        "--conf", "tony.fleet.publish-interval-ms=200"]

JOBSTATE_KEYS = sorted(jax_job_summary("a", "u", "q", "RUNNING"))


def _staged_job(pkg: str, tmp_path, monkeypatch) -> dict:
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    root = tmp_path / pkg
    (root / "src").mkdir(parents=True)
    (root / "src" / "main.py").write_text(
        "import json, os, sys\n"
        "conf = json.load(open(os.environ['TONY_CONF_PATH']))['values']\n"
        "print('STAGED', conf['tony.application.name'])\n"
        "assert open('data/x.txt').read() == 'payload'\n")
    (root / "data").mkdir()
    (root / "data" / "x.txt").write_text("payload")
    client = CLIENTS[pkg]()
    client.init(["--executes", "main.py", "--src_dir", str(root / "src"),
                 "--app_name", "staged",
                 "--conf", "tony.worker.instances=1",
                 "--conf", f"tony.worker.resources={root}/data",
                 "--conf", f"tony.cluster.workdir={root}/work",
                 "--conf", f"tony.staging.location={root}/stage"] + FAST)
    ok = client.run()
    stage = os.path.join(str(root / "stage"), client.app_id)
    with open(os.path.join(client.app_dir, C.TONY_FINAL_CONF)) as f:
        frozen = json.load(f)
    with open(os.path.join(stage, C.FLEET_DIR_NAME, C.JOBSTATE_FILE)) as f:
        jobstate = json.load(f)
    [jhist] = glob.glob(os.path.join(client.app_dir, C.HISTORY_DIR_NAME,
                                     "*", "*." + C.HISTORY_SUFFIX))
    with open(os.path.join(client.app_dir, C.CONTAINERS_DIR_NAME,
                           "worker_0_s0", "stdout")) as f:
        stdout = f.read()
    return {"ok": ok, "status": client.final_status,
            "events": [e.type.name for e in parse_events(jhist)
                       if e.type.name != "TASK_FINISHED"],
            "staged": sorted(os.listdir(stage)),
            "src": frozen["values"]["tony.srcdir"]
            .replace(stage, "<stage>"),
            "resources": frozen["values"]["tony.worker.resources"]
            .replace(stage, "<stage>"),
            "jobstate_keys": sorted(jobstate),
            "jobstate_state": jobstate["state"],
            "stdout": stdout}


def test_a_staged_job_is_the_jax_clients(tmp_path, monkeypatch):
    jobs = {pkg: _staged_job(pkg, tmp_path, monkeypatch) for pkg in CLIENTS}
    port = jobs["port"]
    assert port == jobs["jax"]
    assert port["ok"] and port["status"] == "SUCCEEDED"
    assert port["src"] == f"<stage>/{C.TONY_SRC_ZIP}"
    assert port["resources"] == "<stage>/data.zip#archive"
    assert {C.TONY_FINAL_CONF, C.TONY_SRC_ZIP, "data.zip",
            C.FLEET_DIR_NAME} <= set(port["staged"])
    assert port["jobstate_keys"] == JOBSTATE_KEYS
    assert port["jobstate_state"] == "SUCCEEDED"
    assert "STAGED staged" in port["stdout"]
