"""The port's last TonY-task services, on the CPU: the kernel build cache
under $TONY_JAX_CACHE_DIR (tony_tpu_torch/utils/compilecache.py and
ops/cuda_lib.py) and the profiler page on a chief's TB_PORT
(tony_tpu_torch/observability/profiler_server.py).

The CPU tests assume no CUDA toolkit: `build()` runs against a fake
`nvcc` shell script on PATH, which prints a version, or sleeps a little,
writes an empty library and counts its compiles in a file. The profiler
server is held with `ProfileCapture`'s start/stop stubbed, and once
through a Trainer on the CPU with torch.profiler itself. Every server a
test starts is stopped in it.
"""

import json
import logging
import os
import socket
import stat
import subprocess
import sys
import urllib.error
import urllib.request
from functools import partial

import pytest
import torch

from tony_tpu import constants as JC
from tony_tpu_torch import constants as C
from tony_tpu_torch.models import llama
from tony_tpu_torch.observability.perf import ProfileCapture
from tony_tpu_torch.observability.profiler_server import ProfilerServer
from tony_tpu_torch.ops import cuda_lib
from tony_tpu_torch.train import data, trainer
from tony_tpu_torch.utils.compilecache import (
    KERNELS_SUBDIR, maybe_enable_compile_cache,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = """#!/bin/bash
# fake nvcc: --version prints $FAKE_NVCC_VERSION; a compile sleeps, counts
# itself in $FAKE_NVCC_COUNT and writes an empty library to its -o path
if [[ $1 == --version ]]; then
  echo "nvcc: NVIDIA (R) Cuda compiler driver"
  echo "${FAKE_NVCC_VERSION:-Cuda compilation tools, release 12.9}"
  exit 0
fi
[[ -n $FAKE_NVCC_FAIL ]] && { echo "error: $FAKE_NVCC_FAIL" >&2; exit 2; }
out=""
while [[ $# -gt 0 ]]; do
  if [[ $1 == -o ]]; then out=$2; shift; fi
  shift
done
sleep "${FAKE_NVCC_SLEEP:-0}"
echo "$out" >> "$FAKE_NVCC_COUNT"
: > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A fake nvcc first on PATH, the module's build state isolated:
    returns the file counting its compiles."""
    bindir = tmp_path / "nvcc-bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    count = tmp_path / "nvcc-calls"
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.delenv(C.JAX_CACHE_DIR, raising=False)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_COUNT", str(count))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", cuda_lib.BUILD_DIR)
    monkeypatch.setattr(cuda_lib, "_libs", {})
    monkeypatch.setattr(cuda_lib, "_compiler", None)
    return count


def _compiles(count) -> list[str]:
    return count.read_text().split() if count.exists() else []


# ---------------------------------------------------------------------------
# the kernel build cache
# ---------------------------------------------------------------------------

def test_names_are_the_reference_constants():
    assert C.JAX_CACHE_DIR == JC.JAX_CACHE_DIR == "TONY_JAX_CACHE_DIR"
    assert C.TB_PORT == JC.TB_PORT == "TB_PORT"
    assert C.IS_CHIEF == JC.IS_CHIEF


def test_unset_variable_leaves_the_build_dir(fake_nvcc):
    assert maybe_enable_compile_cache() is None
    assert cuda_lib.BUILD_DIR == cuda_lib.DEFAULT_BUILD_DIR
    assert cuda_lib.library_path("rmsnorm.cu").parent == \
        cuda_lib.DEFAULT_BUILD_DIR


def test_variable_moves_the_build_dir_under_it(fake_nvcc, tmp_path,
                                               monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv(C.JAX_CACHE_DIR, str(cache))
    want = (cache / KERNELS_SUBDIR).resolve()
    assert maybe_enable_compile_cache() == str(want)
    assert cuda_lib.BUILD_DIR == want and want.is_dir()
    assert cuda_lib.build(["rmsnorm.cu"]).keys() == {"rmsnorm.cu"}
    [built] = _compiles(fake_nvcc)
    assert os.path.dirname(built) == str(want)
    assert cuda_lib.library_path("rmsnorm.cu").exists()
    assert not any(cuda_lib.DEFAULT_BUILD_DIR.glob(
        cuda_lib.library_path("rmsnorm.cu").name))
    # built once: a second build compiles nothing
    assert cuda_lib.build(["rmsnorm.cu"]) == {}
    assert len(_compiles(fake_nvcc)) == 1


def test_unusable_cache_dir_is_logged_and_the_default_kept(
        fake_nvcc, tmp_path, caplog, monkeypatch):
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    with caplog.at_level(logging.WARNING,
                         logger="tony_tpu_torch.utils.compilecache"):
        assert maybe_enable_compile_cache(str(blocker / "cache")) is None
    assert "kernel build cache unavailable" in caplog.text
    assert cuda_lib.BUILD_DIR == cuda_lib.DEFAULT_BUILD_DIR
    # a library already loaded from the default: the cache is refused,
    # the loaded library's directory stays
    monkeypatch.setattr(cuda_lib, "_libs", {"rmsnorm.cu": object()})
    caplog.clear()
    with caplog.at_level(logging.WARNING,
                         logger="tony_tpu_torch.utils.compilecache"):
        assert maybe_enable_compile_cache(str(tmp_path / "late")) is None
    assert "already loaded" in caplog.text
    assert cuda_lib.BUILD_DIR == cuda_lib.DEFAULT_BUILD_DIR


def test_failed_nvcc_raises_with_the_cache(fake_nvcc, tmp_path,
                                           monkeypatch):
    maybe_enable_compile_cache(str(tmp_path / "cache"))
    monkeypatch.setenv("FAKE_NVCC_FAIL", "bad kernel")
    with pytest.raises(RuntimeError, match="bad kernel"):
        cuda_lib.build(["rmsnorm.cu"])
    assert not cuda_lib.library_path("rmsnorm.cu").exists()
    assert list(cuda_lib.BUILD_DIR.glob("*.tmp")) == []


def test_compiler_version_changes_library_path(fake_nvcc, monkeypatch):
    first = cuda_lib.library_path("rmsnorm.cu")
    assert "release 12.9" in cuda_lib.compiler_version()
    # read once per process: a changed toolkit shows in a new process
    monkeypatch.setenv("FAKE_NVCC_VERSION", "release 12.4")
    assert cuda_lib.library_path("rmsnorm.cu") == first
    monkeypatch.setattr(cuda_lib, "_compiler", None)
    second = cuda_lib.library_path("rmsnorm.cu")
    assert second != first and second.parent == first.parent


BUILD_PROBE = """
import json, sys
from tony_tpu_torch.utils.compilecache import maybe_enable_compile_cache
from tony_tpu_torch.ops import cuda_lib
maybe_enable_compile_cache()
print(json.dumps(sorted(cuda_lib.build(sys.argv[1:]))))
"""


def test_two_processes_building_at_once_make_one_nvcc_call(fake_nvcc,
                                                           tmp_path):
    """Two processes on an empty cache, started together, build the same
    two sources: each is compiled once between them (the second waits on
    its lock, then finds it built); a third process compiles nothing."""
    env = dict(os.environ, PYTHONPATH=REPO, FAKE_NVCC_SLEEP="1",
               **{C.JAX_CACHE_DIR: str(tmp_path / "cache")})
    cmd = [sys.executable, "-c", BUILD_PROBE, "rmsnorm.cu", "flash_fwd.cu"]
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    compiled = [json.loads(out) for out, _ in outs]
    assert sorted(compiled[0] + compiled[1]) == ["flash_fwd.cu",
                                                 "rmsnorm.cu"]
    assert len(_compiles(fake_nvcc)) == 2
    third = subprocess.run(cmd, env=env, cwd=REPO, text=True,
                           capture_output=True, timeout=120)
    assert third.returncode == 0, third.stderr
    assert json.loads(third.stdout) == []
    assert len(_compiles(fake_nvcc)) == 2


# ---------------------------------------------------------------------------
# the profiler page on TB_PORT
# ---------------------------------------------------------------------------

def _get(url: str):
    """(status, parsed JSON body) of a GET, errors included."""
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _StubTrace:
    """ProfileCapture's start/stop: stop writes a small trace.json."""

    def __init__(self):
        self.dir = None

    def start(self, out_dir: str) -> None:
        self.dir = out_dir

    def stop(self) -> None:
        with open(os.path.join(self.dir, "trace.json"), "w") as f:
            json.dump({"traceEvents": [{"name": "stub", "ph": "X"}]}, f)


@pytest.fixture
def stub_server(tmp_path):
    stub = _StubTrace()
    cap = ProfileCapture(cwd=str(tmp_path), start_fn=stub.start,
                         stop_fn=stub.stop)
    server = ProfilerServer(0, lambda: cap, task="worker:0")
    try:
        yield cap, f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()


def test_post_then_get_returns_202_then_the_trace(stub_server):
    cap, url = stub_server
    assert _get(url + "/") == (200, {"task": "worker:0", "active": None,
                                     "captures": []})
    code, body = _post(url + "/v1/profile", {"num_steps": 2})
    assert code == 200 and body["num_steps"] == 2
    rid = body["request_id"]
    with open(cap.request_path) as f:
        assert json.load(f) == {"request_id": rid, "num_steps": 2}
    assert _get(f"{url}/v1/profile/{rid}")[0] == 202      # waiting
    cap.poll()                                             # a log boundary
    assert _get(url + "/")[1]["active"] == rid
    cap.on_step()
    assert _get(f"{url}/v1/profile/{rid}")[0] == 202      # running
    cap.on_step()
    assert _get(f"{url}/v1/profile/{rid}") == (
        200, {"traceEvents": [{"name": "stub", "ph": "X"}]})
    assert _get(url + "/")[1] == {"task": "worker:0", "active": None,
                                  "captures": [rid]}
    assert not os.path.exists(cap.request_path)
    assert _get(f"{url}/v1/profile/{'0' * 32}")[0] == 404
    assert _get(url + "/v1/nope")[0] == 404


def test_second_post_during_a_capture_is_409(stub_server):
    cap, url = stub_server
    code, body = _post(url + "/v1/profile", {"num_steps": 1})
    assert code == 200
    assert _post(url + "/v1/profile", {"num_steps": 1})[0] == 409  # queued
    cap.poll()
    assert _post(url + "/v1/profile", {"num_steps": 1})[0] == 409  # running
    cap.on_step()
    assert _get(f"{url}/v1/profile/{body['request_id']}")[0] == 200
    code, again = _post(url + "/v1/profile", {"num_steps": 3})
    assert code == 200 and again["request_id"] != body["request_id"]
    for bad in ({"num_steps": 0}, {"num_steps": "2"}, {"num_steps": True}):
        assert _post(url + "/v1/profile", bad)[0] == 400


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _listening(port: int) -> bool:
    with socket.socket() as s:
        s.settimeout(2)
        return s.connect_ex(("127.0.0.1", port)) == 0


def _tiny_trainer(num_steps, data_iter):
    cfg = llama.get_config("tiny")
    return trainer.Trainer(
        partial(llama.llama_loss, config=cfg), partial(llama.llama_init, cfg),
        data_iter, trainer.TrainerConfig(num_steps=num_steps, log_every=1,
                                         prefetch_depth=0),
        device="cpu")


def test_chief_trainer_serves_a_capture_on_tb_port(tmp_path, monkeypatch):
    """TB_PORT set and IS_CHIEF unset (the chief by default): setup()
    binds, a POSTed 2-step capture starts at step 1's log boundary and
    runs torch.profiler over steps 2 and 3; during step 4's data pull the
    GET serves its Chrome trace. run() closes the port."""
    monkeypatch.chdir(tmp_path)
    port = _free_port()
    monkeypatch.setenv(C.TB_PORT, str(port))
    monkeypatch.delenv(C.IS_CHIEF, raising=False)
    url = f"http://127.0.0.1:{port}"
    got = {}

    def batches():
        src = data.synthetic_tokens(2, 8, 256)
        for i in range(4):
            if i == 3:
                got["trace"] = _get(f"{url}/v1/profile/{got['rid']}")
            yield next(src)

    t = _tiny_trainer(4, batches())
    t.setup()
    try:
        assert _get(url + "/")[1]["active"] is None
        got["rid"] = _post(url + "/v1/profile", {"num_steps": 2})[1][
            "request_id"]
        t.run()
    finally:
        if t._profiler_server is not None:
            t._profiler_server.stop()
    code, trace = got["trace"]
    assert code == 200
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "train_step" in names, sorted(names)[:20]
    assert not _listening(port)


@pytest.mark.parametrize("env", [{C.IS_CHIEF: "false"}, {}],
                         ids=["not-chief", "no-tb-port"])
def test_no_server_unless_chief_with_tb_port(tmp_path, monkeypatch, env):
    monkeypatch.chdir(tmp_path)
    port = _free_port()
    monkeypatch.delenv(C.IS_CHIEF, raising=False)
    if env:
        monkeypatch.setenv(C.TB_PORT, str(port))
    else:
        monkeypatch.delenv(C.TB_PORT, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t = _tiny_trainer(1, data.synthetic_tokens(2, 8, 256))
    t.setup()
    assert t._profiler_server is None and not _listening(port)
    t.run()


def test_port_in_use_is_logged_and_run_finishes(tmp_path, monkeypatch,
                                                caplog):
    monkeypatch.chdir(tmp_path)
    with socket.socket() as held:
        held.bind(("", 0))
        held.listen(1)
        monkeypatch.setenv(C.TB_PORT, str(held.getsockname()[1]))
        monkeypatch.setenv(C.IS_CHIEF, "true")
        t = _tiny_trainer(2, data.synthetic_tokens(2, 8, 256))
        with caplog.at_level(logging.ERROR,
                             logger="tony_tpu_torch.train.trainer"):
            loss = t.run()
    assert "could not start profiler server" in caplog.text
    assert t._profiler_server is None and t.step == 2
    assert torch.isfinite(torch.tensor(loss))
