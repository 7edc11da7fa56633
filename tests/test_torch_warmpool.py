"""The port's warm executor pool against the JAX package's.

The JAX package's `tests/test_warmpool.py` cases (the bind fence: a
fresh identity with stale env scrubbed, nonce-mismatched and garbage
binds refused, a SIGKILLed child evicted and replaced, an exhausted pool
recovering, the TTL sweep, the backend's cold fallback, the conf gate)
run on both packages' pools. The port's warm child imports its executor
stack and never torch, jax or grpc. Then one warm-leased job runs under
both AMs: the same record, and each AM's log shows the lease.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import pytest

from test_torch_am import _run
from tony_tpu import cluster as jcluster
from tony_tpu.cluster import backend as jbackend
from tony_tpu.cluster import local as jlocal
from tony_tpu.cluster import warmpool as jwp
from tony_tpu.conf import TonyConfiguration as JaxConf
from tony_tpu.observability import profiler as jprofiler
from tony_tpu.observability.metrics import REGISTRY as JAX_REGISTRY
from tony_tpu_torch import cluster as pcluster
from tony_tpu_torch import constants as C
from tony_tpu_torch.cluster import backend as pbackend
from tony_tpu_torch.cluster import local as plocal
from tony_tpu_torch.cluster import warmpool as pwp
from tony_tpu_torch.conf import TonyConfiguration as PortConf
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.observability import profiler as pprofiler
from tony_tpu_torch.observability.metrics import REGISTRY as PORT_REGISTRY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": SimpleNamespace(wp=jwp, backend=jbackend, local=jlocal,
                           cluster=jcluster, Conf=JaxConf,
                           registry=JAX_REGISTRY,
                           child="tony_tpu.cluster.warmpool"),
    "port": SimpleNamespace(wp=pwp, backend=pbackend, local=plocal,
                            cluster=pcluster, Conf=PortConf,
                            registry=PORT_REGISTRY,
                            child="tony_tpu_torch.cluster.warmpool"),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _drop_backend_beacons():
    """A started backend's dispatcher registers a progress beacon in its
    package's process-wide registry and leaves it there after stop():
    drop them, so a later test's stall watchdog in this worker process
    does not read a stopped backend as a wedge."""
    yield
    jprofiler._reset_beacons()
    pprofiler._reset_beacons()


def _counter(pkg, name: str, **labels) -> float:
    return pkg.registry.counter(name, **labels).value


def _write_probe(tmp_path) -> str:
    """A script-entry module that reports what the bound child became:
    cwd, argv, and the identity env after scrub + re-apply."""
    path = tmp_path / "probe_mod.py"
    path.write_text(textwrap.dedent("""
        import json, os, sys

        def probe_main():
            out = {"cwd": os.getcwd(), "argv": sys.argv[1:],
                   "env": {k: os.environ.get(k, "")
                           for k in ("TONY_STALE_A", "TONY_TRACE_ID",
                                     "JOB_NAME")},
                   "loaded": sorted({m.split(".")[0] for m in sys.modules}
                                    & {"torch", "jax", "grpc", "tony_tpu",
                                       "tony_tpu_torch"})}
            print("PROBE " + json.dumps(out), flush=True)
            return 0
    """))
    return str(path)


def _lease_probe(pool, tmp_path, env, argv=()):
    proc = pool.lease_and_bind(
        env=env, cwd=str(tmp_path), entry="script",
        script_path=_write_probe(tmp_path), script_func="probe_main",
        argv=["probe"] + list(argv))
    assert proc is not None, "warm lease missed with a warmed pool"
    line, deadline = "", time.monotonic() + 20
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line or line.startswith("PROBE "):
            break
    assert line.startswith("PROBE "), f"no probe output, got {line!r}"
    rc = proc.wait(timeout=20)
    return json.loads(line.split(" ", 1)[1]), rc, proc.pid


@pytest.fixture
def pool(pkg, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO)
    pools = []

    def make(size=1, ttl_ms=300_000):
        p = pkg.wp.WarmExecutorPool(size=size, ttl_ms=ttl_ms)
        pools.append(p)
        p.start()
        assert p.wait_ready(timeout=60.0), "pool never warmed"
        return p

    yield make
    for p in pools:
        p.stop()


def test_lease_binds_fresh_identity_and_scrubs_stale(pkg, pool, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("TONY_STALE_A", "app-a-secret")
    monkeypatch.setenv("JOB_NAME", "app-a-worker")
    p = pool(size=1)
    hits0 = _counter(pkg, "tony_warmpool_lease_total", outcome="hit")
    probe, rc, _ = _lease_probe(
        p, tmp_path,
        env={"TONY_TRACE_ID": "trace-b", "JOB_NAME": "worker-b"},
        argv=["x", "y"])
    assert rc == 0
    assert probe["env"]["TONY_STALE_A"] == ""       # scrubbed
    assert probe["env"]["JOB_NAME"] == "worker-b"   # re-supplied, not stale
    assert probe["env"]["TONY_TRACE_ID"] == "trace-b"
    assert probe["cwd"] == str(tmp_path)
    assert probe["argv"] == ["x", "y"]
    assert _counter(pkg, "tony_warmpool_lease_total",
                    outcome="hit") == hits0 + 1
    if pkg is PKGS["port"]:
        # the warm child pre-imported the port's executor stack: nothing
        # of the JAX package, no torch (no CUDA context), no grpc yet
        assert probe["loaded"] == ["tony_tpu_torch"]


def _child(pkg, nonce: str):
    env = dict(os.environ, PYTHONPATH=REPO)
    env[C.WARMPOOL_NONCE] = nonce
    return subprocess.Popen(
        [sys.executable, "-m", pkg.child], env=env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)


def test_bind_refused_on_nonce_mismatch(pkg):
    proc = _child(pkg, "the-real-nonce")
    try:
        assert proc.stdout.readline().strip() == pkg.wp.WARM_READY_LINE
        proc.stdin.write(json.dumps(
            {"nonce": "forged", "entry": "executor", "env": {}}) + "\n")
        proc.stdin.close()
        assert proc.wait(timeout=20) == pkg.wp.EXIT_BIND_REJECTED
    finally:
        proc.kill()


def test_bind_refused_on_garbage_and_clean_exit_on_eof(pkg):
    for payload, expected in (("not json at all\n",
                               pkg.wp.EXIT_BIND_REJECTED),
                              ("", 0)):   # EOF = pool retirement
        proc = _child(pkg, "n1")
        try:
            assert proc.stdout.readline().strip() == pkg.wp.WARM_READY_LINE
            if payload:
                proc.stdin.write(payload)
            proc.stdin.close()
            assert proc.wait(timeout=20) == expected
        finally:
            proc.kill()


def test_the_fence_constants_are_the_jax_pools():
    assert (pwp.WARM_READY_LINE, pwp.EXIT_BIND_REJECTED, pwp._IDENTITY_ENV) \
        == (jwp.WARM_READY_LINE, jwp.EXIT_BIND_REJECTED, jwp._IDENTITY_ENV)


def test_sigkilled_warm_child_evicted_replacement_fenced(pkg, pool,
                                                         tmp_path):
    p = pool(size=2)
    victim = p._idle[0].proc
    os.kill(victim.pid, signal.SIGKILL)
    victim.wait()
    dead0 = _counter(pkg, "tony_warmpool_evictions_total", reason="dead")
    probe, rc, pid = _lease_probe(
        p, tmp_path, env={"TONY_TRACE_ID": "trace-after-chaos",
                          "JOB_NAME": "worker-replacement"})
    assert rc == 0 and pid != victim.pid
    assert probe["env"]["TONY_TRACE_ID"] == "trace-after-chaos"
    assert probe["env"]["JOB_NAME"] == "worker-replacement"
    assert _counter(pkg, "tony_warmpool_evictions_total",
                    reason="dead") >= dead0 + 1


def test_exhausted_pool_returns_none_then_recovers(pkg, pool, tmp_path):
    p = pool(size=1)
    os.kill(p._idle[0].proc.pid, signal.SIGKILL)
    p._idle[0].proc.wait()
    assert p.lease_and_bind(env={}, cwd=str(tmp_path)) is None
    assert p.wait_ready(1, timeout=60.0)
    probe, rc, _ = _lease_probe(p, tmp_path, env={"JOB_NAME": "healed"})
    assert rc == 0 and probe["env"]["JOB_NAME"] == "healed"


def test_ttl_sweep_retires_expired_children(pkg, pool):
    p = pool(size=1, ttl_ms=1)
    time.sleep(0.05)
    ttl0 = _counter(pkg, "tony_warmpool_evictions_total", reason="ttl")
    p.sweep()
    assert _counter(pkg, "tony_warmpool_evictions_total",
                    reason="ttl") == ttl0 + 1


def test_backend_falls_back_to_cold_spawn_on_pool_miss(pkg, pool, tmp_path):
    p = pool(size=1)
    os.kill(p._idle[0].proc.pid, signal.SIGKILL)
    p._idle[0].proc.wait()
    backend = pkg.local.LocalClusterBackend(app_id="t", warmpool=p)
    done = []
    backend._on_allocated = lambda c: None
    backend._on_completed = lambda cid, rc: done.append((cid, rc))
    try:
        cwd = str(tmp_path / "c1")
        container = pkg.backend.Container(
            container_id="c1", host="localhost", priority=0, memory_mb=0,
            vcores=0, gpus=0, tpus=0)
        backend.launch_container(
            container, [sys.executable, "-c", "print('cold-ok')"],
            env={}, cwd=cwd)
        deadline = time.monotonic() + 30
        while not done and time.monotonic() < deadline:
            time.sleep(0.05)
        assert done == [("c1", 0)]
        with open(os.path.join(cwd, "stdout"), "rb") as f:
            assert b"cold-ok" in f.read()
    finally:
        backend.stop()


def test_from_conf_gating(pkg):
    conf = pkg.Conf()
    assert pkg.wp.from_conf(conf) is None          # default: disabled
    conf.set(K.WARMPOOL_ENABLED, True, "test")
    conf.set(K.WARMPOOL_SIZE, 2, "test")
    p = pkg.wp.from_conf(conf)
    try:
        assert isinstance(p, pkg.wp.WarmExecutorPool) and p.size == 2
    finally:
        p.stop()


def test_backend_from_conf_builds_a_pooled_local_backend(pkg):
    conf = pkg.Conf()
    conf.set(K.WARMPOOL_ENABLED, True, "test")
    backend = pkg.cluster.backend_from_conf(conf, "app")
    try:
        assert isinstance(backend, pkg.local.LocalClusterBackend)
        assert isinstance(backend._warmpool, pkg.wp.WarmExecutorPool)
    finally:
        backend._warmpool.stop()


# ---------------------------------------------------------------------------
# a warm-leased job under both AMs
# ---------------------------------------------------------------------------

def test_a_warm_leased_job_runs_as_under_the_jax_am(tmp_path):
    records = {}
    for pkg in ("jax", "port"):
        job = _run(tmp_path, pkg, "warm", {
            "tony.worker.instances": 2,
            "tony.warmpool.enabled": "true", "tony.warmpool.size": 2,
            "tony.task.command": f"{sys.executable} "
                                 f"{os.path.join(REPO, 'tests', 'scripts', 'exit_0.py')}"})
        assert job.rc == 0, (pkg, job.stderr[-4000:])
        assert "leased warm executor" in job.stderr
        records[pkg] = job.record()
    assert records["port"] == records["jax"]
    assert records["port"]["status"] == "SUCCEEDED"
