"""The port's remote backend against the JAX package's.

The JAX package's `tests/test_remote.py` cases (node parsing, the launch
script's secret hygiene, ssh argv, the ssh-needs-staging check, live
scheduling over ExecTransport with a node root dir on this host standing
in for each host, labels and capacity vectors, fast-failing
unsatisfiable asks) run on both packages' classes. Then one 2-node gang
over the exec transport, staged through `tony.staging.location`, runs
under both AMs: the same record, one worker on each node in a workdir
under the node root, the conf fetched from the store, and
`fleet/jobstate.json` published with the JAX package's keys.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from test_torch_am import _run
from tony_tpu import cluster as jcluster
from tony_tpu.cluster import backend as jbackend
from tony_tpu.cluster import remote as jremote
from tony_tpu.conf import TonyConfiguration as JaxConf
from tony_tpu.observability import profiler as jprofiler
from tony_tpu.observability.fleet import job_summary as jax_job_summary
from tony_tpu_torch import cluster as pcluster
from tony_tpu_torch import constants as C
from tony_tpu_torch.cluster import backend as pbackend
from tony_tpu_torch.cluster import remote as premote
from tony_tpu_torch.conf import TonyConfiguration as PortConf
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.observability import profiler as pprofiler

PKGS = {
    "jax": SimpleNamespace(remote=jremote, backend=jbackend,
                           cluster=jcluster, Conf=JaxConf,
                           executor="tony_tpu.executor"),
    "port": SimpleNamespace(remote=premote, backend=pbackend,
                            cluster=pcluster, Conf=PortConf,
                            executor="tony_tpu_torch.executor"),
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


def test_parse_nodes(pkg):
    nodes = pkg.remote.parse_nodes("tpu-vm-0:4, tpu-vm-1:2,solo",
                                   default_root="/scratch")
    assert [(n.host, n.slots, n.root) for n in nodes] == [
        ("tpu-vm-0", 4, "/scratch"), ("tpu-vm-1", 2, "/scratch"),
        ("solo", 1, "/scratch")]
    with pytest.raises(ValueError):
        pkg.remote.NodeSpec.parse(":4")


def test_launch_script_never_leaks_secrets_to_argv(pkg):
    """Env values ride the script body (delivered over stdin), never
    argv."""
    script = pkg.remote.build_launch_script(
        ["python", "-m", pkg.executor],
        {"TONY_SECURITY_TOKEN": "s3cr3t", "A": "x y; rm -rf /"},
        "/nodes/n1/c1", "/nodes/n1/c1/container.pid")
    assert "export TONY_SECURITY_TOKEN=s3cr3t" in script
    assert "export A='x y; rm -rf /'" in script           # quoted, inert
    assert script.strip().endswith(f"exec python -m {pkg.executor}")
    ssh = pkg.remote.SSHTransport()
    argv = ssh.argv(pkg.remote.NodeSpec("hostA"), "bash -s")
    assert argv[0] == "ssh" and argv[-2:] == ["hostA", "bash -s"]
    assert not any("s3cr3t" in a for a in argv)


def test_the_launch_script_is_the_jax_backends():
    args = (["python", "-m", "x"], {"TONY_SECURITY_TOKEN": "s", "B": "$(id)",
                                    "PYTHONPATH": "/a:/b"},
            "/nodes/n1/c1", "/nodes/n1/c1/container.pid")
    assert premote.build_launch_script(*args) \
        == jremote.build_launch_script(*args)
    opts = ["-o", "StrictHostKeyChecking=no", "-p", "2222"]
    node = premote.NodeSpec("hostB")
    assert premote.SSHTransport(ssh_opts=opts).argv(node, "bash -s") \
        == jremote.SSHTransport(ssh_opts=opts).argv(
            jremote.NodeSpec("hostB"), "bash -s")


def test_ssh_transport_requires_staging_location(pkg):
    """ssh nodes share no fs with the client: without a staging store the
    executors would silently run on an empty conf — fail at submission."""
    conf = pkg.Conf()
    conf.set(K.CLUSTER_BACKEND, "remote", "test")
    conf.set(K.CLUSTER_NODES, "hostA:2", "test")
    with pytest.raises(ValueError, match="staging.location"):
        pkg.cluster.backend_from_conf(conf, "app1")
    conf.set(K.STAGING_LOCATION, "gs://bkt/stage", "test")
    backend = pkg.cluster.backend_from_conf(conf, "app1")
    assert backend.off_host
    assert isinstance(backend, pkg.remote.RemoteClusterBackend)


@pytest.mark.parametrize("settings,error", [
    ({"tony.cluster.node-transport": "telnet"}, "unknown node transport"),
    ({"tony.cluster.backend": "yarn"}, "unknown cluster backend"),
])
def test_backend_from_conf_refusals_equal_jax(settings, error):
    messages = []
    for p in PKGS.values():
        conf = p.Conf()
        conf.set(K.CLUSTER_BACKEND, "remote", "test")
        conf.set(K.CLUSTER_NODES, "a:1", "test")
        for k, v in settings.items():
            conf.set(k, v, "test")
        with pytest.raises(ValueError, match=error) as ei:
            p.cluster.backend_from_conf(conf, "app")
        messages.append(str(ei.value))
    assert messages[0] == messages[1]


def _collect_backend(pkg, nodes):
    backend = pkg.remote.RemoteClusterBackend(nodes,
                                              pkg.remote.ExecTransport(),
                                              app_id="t")
    allocated, completed = [], {}
    done = threading.Event()

    def on_alloc(c):
        allocated.append(c)

    def on_done(cid, rc):
        completed[cid] = rc
        done.set()

    backend.set_callbacks(on_alloc, on_done)
    return backend, allocated, completed, done


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_allocation_spreads_across_nodes(pkg, tmp_path):
    nodes = pkg.remote.parse_nodes("nodeA:2,nodeB:2",
                                   default_root=str(tmp_path / "n"))
    backend, allocated, _, _ = _collect_backend(pkg, nodes)
    backend.start()
    try:
        backend.request_containers(4, priority=1, memory_mb=0, vcores=1,
                                   gpus=0, tpus=0)
        assert _wait(lambda: len(allocated) == 4)
        hosts = sorted(c.host for c in allocated)
        assert hosts == ["nodeA", "nodeA", "nodeB", "nodeB"]
    finally:
        backend.stop()


def test_launch_runs_in_node_root_and_reports_exit(pkg, tmp_path):
    nodes = pkg.remote.parse_nodes("nodeA:1",
                                   default_root=str(tmp_path / "roots"))
    backend, allocated, completed, done = _collect_backend(pkg, nodes)
    backend.start()
    try:
        backend.request_containers(1, priority=1, memory_mb=0, vcores=1,
                                   gpus=0, tpus=0)
        assert _wait(lambda: allocated)
        c = allocated[0]
        cwd = str(tmp_path / "am" / c.container_id)
        backend.launch_container(
            c, ["bash", "-c", "pwd; echo out-line; exit 7"], {}, cwd)
        assert done.wait(10)
        assert completed[c.container_id] == 7
        out = open(os.path.join(cwd, "stdout")).read()
        # the process ran inside the NODE's root, not the AM-side cwd...
        assert out.splitlines()[0].startswith(str(tmp_path / "roots"))
        # ...but its stdout streamed back into the AM-side container dir
        assert "out-line" in out
    finally:
        backend.stop()


def test_stop_container_kills_remote_tree(pkg, tmp_path):
    nodes = pkg.remote.parse_nodes("nodeA:1",
                                   default_root=str(tmp_path / "roots"))
    backend, allocated, completed, done = _collect_backend(pkg, nodes)
    backend.start()
    try:
        backend.request_containers(1, priority=1, memory_mb=0, vcores=1,
                                   gpus=0, tpus=0)
        assert _wait(lambda: allocated)
        c = allocated[0]
        cwd = str(tmp_path / "am" / c.container_id)
        backend.launch_container(c, ["sleep", "600"], {}, cwd)
        pidfile = os.path.join(str(tmp_path / "roots"), c.container_id,
                               "container.pid")
        assert _wait(lambda: os.path.exists(pidfile))
        backend.stop_container(c.container_id)
        assert done.wait(10)
        assert completed[c.container_id] == pkg.backend.EXIT_KILLED_BY_AM
    finally:
        backend.stop()


def test_slot_capacity_queues_excess_requests(pkg, tmp_path):
    nodes = pkg.remote.parse_nodes("nodeA:1", default_root=str(tmp_path / "n"))
    backend, allocated, completed, _ = _collect_backend(pkg, nodes)
    backend.start()
    try:
        backend.request_containers(2, priority=1, memory_mb=0, vcores=1,
                                   gpus=0, tpus=0, gang=False)
        assert _wait(lambda: len(allocated) == 1)
        c0 = allocated[0]
        backend.launch_container(
            c0, ["bash", "-c", "sleep 0.5"], {},
            str(tmp_path / "am" / c0.container_id))
        # second allocation only lands after the first frees the slot
        assert _wait(lambda: len(allocated) == 2, timeout=15)
        assert c0.container_id in completed or _wait(
            lambda: c0.container_id in completed)
    finally:
        backend.stop()


def test_parse_node_attributes(pkg):
    nodes = pkg.remote.parse_nodes(
        "tpu-a:4;label=tpu;tpus=8;memory=16g, cpu-b:2;gpus=0, plain",
        default_root="/r")
    a, b, c = nodes
    assert (a.host, a.slots, a.label, a.tpus, a.memory_mb) == \
        ("tpu-a", 4, "tpu", 8, 16384)
    assert a.gpus == -1                       # undeclared = unconstrained
    assert (b.host, b.slots, b.gpus, b.tpus) == ("cpu-b", 2, 0, -1)
    assert (c.host, c.label, c.tpus) == ("plain", "", -1)
    with pytest.raises(ValueError, match="unknown node attribute"):
        pkg.remote.NodeSpec.parse("h:1;cores=4")
    with pytest.raises(ValueError, match="key=value"):
        pkg.remote.NodeSpec.parse("h:1;label")


def test_labeled_request_lands_only_on_matching_node(pkg, tmp_path):
    nodes = pkg.remote.parse_nodes("plainA:2,tpuB:2;label=tpu",
                                   default_root=str(tmp_path / "n"))
    backend, allocated, _, _ = _collect_backend(pkg, nodes)
    backend.start()
    try:
        backend.request_containers(2, priority=1, memory_mb=0, vcores=1,
                                   gpus=0, tpus=0, node_label="tpu")
        assert _wait(lambda: len(allocated) == 2)
        assert {c.host for c in allocated} == {"tpuB"}
        backend.request_containers(2, priority=2, memory_mb=0, vcores=1,
                                   gpus=0, tpus=0)
        assert _wait(lambda: len(allocated) == 4)
        assert {c.host for c in allocated[2:]} == {"plainA"}
    finally:
        backend.stop()


def test_capacity_vector_bounds_coresidency(pkg, tmp_path):
    nodes = pkg.remote.parse_nodes("tpuA:4;tpus=8",
                                   default_root=str(tmp_path / "n"))
    backend, allocated, completed, done = _collect_backend(pkg, nodes)
    backend.start()
    try:
        backend.request_containers(3, priority=1, memory_mb=0, vcores=1,
                                   gpus=0, tpus=4, gang=False)
        assert _wait(lambda: len(allocated) == 2)
        time.sleep(0.5)
        assert len(allocated) == 2            # third is chip-starved
        c0 = allocated[0]
        backend.launch_container(
            c0, ["bash", "-c", "exit 0"], {},
            str(tmp_path / "am" / c0.container_id))
        assert _wait(lambda: len(allocated) == 3, timeout=15)
    finally:
        backend.stop()


def test_unsatisfiable_request_fails_fast(pkg, tmp_path):
    Unsat = pkg.backend.UnsatisfiableRequestError
    nodes = pkg.remote.parse_nodes("a:2;tpus=4,b:2",
                                   default_root=str(tmp_path / "n"))
    backend, _, _, _ = _collect_backend(pkg, nodes)
    backend.start()
    try:
        t0 = time.monotonic()
        with pytest.raises(Unsat) as ei:
            backend.request_containers(1, priority=1, memory_mb=0,
                                       vcores=1, gpus=0, tpus=0,
                                       node_label="gpu")
        assert time.monotonic() - t0 < 1.0
        assert "label='gpu'" in str(ei.value)
        assert "a:2" in str(ei.value)         # inventory listed
        backend.request_containers(1, priority=2, memory_mb=0, vcores=1,
                                   gpus=0, tpus=16)
        nodes2 = pkg.remote.parse_nodes("only:1;tpus=4;gpus=0;memory=1g")
        b2, _, _, _ = _collect_backend(pkg, nodes2)
        with pytest.raises(Unsat, match="tpus=8"):
            b2.request_containers(1, priority=1, memory_mb=0, vcores=1,
                                  gpus=0, tpus=8)
        with pytest.raises(Unsat, match="memory_mb"):
            b2.request_containers(1, priority=1, memory_mb=2048, vcores=1,
                                  gpus=0, tpus=0)
    finally:
        backend.stop()


def test_gang_aggregate_feasibility(pkg, tmp_path):
    Unsat = pkg.backend.UnsatisfiableRequestError
    nodes = pkg.remote.parse_nodes("tpuB:4;label=tpu",
                                   default_root=str(tmp_path))
    backend, _, _, _ = _collect_backend(pkg, nodes)
    with pytest.raises(Unsat, match="co-host at most 4"):
        backend.request_containers(5, priority=1, memory_mb=0, vcores=1,
                                   gpus=0, tpus=0, node_label="tpu")
    nodes2 = pkg.remote.parse_nodes("a:16;tpus=8")
    b2, _, _, _ = _collect_backend(pkg, nodes2)
    with pytest.raises(Unsat, match="co-host at most 2"):
        b2.request_containers(3, priority=1, memory_mb=0, vcores=1,
                              gpus=0, tpus=4)


def test_starved_head_does_not_block_other_partitions(pkg, tmp_path):
    nodes = pkg.remote.parse_nodes("plainA:1,tpuB:1;label=tpu",
                                   default_root=str(tmp_path / "n"))
    backend, allocated, completed, done = _collect_backend(pkg, nodes)
    backend.start()
    try:
        backend.request_containers(1, priority=1, memory_mb=0, vcores=1,
                                   gpus=0, tpus=0, node_label="tpu")
        assert _wait(lambda: len(allocated) == 1)
        backend.request_containers(1, priority=2, memory_mb=0, vcores=1,
                                   gpus=0, tpus=0, node_label="tpu")
        backend.request_containers(1, priority=3, memory_mb=0, vcores=1,
                                   gpus=0, tpus=0)
        assert _wait(lambda: any(c.host == "plainA" for c in allocated))
        assert len([c for c in allocated if c.host == "tpuB"]) == 1
        c0 = allocated[0]
        backend.launch_container(
            c0, ["bash", "-c", "exit 0"], {},
            str(tmp_path / "am" / c0.container_id))
        assert _wait(lambda: len(
            [c for c in allocated if c.host == "tpuB"]) == 2, timeout=15)
    finally:
        backend.stop()


def test_joint_coresident_validation(pkg, tmp_path):
    Unsat = pkg.backend.UnsatisfiableRequestError
    nodes = pkg.remote.parse_nodes("a:4", default_root=str(tmp_path))
    backend, _, _, _ = _collect_backend(pkg, nodes)
    with pytest.raises(Unsat, match="jointly need"):
        backend.validate_coresident([(2, 0, 0, 0, ""), (3, 0, 0, 0, "")])
    backend.validate_coresident([(2, 0, 0, 0, ""), (2, 0, 0, 0, "")])
    nodes2 = pkg.remote.parse_nodes("a:8;tpus=4,b:8;tpus=4")
    b2, _, _, _ = _collect_backend(pkg, nodes2)
    with pytest.raises(Unsat, match="tpus"):
        b2.validate_coresident([(2, 0, 0, 4, ""), (1, 0, 0, 4, "")])
    nodes3 = pkg.remote.parse_nodes("a:8;tpus=4,b:8")
    b3, _, _, _ = _collect_backend(pkg, nodes3)
    b3.validate_coresident([(2, 0, 0, 4, ""), (1, 0, 0, 4, "")])


# ---------------------------------------------------------------------------
# a 2-node gang over the exec transport, under both AMs
# ---------------------------------------------------------------------------

PROBE = ("import json, os; print('PROBE ' + json.dumps({'cwd': os.getcwd(), "
         "'conf_path': os.environ.get('TONY_CONF_PATH'), "
         "'conf_uri': os.environ.get('TONY_CONF_URI'), "
         "'conf_here': os.path.exists('tony-final.json')}))")


def test_a_two_node_gang_runs_as_under_the_jax_am(tmp_path):
    records, probes = {}, {}
    for pkg in ("jax", "port"):
        roots, stage = tmp_path / f"{pkg}_nodes", tmp_path / f"{pkg}_stage"
        job = _run(tmp_path, pkg, "remote", {
            "tony.worker.instances": 2,
            "tony.cluster.backend": "remote",
            "tony.cluster.node-transport": "exec",
            "tony.cluster.nodes": "nodeA:1,nodeB:1",
            "tony.cluster.node-root": str(roots),
            "tony.staging.location": str(stage),
            "tony.fleet.publish-interval-ms": 200,
            "tony.task.command": f'{sys.executable} -c "{PROBE}"'})
        assert job.rc == 0, (pkg, job.stderr[-4000:])
        records[pkg] = job.record()
        got = []
        for task in ("worker_0_s0", "worker_1_s0"):
            with open(os.path.join(job.app_dir, C.CONTAINERS_DIR_NAME, task,
                                   "stdout")) as f:
                got += [json.loads(x.split(" ", 1)[1]) for x in f
                        if x.startswith("PROBE ")]
        probes[pkg] = got
        with open(os.path.join(stage, f"application_{pkg}_remote",
                               C.FLEET_DIR_NAME, C.JOBSTATE_FILE)) as f:
            jobstate = json.load(f)
        assert sorted(jobstate) == sorted(jax_job_summary("a", "u", "q",
                                                          "RUNNING"))
        assert jobstate["state"] == "SUCCEEDED"
        assert jobstate["gang_width"] == 2
        # one worker on each node, each in its own workdir under the
        # node root, reading the conf fetched from the store into it
        assert sorted(p.host for p in job.of("TASK_STARTED")) \
            == ["nodeA", "nodeB"]
        assert len({p["cwd"] for p in got}) == 2
        for p in got:
            assert p["cwd"].startswith(str(roots))
            assert p["conf_path"] == C.TONY_FINAL_CONF and p["conf_here"]
            assert p["conf_uri"].startswith(f"file://{stage}") \
                or p["conf_uri"].startswith(str(stage))
    assert records["port"] == records["jax"]
    assert records["port"]["status"] == "SUCCEEDED"
