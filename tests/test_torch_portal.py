"""The port's history portal against the JAX package's.

Every case runs both packages on the same input and compares what they
give: the mover, the purger and the fetcher each act on their own copy
of one history tree and leave equal trees (paths and bytes); every
`PortalCache` method answers alike; two `PortalServer`s over one tree
answer every route with the same status and body (the pages' clock
frozen on both sides, `/metrics` held to the portal's own families); a
history the port's own AM wrote reads equal through both; and `python
-m tony_tpu_torch.portal` runs as a daemon beside `python -m
tony_tpu.portal`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

import tony_tpu.portal.server as jax_server
import tony_tpu_torch.portal.server as port_server
from tests.test_portal import make_app_history
from tests.test_torch_am import _start
from tony_tpu import constants as C
from tony_tpu.observability import fleet as jax_fleet
from tony_tpu.portal.cache import PortalCache as JaxCache
from tony_tpu.portal.fetcher import HistoryStoreFetcher as JaxFetcher
from tony_tpu.portal.mover import HistoryFileMover as JaxMover
from tony_tpu.portal.mover import ensure_history_dirs
from tony_tpu.portal.mover import finished_subdir as jax_finished_subdir
from tony_tpu.portal.purger import HistoryFilePurger as JaxPurger
from tony_tpu_torch.observability import fleet as port_fleet
from tony_tpu_torch.observability.prometheus import parse
from tony_tpu_torch.portal import PortalCache as PortCache
from tony_tpu_torch.portal import (
    HistoryFileMover as PortMover,
    HistoryFilePurger as PortPurger,
    ensure_history_dirs as port_ensure_history_dirs,
)
from tony_tpu_torch.portal.fetcher import HistoryStoreFetcher as PortFetcher
from tony_tpu_torch.portal.mover import finished_subdir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "port")
MOVER = {"jax": JaxMover, "port": PortMover}
PURGER = {"jax": JaxPurger, "port": PortPurger}
CACHE = {"jax": JaxCache, "port": PortCache}
FETCHER = {"jax": JaxFetcher, "port": PortFetcher}
SERVER = {"jax": jax_server.PortalServer, "port": port_server.PortalServer}
FLEET = {"jax": jax_fleet, "port": port_fleet}
FROZEN_MS = 1_700_000_000_000


# ---------------------------------------------------------------------------
# one tree, two copies
# ---------------------------------------------------------------------------

def _copies(src, tmp_path) -> dict[str, tuple[str, str]]:
    """Each package's own copy of the tree at `src` (mtimes kept):
    {pkg: (intermediate, finished)}."""
    out = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        shutil.copytree(src, root)
        out[pkg] = (str(root / "int"), str(root / "fin"))
    return out


def _snapshot(root) -> dict[str, bytes]:
    """{relative path: bytes} of every file under `root`; a parked
    duplicate's time suffix is masked."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = re.sub(r"\.dup-\d+x*", ".dup-T",
                         os.path.relpath(path, root))
            with open(path, "rb") as f:
                out[rel] = f.read()
    return out


def _rel(paths, root) -> list[str]:
    return [os.path.relpath(p, root) for p in paths]


def _src(tmp_path):
    src = tmp_path / "src"
    inter, fin = str(src / "int"), str(src / "fin")
    ensure_history_dirs(inter, fin)
    return src, inter


def test_the_mover_files_final_dirs_alike(tmp_path):
    src, inter = _src(tmp_path)
    make_app_history(inter, "app_1", completed=2000)
    make_app_history(inter, "app_2", completed=1_700_000_000_000,
                     config={"tony.am.memory": "2g"},
                     logs={"worker_0_s0": {"stdout": "out\n"}})
    trees = _copies(src, tmp_path)
    moved = {pkg: _rel(MOVER[pkg](*trees[pkg]).move_once(), tmp_path / pkg)
             for pkg in PKGS}
    assert moved["port"] == moved["jax"] == [
        os.path.join("fin", "1970", "01", "01", "app_1"),
        os.path.join("fin", "2023", "11", "14", "app_2")]
    assert _snapshot(tmp_path / "port") == _snapshot(tmp_path / "jax")
    assert finished_subdir("/f", 2000) == jax_finished_subdir("/f", 2000)


def test_the_mover_leaves_running_apps_alike(tmp_path):
    src, inter = _src(tmp_path)
    make_app_history(inter, "app_run", final=False)
    trees = _copies(src, tmp_path)
    for pkg in PKGS:
        assert MOVER[pkg](*trees[pkg], stale_sec=3600).move_once() == []
    assert _snapshot(tmp_path / "port") == _snapshot(tmp_path / "jax")


def test_the_mover_finalizes_stale_inprogress_as_killed_alike(tmp_path):
    src, inter = _src(tmp_path)
    app_dir = make_app_history(inter, "app_dead", final=False)
    [inprog] = [f for f in os.listdir(app_dir)
                if f.endswith(".jhist.inprogress")]
    old = time.time() - 7200
    os.utime(os.path.join(app_dir, inprog), (old, old))
    trees = _copies(src, tmp_path)
    moved = {pkg: _rel(MOVER[pkg](*trees[pkg], stale_sec=3600).move_once(),
                       tmp_path / pkg) for pkg in PKGS}
    assert moved["port"] == moved["jax"] and len(moved["port"]) == 1
    snap = _snapshot(tmp_path / "port")
    assert snap == _snapshot(tmp_path / "jax")
    assert [p for p in snap if p.endswith("-KILLED.jhist")]


def test_the_mover_parks_a_duplicate_outside_finished_alike(tmp_path):
    src, inter = _src(tmp_path)
    make_app_history(inter, "app_dup", completed=2000)
    trees = _copies(src, tmp_path)
    movers = {pkg: MOVER[pkg](*trees[pkg]) for pkg in PKGS}
    for pkg in PKGS:
        assert len(movers[pkg].move_once()) == 1
    # an AM retry writes the same app's history again
    again = tmp_path / "again"
    make_app_history(str(again), "app_dup", completed=2000)
    for pkg in PKGS:
        shutil.copytree(again / "app_dup",
                        os.path.join(trees[pkg][0], "app_dup"))
        assert movers[pkg].move_once() == []
        assert os.listdir(tmp_path / pkg / "duplicates")
    assert _snapshot(tmp_path / "port") == _snapshot(tmp_path / "jax")


def test_the_purger_deletes_expired_dirs_alike(tmp_path):
    src, inter = _src(tmp_path)
    now_ms = int(time.time() * 1000)
    make_app_history(inter, "app_old", completed=2000)
    make_app_history(inter, "app_new", completed=now_ms)
    trees = _copies(src, tmp_path)
    removed = {}
    for pkg in PKGS:
        MOVER[pkg](*trees[pkg]).move_once()
        purger = PURGER[pkg](trees[pkg][1], retention_sec=24 * 3600)
        removed[pkg] = _rel(purger.purge_once(now_ms=now_ms), tmp_path / pkg)
    assert removed["port"] == removed["jax"] == [
        os.path.join("fin", "1970", "01", "01", "app_old")]
    snap = _snapshot(tmp_path / "port")
    assert snap == _snapshot(tmp_path / "jax")
    assert not any(p.startswith(os.path.join("fin", "1970")) for p in snap)


def test_ensure_history_dirs_alike(tmp_path):
    for pkg, fn in (("jax", ensure_history_dirs),
                    ("port", port_ensure_history_dirs)):
        fn(str(tmp_path / pkg / "i"), str(tmp_path / pkg / "f"))
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == ["f", "i"]


def test_the_fetcher_feeds_the_mover_and_the_cache_alike(tmp_path,
                                                        fake_gcs):
    """Off-host history: both fetchers mirror one gs:// store (through
    the `fake_gcs` gsutil stand-in) into their own trees; the movers and
    caches then give equal trees and answers."""
    from tony_tpu.events.history import JobMetadata, history_file_name
    from tony_tpu.storage import GCSStore

    store = GCSStore("gs://bkt/stage/app_remote")
    hist = tmp_path / history_file_name(JobMetadata(
        application_id="app_remote", started=1000, completed=2000,
        user="bob", status="SUCCEEDED"))
    hist.write_text(json.dumps({
        "type": "APPLICATION_FINISHED", "timestamp": 2000,
        "payload": {"application_id": "app_remote",
                    "status": "SUCCEEDED"}}) + "\n")
    store.put(str(hist), f"history/{hist.name}")
    cfg = tmp_path / "cfgsnap.json"
    cfg.write_text(json.dumps({"tony.am.memory": "1g"}))
    store.put(str(cfg), f"history/{C.PORTAL_CONFIG_FILE}")
    log = tmp_path / "wstdout"
    log.write_text("remote body\n")
    store.put(str(log),
              f"history/{C.HISTORY_LOGS_DIR_NAME}/worker_0_s0/stdout")
    out = {}
    for pkg in PKGS:
        inter, fin = str(tmp_path / pkg / "int"), str(tmp_path / pkg / "fin")
        ensure_history_dirs(inter, fin)
        fetcher = FETCHER[pkg]("gs://bkt/stage", inter, finished=fin)
        fetched = sorted(_rel(fetcher.fetch_once(), tmp_path / pkg))
        assert fetcher.fetch_once() == []      # nothing new
        moved = _rel(MOVER[pkg](inter, fin).move_once(), tmp_path / pkg)
        assert fetcher.fetch_once() == []      # moved: not fetched again
        cache = CACHE[pkg](inter, fin)
        path = cache.get_log_file("app_remote", "worker_0_s0", "stdout")
        with open(path) as f:
            body = f.read()
        out[pkg] = (fetched, moved, dataclasses.asdict(
            cache.get_metadata("app_remote")),
            cache.get_config("app_remote"), body)
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 3 and out["port"][4] == "remote body\n"
    assert _snapshot(tmp_path / "port") == _snapshot(tmp_path / "jax")


# ---------------------------------------------------------------------------
# one rich tree, both readers: synthetic apps and a job the port's AM ran
# ---------------------------------------------------------------------------

def _serving_app(inter: str) -> None:
    """A KILLED serving job whose page shows its endpoint through the
    proxy (the JAX test_job_page_renders_serving_endpoint history)."""
    from tony_tpu.events.handler import EventHandler
    from tony_tpu.events.history import JobMetadata, history_file_name
    from tony_tpu.events.schema import (
        Event, EventType, ServingEndpointRegistered, TaskStarted,
    )
    app_dir = os.path.join(inter, "app_srv")
    os.makedirs(app_dir)
    handler = EventHandler(app_dir, JobMetadata(
        application_id="app_srv", started=10, user="alice"))
    handler.start()
    handler.emit(Event(EventType.TASK_STARTED,
                       TaskStarted("serving", 0, "hostB", "container_9"),
                       timestamp=11))
    handler.emit(Event(EventType.SERVING_ENDPOINT_REGISTERED,
                       ServingEndpointRegistered("serving", 0,
                                                 "http://hostB:9900"),
                       timestamp=12))
    path = handler.stop("KILLED")
    os.replace(path, os.path.join(app_dir, history_file_name(JobMetadata(
        application_id="app_srv", started=10, completed=20, user="alice",
        status="KILLED"))))
    with open(os.path.join(app_dir, C.PORTAL_CONFIG_FILE), "w") as f:
        json.dump({"tony.proxy.url": "http://gateway:7000"}, f)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """intermediate + finished + staging: synthetic apps of the JAX
    portal tests and one failed job under the port's own AM (history,
    sidecars, aggregated logs, jobstate in the staging location)."""
    root = tmp_path_factory.mktemp("tree")
    inter, fin = str(root / "int"), str(root / "fin")
    stage = str(root / "stage")
    ensure_history_dirs(inter, fin)
    make_app_history(inter, "app_done", completed=2000, user="alice",
                     config={"tony.worker.instances": 2})
    make_app_history(inter, "app_bob", completed=3000, user="bob",
                     config={"k": "vb"},
                     logs={"worker_0_s0": {"stdout": "real body 42\n",
                                           "stderr": "warnings\n"},
                           "am": {"stdout": "am out\n"}})
    make_app_history(inter, "app_live", final=False, started=5000,
                     user="alice")
    _serving_app(inter)
    JaxMover(inter, fin, stale_sec=3600).move_once()
    proc, app_dir = _start(root, "port", "portal", {
        "tony.worker.instances": 1,
        "tony.task.command": "sleep 1; exit 3",
        "tony.history.intermediate": inter,
        "tony.staging.location": stage,
        "tony.alerts.mfu-floor-pct": 1})
    _, stderr = proc.communicate(timeout=120)
    assert proc.returncode == 1, stderr[-4000:]
    return {"inter": inter, "fin": fin, "stage": stage,
            "am_job": os.path.basename(app_dir)}


def _cache_answers(cache, job_ids: list[str], root: str) -> dict:
    out = {"list": [dataclasses.asdict(m) for m in cache.list_metadata()],
           "dicts": cache.metadata_dicts()}
    for j in job_ids:
        md = cache.get_metadata(j)
        links = cache.get_log_links(j)
        files = {}
        for link in links:
            for stream, url in (link.get("streams") or {}).items():
                cdir = url.rsplit("/", 2)[-2]
                path = cache.get_log_file(j, cdir, stream)
                files[f"{cdir}/{stream}"] = (
                    None if path is None else os.path.relpath(path, root))
        out[j] = {
            "metadata": None if md is None else dataclasses.asdict(md),
            "events": cache.get_events(j), "config": cache.get_config(j),
            "links": links, "files": files, "spans": cache.get_spans(j),
            "traces": cache.get_serving_traces(j),
            "metrics": cache.get_metrics_timeseries(j),
            "goodput": cache.get_goodput(j), "skew": cache.get_skew(j),
            "alerts": cache.get_alerts(j),
            "diagnostics": cache.get_diagnostics(j),
            "folded": cache.get_profile_folded(j),
            "am": cache.get_am_info(j), "queue": cache.get_queue(j),
            "escape": cache.get_log_file(j, "../x", "stdout"),
            "bad_stream": cache.get_log_file(j, "worker_0_s0", "secrets")}
    return out


def _jobs(tree) -> list[str]:
    return ["app_done", "app_bob", "app_live", "app_srv", tree["am_job"],
            "missing"]


def test_every_cache_method_answers_alike(tree):
    answers = {pkg: _cache_answers(CACHE[pkg](tree["inter"], tree["fin"]),
                                   _jobs(tree), tree["inter"])
               for pkg in PKGS}
    assert answers["port"] == answers["jax"]
    am = answers["port"][tree["am_job"]]
    assert am["metadata"]["status"] == "FAILED"
    assert am["diagnostics"]["first_failure"]["exit_code"] == 3
    assert am["events"][0]["type"] == "APPLICATION_INITED"
    assert am["files"] and am["am"].get("rpc_port")
    assert answers["port"]["app_live"]["metadata"]["status"] == "RUNNING"


def test_the_history_the_port_am_wrote_reads_alike(tree):
    """The port's AM wrote every sidecar a job leaves; the JAX cache
    reads them as the port's does (the AM record of tests/
    test_torch_am.py: events without TASK_FINISHED, status, first
    failure)."""
    j = tree["am_job"]
    reads = {}
    for pkg in PKGS:
        cache = CACHE[pkg](tree["inter"], tree["fin"])
        reads[pkg] = {
            "events": [e["type"] for e in cache.get_events(j)
                       if e["type"] != "TASK_FINISHED"],
            "status": cache.get_metadata(j).status,
            "first": cache.get_diagnostics(j)["first_failure"],
            "sidecars": sorted(k for k in ("spans", "goodput", "skew",
                                           "alerts", "diagnostics")
                               if getattr(cache, f"get_{k}")(j))}
    assert reads["port"] == reads["jax"]
    assert reads["port"]["events"] == [
        "APPLICATION_INITED", "TASK_STARTED", "DIAGNOSTICS_READY",
        "APPLICATION_FINISHED"]
    assert reads["port"]["first"]["task_id"] == "worker:0"


# ---------------------------------------------------------------------------
# two servers over one tree
# ---------------------------------------------------------------------------

AUTH = {
    "open": {},
    "token": {"token": "admin-tok"},
    "users": {"token": "admin-tok",
              "user_tokens": {"alice": "tok-alice", "bob": "tok-bob"}},
}
CREDENTIALS = {"open": [None], "token": [None, "admin-tok", "wrong"],
               "users": ["admin-tok", "tok-alice", "tok-bob", "nope",
                         "%C3%A9"]}


def _start_servers(tree, auth: str) -> dict:
    """Both packages' PortalServer, cache and FleetView over one tree."""
    out = {}
    for pkg in PKGS:
        fleet = FLEET[pkg]
        view = fleet.FleetView(tree["stage"], queues={"default": 4},
                               stale_after_ms=10 ** 12,
                               refresh_interval_ms=0,
                               clock=lambda: FROZEN_MS / 1000.0)
        server = SERVER[pkg](CACHE[pkg](tree["inter"], tree["fin"]),
                             port=0, host="127.0.0.1", fleet=view,
                             **AUTH[auth])
        server.start()
        out[pkg] = server
    return out


@pytest.fixture(scope="module", params=sorted(AUTH))
def servers(request, tree):
    out = _start_servers(tree, request.param)
    yield request.param, out
    for server in out.values():
        server.stop()


def _request(port: int, path: str, cred, bearer: bool,
             data: bytes = None) -> tuple[int, str]:
    headers = {}
    if cred is not None:
        if bearer:
            headers["Authorization"] = f"Bearer {cred}"
        else:
            path += ("&" if "?" in path else "?") + f"token={cred}"
    rq = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                data=data, headers=headers,
                                method="POST" if data is not None
                                else "GET")
    try:
        with urllib.request.urlopen(rq, timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _own_families(text: str) -> dict:
    """The portal's own samples of a /metrics body: the fleet's job and
    cluster gauges and the firing alerts, not the process registry."""
    return {k: v for k, v in parse(text).items()
            if k[0].startswith(("tony_job_", "tony_fleet_",
                                "tony_alert_firing"))}


def _routes(tree) -> list[str]:
    routes = ["/", "/healthz", "/metrics", "/api/jobs", "/api/fleet",
              "/api/fleet/alerts", "/api/fleet/queues", "/api/fleet/nope",
              "/api/nope", "/nope", "/jobs/missing",
              "/logs/app_bob/worker_0_s0/stdout",
              "/logs/app_bob/worker_0_s0/secrets",
              "/logs/app_bob/..%2Fworker_0_s0/stdout",
              f"/logs/{tree['am_job']}/worker_0_s0/stderr"]
    for j in _jobs(tree):
        routes += [f"/jobs/{j}", f"/config/{j}", f"/logs/{j}",
                   f"/jobs/{j}/metrics.json",
                   f"/api/jobs/{j}/logs/worker:0",
                   f"/api/jobs/{j}/logs/worker:0?stream=stdout&offset=0",
                   f"/api/jobs/{j}/logs/worker:0?stream=bogus"]
        routes += [f"/api/jobs/{j}/{what}" for what in (
            "events", "config", "logs", "spans", "metrics", "goodput",
            "diagnostics", "skew", "alerts", "timeline", "serving",
            "requests", "flame", "nope")]
    return routes


def test_every_route_answers_alike(servers, tree, monkeypatch):
    auth, srv = servers
    # the pages' clock and the fleet view's, frozen on both sides
    monkeypatch.setattr(time, "time", lambda: FROZEN_MS / 1000.0)
    for module in (jax_server, port_server):
        monkeypatch.setattr(module, "_now_ms", lambda: FROZEN_MS)
    compared = 0
    for cred in CREDENTIALS[auth]:
        for bearer in ((False, True) if cred is not None else (False,)):
            for path in _routes(tree):
                got = {pkg: _request(s.port, path, cred, bearer)
                       for pkg, s in srv.items()}
                assert got["port"][0] == got["jax"][0], (path, cred, got)
                if path == "/metrics" and got["port"][0] == 200:
                    assert _own_families(got["port"][1]) == \
                        _own_families(got["jax"][1]), (path, cred)
                else:
                    assert got["port"][1] == got["jax"][1], (path, cred)
                compared += 1
    assert compared >= len(_routes(tree))
    # and the routes say what the JAX tests hold them to
    open_cred = None if auth == "open" else "admin-tok"
    status, body = _request(srv["port"].port, "/api/jobs", open_cred,
                            False)
    assert status == 200
    assert {j["application_id"] for j in json.loads(body)} >= {
        "app_done", "app_bob", "app_live", "app_srv", tree["am_job"]}
    status, body = _request(srv["port"].port, "/jobs/app_srv", open_cred,
                            False)
    assert 'href="http://gateway:7000"' in body and "(via proxy)" in body


def test_a_scoped_token_sees_its_own_jobs_alike(tree):
    srv = _start_servers(tree, "users")
    try:
        for pkg, s in srv.items():
            status, body = _request(s.port, "/api/jobs", "tok-bob", False)
            assert status == 200, pkg
            assert [j["application_id"] for j in json.loads(body)] == [
                "app_bob"]
            assert _request(s.port, "/api/jobs/app_done/config", "tok-bob",
                            False)[0] == 404
            assert _request(s.port, "/api/jobs", "nope", False)[0] == 401
    finally:
        for server in srv.values():
            server.stop()


@pytest.mark.parametrize("job,body", [
    ("app_done", b"{}"), ("app_live", b'{"task_id": "worker:0"}'),
    ("missing", b"{}"), ("app_done", b"not json")])
def test_the_profile_post_answers_alike(servers, job, body):
    """The one write route: a finished job is 409 (JAX tests/
    test_perf.py's case), a RUNNING job with no AM address 409, a
    missing one 404."""
    auth, srv = servers
    cred = None if auth == "open" else "admin-tok"
    got = {pkg: _request(s.port, f"/api/jobs/{job}/profile", cred, True,
                         data=body) for pkg, s in srv.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"app_done": 409, "app_live": 409,
                              "missing": 404}[job]
    bad = _request(srv["port"].port, "/api/nope/profile", cred, True,
                   data=b"{}")
    assert bad == _request(srv["jax"].port, "/api/nope/profile", cred,
                           True, data=b"{}")


def test_read_user_tokens_alike(tmp_path):
    f = tmp_path / "users.txt"
    f.write_text("# comment\nalice=tok-a\n\nbob = tok-b\nbad-line\n=x\n")
    assert port_server.read_user_tokens(str(f)) == \
        jax_server.read_user_tokens(str(f)) == {"alice": "tok-a",
                                                "bob": "tok-b"}


# ---------------------------------------------------------------------------
# the daemons
# ---------------------------------------------------------------------------

def _daemon(module: str, hist: str, conf: str, log: str):
    """The daemon with its stdout (the banner) in `log`, its log lines
    in `log`.err."""
    with open(log, "w") as out, open(log + ".err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", module, "--port", "0",
             "--history-location", hist, "--conf", conf],
            cwd=hist, stdout=out, stderr=err,
            env=dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1",
                     TONY_LOG_PLAIN="1"), start_new_session=True)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        with open(log) as f:
            found = re.findall(r"^tony-tpu portal: (http://\S+)/$",
                               f.read(), re.M)
        if found:
            return proc, found[0]
        assert proc.poll() is None, open(log + ".err").read()
        time.sleep(0.05)
    proc.kill()
    raise AssertionError(f"{module}: no banner: {open(log).read()}")


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def test_the_port_daemon_runs_as_the_jax_one(tmp_path):
    """`python -m tony_tpu_torch.portal --port 0` beside `python -m
    tony_tpu.portal`, each over its own copy of one tree: the banner,
    /healthz, the mover filing the final dir, equal /api/jobs, and
    SIGINT exits 0."""
    src = tmp_path / "src"
    inter = str(src / "intermediate")
    ensure_history_dirs(inter, str(src / "finished"))
    # completed now: the purger's default 30-day retention spares it
    now_ms = int(time.time() * 1000)
    make_app_history(inter, "app_fin", started=now_ms - 1000,
                     completed=now_ms, user="alice")
    make_app_history(inter, "app_run", final=False, started=now_ms)
    conf = tmp_path / "portal.json"
    conf.write_text(json.dumps({"tony.history.mover-interval-ms": 100,
                                "tony.history.purger-interval-ms": 100}))
    procs = {}
    try:
        for pkg, module in (("jax", "tony_tpu.portal"),
                            ("port", "tony_tpu_torch.portal")):
            hist = str(tmp_path / pkg)
            shutil.copytree(src, hist)
            procs[pkg] = _daemon(module, hist, str(conf),
                                 str(tmp_path / f"{pkg}.log"))
        for pkg, (proc, url) in procs.items():
            assert _get_json(url + "/healthz") == {"ok": True}
            want = os.path.join(finished_subdir(
                str(tmp_path / pkg / "finished"), now_ms), "app_fin")
            deadline = time.monotonic() + 30
            while not os.path.isdir(want) and time.monotonic() < deadline:
                time.sleep(0.05)
            assert os.path.isdir(want), pkg
        jobs = {pkg: _get_json(url + "/api/jobs")
                for pkg, (_, url) in procs.items()}
        assert jobs["port"] == jobs["jax"]
        assert [(j["application_id"], j["status"]) for j in jobs["port"]] \
            == [("app_run", "RUNNING"), ("app_fin", "SUCCEEDED")]
        for pkg, (proc, _) in procs.items():
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=30) == 0, pkg
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


@pytest.mark.parametrize("module", [
    "portal", "portal.__main__", "portal.cache", "portal.fetcher",
    "portal.mover", "portal.purger", "portal.server", "workflow",
    "workflow.adapter"])
def test_every_name_of_the_jax_module_has_its_namesake(module):
    import importlib
    import inspect

    jax_mod = importlib.import_module(f"tony_tpu.{module}")
    port_mod = importlib.import_module(f"tony_tpu_torch.{module}")
    for name, obj in vars(jax_mod).items():
        if not (inspect.isfunction(obj) or inspect.isclass(obj)) \
                or not getattr(obj, "__module__", "").startswith("tony_tpu."):
            continue
        twin = getattr(port_mod, name, None)
        assert twin is not None, f"{module}.{name}"
        assert twin.__module__ == obj.__module__.replace(
            "tony_tpu.", "tony_tpu_torch.", 1), f"{module}.{name}"
        if inspect.isclass(obj):
            members = {k for k, v in vars(obj).items() if callable(v)}
            assert members <= set(vars(twin)), f"{module}.{name}"


PORTAL_ISOLATION_PROBE = """
import sys
import tony_tpu_torch.portal, tony_tpu_torch.portal.__main__
import tony_tpu_torch.portal.fetcher
bad = sorted({n.split(".")[0] for n in sys.modules}
             & {"torch", "jax", "jaxlib", "tony_tpu", "grpc"})
print(",".join(bad))
"""


def test_the_portal_imports_no_torch_jax_grpc_or_tony_tpu():
    out = subprocess.run([sys.executable, "-c", PORTAL_ISOLATION_PROBE],
                         capture_output=True, text=True, timeout=60,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
