"""The port's fleet readers (`tony_tpu_torch/observability/fleet.py`) and
the elastic resize's jobstate publish against the JAX package's.

The same jobstate summaries, made from a seed with numpy, go through
both packages under one fake clock: the registry (LOST demotion, the
terminal latch, eviction, the settled-file memo of a store scan), the
ledger (chip-second folds, LOST refolds, the durable accounting file),
the quota view, the fleet `/metrics` families and `FleetView`'s payloads
and its `cli top` frame. Each comparison is of plain dicts and text.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest

from tony_tpu.observability import fleet as jfleet
from tony_tpu.observability import prometheus as jprom
from tony_tpu.storage import staging_store as j_staging_store
from tony_tpu_torch.observability import fleet as pfleet
from tony_tpu_torch.observability import prometheus as pprom
from tony_tpu_torch.storage import staging_store as p_staging_store

FLEET = {"jax": jfleet, "port": pfleet}
STATES = ("RUNNING", "SUCCEEDED", "FAILED", "KILLED", "PREEMPTED")


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, s: float) -> None:
        self.t += s


def _summaries(mod, seed: int, n: int, now_ms: int) -> list[dict]:
    """n summaries from a seed: states, queues, users, chips, extents,
    goodput and gauges drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        started = int(now_ms - rng.integers(10_000, 400_000))
        hb = int(min(now_ms, started + rng.integers(1_000, 300_000)))
        chips = int(rng.integers(1, 9))
        goodput = (None if rng.random() < 0.2
                   else round(float(rng.uniform(10, 100)), 2))
        out.append(mod.job_summary(
            f"app_{seed}_{i:03d}", f"u{int(rng.integers(0, 3))}",
            f"q{int(rng.integers(0, 3))}",
            STATES[int(rng.integers(0, len(STATES)))],
            gang_width=int(rng.integers(1, 5)), requested_chips=chips,
            allocated_chips=chips if rng.random() < 0.7 else 0,
            started_ms=started, heartbeat_ms=hb, goodput_pct=goodput,
            straggler_count=int(rng.integers(0, 3)),
            alerts_firing=int(rng.integers(0, 2)),
            priority=int(rng.integers(-1, 3)),
            gauges={"tony_job_goodput_pct": goodput or 0.0,
                    "tony_job_step_time_p50_ms":
                        round(float(rng.uniform(5, 50)), 3)}))
    return out


def _registry_run(mod, seed: int) -> dict:
    clock = FakeClock(1000.0)
    reg = mod.FleetRegistry(stale_after_ms=20_000, max_jobs=12,
                            clock=clock)
    trace = []
    for s in _summaries(mod, seed, 30, int(clock() * 1000)):
        reg.observe(s)
        trace.append(len(reg))
    # a stale RUNNING file after a terminal one must not resurrect it
    for j in reg.jobs():
        if j["state"] in ("SUCCEEDED", "FAILED"):
            reg.observe(dict(j, state="RUNNING",
                             heartbeat_ms=j["heartbeat_ms"] + 1))
            break
    clock.tick(5.0)
    reg.refresh(force=True)
    first = reg.jobs()
    clock.tick(400.0)                 # every RUNNING entry goes stale
    reg.refresh(force=True)
    return {"sizes": trace, "first": first, "after": reg.jobs(),
            "live": reg.live_jobs(), "chips": reg.chips_in_use(),
            "timeline": reg.timeline(),
            "get": reg.get(first[0]["app_id"]) if first else None}


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_matches_jax(seed):
    got = {pkg: _registry_run(mod, seed) for pkg, mod in FLEET.items()}
    assert got["port"] == got["jax"]
    states = {j["state"] for j in got["port"]["after"]}
    assert jfleet.LOST_STATE in states and "RUNNING" not in states
    assert max(got["port"]["sizes"]) == 12


def test_every_am_job_gauge_is_in_the_fleet_map():
    """Every `tony_job_*` name the port's AM source mentions is a key of
    the fleet's aggregation map, and the map is the JAX package's."""
    import re
    from tony_tpu_torch.am import application_master
    with open(application_master.__file__) as f:
        names = set(re.findall(r"tony_job_\w+", f.read()))
    assert names and names <= set(pfleet.JOB_GAUGES)
    assert pfleet.JOB_GAUGES == jfleet.JOB_GAUGES
    assert pfleet.STEP_TIME_GAUGES == jfleet.STEP_TIME_GAUGES


def test_sort_jobs_and_chips_of_match_jax():
    for pkg, mod in FLEET.items():
        jobs = _summaries(mod, 3, 20, 5_000_000)
        assert [j["app_id"] for j in mod.sort_jobs(jobs)] == [
            j["app_id"] for j in jfleet.sort_jobs(jobs)], pkg
        assert [mod.chips_of(j) for j in jobs] == [
            jfleet.chips_of(j) for j in jobs], pkg


def _ledger_run(mod, seed: int, loc: str) -> dict:
    clock = FakeClock(2000.0)
    ledger = mod.FleetLedger(loc, history_jobs=8, clock=clock)
    folds = []
    rng = np.random.default_rng(seed + 100)
    for s in _summaries(mod, seed, 25, 2_000_000):
        if s["state"] == "RUNNING":
            s = dict(s, state=mod.LOST_STATE)
        goodput = ({"job": {"goodput_pct": float(rng.uniform(0, 100))}}
                   if rng.random() < 0.3 else None)
        folds.append(ledger.fold(s, goodput=goodput))
    # a LOST job whose real terminal state shows up later is refolded
    lost = next(s for s in _summaries(mod, seed, 25, 2_000_000)
                if s["state"] == "RUNNING")
    ghost = dict(lost, state="SUCCEEDED",
                 heartbeat_ms=lost["heartbeat_ms"] + 3_600_000)
    refold = (ledger.should_fold(ghost), ledger.fold(ghost),
              ledger.fold(ghost))
    ledger.save(force=True)
    with open(os.path.join(loc, mod.ACCOUNTING_KEY)) as f:
        saved = json.load(f)
    reborn = mod.FleetLedger(loc, history_jobs=8, clock=clock)
    return {"folds": folds, "refold": refold,
            "accounting": ledger.accounting(), "saved": saved,
            "reborn": reborn.accounting(), "len": len(ledger)}


@pytest.mark.parametrize("seed", [0, 5])
def test_ledger_matches_jax(seed, tmp_path):
    got = {pkg: _ledger_run(mod, seed, str(tmp_path / pkg))
           for pkg, mod in FLEET.items()}
    assert got["port"] == got["jax"]
    acct = got["port"]["accounting"]
    assert got["port"]["len"] == 8 and acct["folded_jobs"] > 0
    assert got["port"]["refold"][0] is True
    assert got["port"]["reborn"] == acct


def test_quota_and_fleet_families_match_jax():
    """The quota rollup and the fleet /metrics text, byte for byte,
    parsed back through each package's own parser."""
    queues = {"q0": 8, "q1": 4, "unused": 2}
    out = {}
    for pkg, mod in FLEET.items():
        prom = jprom if pkg == "jax" else pprom
        live = [j for j in _summaries(mod, 7, 24, 9_000_000)
                if j["state"] == "RUNNING"]
        text = prom.render(mod.fleet_families(live, queues=queues))
        parsed = prom.parse(text)
        out[pkg] = (mod.quota_utilization(queues, live), text,
                    prom.get_sample(parsed, "tony_fleet_chips_in_use"))
    assert out["port"] == out["jax"]
    assert out["port"][0]["q0"]["max_tpus"] == 8
    assert "tony_job_goodput_pct{" in out["port"][1]


def _publish(mod, store_fn, staging: str, root: str, summaries) -> None:
    for s in summaries:
        store = store_fn(staging, os.path.join(root, "apps", s["app_id"]))
        mod.publish_job_state(store, s, root)


def _view_run(mod, store_fn, root: str, monkeypatch) -> dict:
    """A FleetView over a staging store of published jobstate files,
    scanned twice: settled terminal files are read once, RUNNING ones
    go LOST, the ledger folds and saves, and `cli top` renders it."""
    staging = os.path.join(root, "staging")
    now_ms = 50_000_000
    summaries = _summaries(mod, 11, 14, now_ms)
    for s in summaries:
        s["heartbeat_ms"] = now_ms - 1000 if s["state"] == "RUNNING" \
            else s["heartbeat_ms"]
    _publish(mod, store_fn, staging, root, summaries)
    clock = FakeClock(now_ms / 1000.0)
    view = mod.FleetView(staging, queues={"q0": 16, "q1": 8},
                         stale_after_ms=5_000, history_jobs=50,
                         refresh_interval_ms=0, clock=clock)
    reads = []
    orig = mod._read_json_key
    monkeypatch.setattr(mod, "_read_json_key", lambda store, key: (
        reads.append(key), orig(store, key))[1])
    view.refresh(force=True)
    first = {"fleet": view.api_fleet(), "queues": view.api_queues(),
             "alerts": view.api_alerts(),
             "text": (jprom if mod is jfleet else pprom).render(
                 view.families())}
    clock.tick(10.0)                  # the RUNNING entries go LOST
    view.refresh(force=True)
    second = {"fleet": view.api_fleet(), "queues": view.api_queues(),
              "alerts": view.api_alerts()}
    for payload in (first["fleet"], second["fleet"]):
        payload.pop("generated_ms")
    return {"first": first, "second": second,
            "reads": sorted(reads)}


def test_fleet_view_matches_jax(tmp_path, monkeypatch):
    got = {}
    for pkg, mod in FLEET.items():
        store_fn = j_staging_store if pkg == "jax" else p_staging_store
        got[pkg] = _view_run(mod, store_fn, str(tmp_path / pkg),
                             monkeypatch)
    assert got["port"] == got["jax"]
    jobs = got["port"]["second"]["fleet"]["jobs"]
    assert {j["state"] for j in jobs} >= {jfleet.LOST_STATE}
    # a settled (non-LOST terminal) file is fetched by the first scan only
    settled = [j["app_id"] for j in got["port"]["first"]["fleet"]["jobs"]
               if j["state"] in ("SUCCEEDED", "FAILED", "KILLED")]
    assert settled
    for app in settled:
        assert got["port"]["reads"].count(
            f"{app}/{jfleet.JOBSTATE_KEY}") == 1


def test_cli_top_frame_matches_jax(tmp_path, monkeypatch):
    """`_render_fleet_frame` of both CLIs over the same store, with the
    wall clock held for the heartbeat ages."""
    from tony_tpu.cli import __main__ as jcli
    from tony_tpu_torch.cli import __main__ as pcli
    now = time.time()
    staging = str(tmp_path / "staging")
    summaries = _summaries(jfleet, 13, 10, int(now * 1000))
    for s in summaries:
        if s["state"] == "RUNNING":
            s["heartbeat_ms"] = int(now * 1000) - 1500
            s["requested_width"] = s["gang_width"] + 1
    _publish(jfleet, j_staging_store, staging, str(tmp_path), summaries)
    frames = {}
    for pkg, (mod, cli) in {"jax": (jfleet, jcli),
                            "port": (pfleet, pcli)}.items():
        view = mod.FleetView(staging, queues={"q0": 12},
                             settle_accounting=False)
        view.refresh(force=True)
        monkeypatch.setattr(time, "time", lambda: now + 2.0)
        frames[pkg] = cli._render_fleet_frame(view)
        monkeypatch.undo()
    assert frames["port"] == frames["jax"]
    assert "live job(s)" in frames["port"] and "q0" in frames["port"]


# ---------------------------------------------------------------------------
# the elastic coordinator republishes the jobstate on a resize transition
# ---------------------------------------------------------------------------

def _resize_am(pkg: str, tmp_path):
    """An in-process AM of `pkg` with a stub backend and scheduler, a
    4-worker gang registered, and a staging store as `prepare()` builds
    it; the periodic publish is throttled far out, so only a forced
    publish can write the jobstate."""
    if pkg == "jax":
        from tony_tpu.am.application_master import ApplicationMaster
        from tony_tpu.conf import TonyConfiguration
        from tony_tpu.session.session import TonySession
        store_fn = j_staging_store
    else:
        from tony_tpu_torch.am.application_master import ApplicationMaster
        from tony_tpu_torch.conf import TonyConfiguration
        from tony_tpu_torch.session.session import TonySession
        store_fn = p_staging_store

    class _Backend:
        def start(self):
            ...

        def stop_container(self, cid):
            ...

        def release_container(self, cid):
            ...

    class _Scheduler:
        def schedule_scale_up(self, job_name):
            ...

    staging = str(tmp_path / pkg / "staging")
    app_dir = str(tmp_path / pkg / "app_elastic")
    os.makedirs(app_dir)
    conf = TonyConfiguration()
    for k, v in {"tony.elastic.enabled": True, "tony.worker.instances": 4,
                 "tony.worker.tpus": 2, "tony.staging.location": staging,
                 "tony.fleet.publish-interval-ms": 3_600_000}.items():
        conf.set(k, v, "test")
    am = ApplicationMaster(conf, "app_elastic", app_dir, backend=_Backend())
    session = TonySession(conf, session_id=0)
    session.num_expected_tasks = 4
    for i in range(4):
        session.get_task("worker", i).container_id = f"c{i}"
        session.register_worker_spec_with_generation(f"worker:{i}",
                                                     f"h{i}:1")
    am.session = session
    am.scheduler = _Scheduler()
    am.event_handler.emit = lambda event: None
    am._fleet_store = store_fn(staging, app_dir)
    am._fleet_last_publish = time.monotonic()
    return am, os.path.join(staging, "app_elastic", jfleet.JOBSTATE_KEY)


def test_resize_start_republishes_the_jobstate_alike(tmp_path):
    """RESIZE_STARTED publishes the jobstate at once with the requested
    width, as the JAX coordinator does; the periodic publish alone would
    leave it unwritten for the whole interval."""
    got = {}
    for pkg in ("jax", "port"):
        am, path = _resize_am(pkg, tmp_path)
        assert not os.path.exists(path)
        am._publish_fleet_state()            # throttled: writes nothing
        assert not os.path.exists(path)
        resp = am.elastic.request_resize({"width": 6, "reason": "test"})
        assert resp.get("error") is None, resp
        assert os.path.exists(path), f"{pkg}: no jobstate after the resize"
        with open(path) as f:
            got[pkg] = {k: v for k, v in json.load(f).items()
                        if k not in ("heartbeat_ms", "started_ms")}
    assert got["port"] == got["jax"]
    assert got["port"]["gang_width"] == 4
    assert got["port"]["requested_width"] == 6


def test_resize_publish_failure_never_blocks_the_resize(tmp_path):
    am, path = _resize_am("port", tmp_path)
    calls = []

    def _boom(state="RUNNING", force=False):
        calls.append(force)
        raise RuntimeError("store down")

    am._publish_fleet_state = _boom
    resp = am.elastic.request_resize({"width": 2, "reason": "test"})
    assert resp.get("error") is None and resp["to_width"] == 2
    assert calls == [True]
