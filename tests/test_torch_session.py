"""The port's session layer against the JAX package's: container
requests, the gang barrier and its cluster spec, allocation matching by
priority, the scheduler's dependency order, relaunches with their spec
diffs, and the rules that decide a session's final status.

Each case drives `tony_tpu.session` and `tony_tpu_torch.session` through
the same calls on the same configuration and compares what they answer.
"""

from __future__ import annotations

import dataclasses

import pytest

from tony_tpu.conf import TonyConfiguration as JaxConf
from tony_tpu.session import requests as jrequests
from tony_tpu.session import scheduler as jscheduler
from tony_tpu.session import session as jsession
from tony_tpu_torch.conf import TonyConfiguration as PortConf
from tony_tpu_torch.session import requests as prequests
from tony_tpu_torch.session import scheduler as pscheduler
from tony_tpu_torch.session import session as psession

PACKAGES = {"jax": (JaxConf, jrequests, jscheduler, jsession),
            "port": (PortConf, prequests, pscheduler, psession)}


def _conf(pkg: str, settings: dict):
    conf = PACKAGES[pkg][0]()
    for k, v in settings.items():
        conf.set(k, v, "test")
    return conf


def _both(fn, settings: dict):
    """fn(conf, requests_mod, scheduler_mod, session_mod) on both
    packages; returns (port's, jax's)."""
    out = {}
    for pkg, (_, req, sch, ses) in PACKAGES.items():
        out[pkg] = fn(_conf(pkg, settings), req, sch, ses)
    return out["port"], out["jax"]


REQUEST_CASES = {
    "workers": {"tony.worker.instances": 3, "tony.worker.tpus": 4,
                "tony.worker.memory": "4g", "tony.worker.vcores": 2},
    "ps_chief": {"tony.ps.instances": 2, "tony.worker.instances": 2,
                 "tony.chief.instances": 1, "tony.worker.gpus": 1,
                 "tony.ps.command": "python ps.py",
                 "tony.application.untracked.jobtypes": "ps"},
    "depends": {"tony.prep.instances": 1, "tony.worker.instances": 2,
                "tony.worker.depends-on": "prep",
                "tony.worker.node-label": "tpu-v5e"},
    "stages": {"tony.prep.instances": 1, "tony.eval.instances": 1,
               "tony.worker.instances": 2,
               "tony.application.prepare-stage": "prep"},
    "serving": {"tony.serving.instances": 2, "tony.serving.tpus": 1,
                "tony.worker.instances": 1},
    "zero": {"tony.worker.instances": 0, "tony.ps.instances": 1},
}


@pytest.mark.parametrize("case", sorted(REQUEST_CASES))
def test_parse_container_requests_agrees(case):
    port, jax_ = _both(
        lambda conf, req, sch, ses: {
            k: dataclasses.asdict(v)
            for k, v in req.parse_container_requests(conf).items()},
        REQUEST_CASES[case])
    assert port == jax_
    assert port, case


@pytest.mark.parametrize("settings", [
    {"tony.worker.instances": 1, "tony.worker.depends-on": "nope"},
    {"tony.prep.instances": 1, "tony.worker.instances": 1,
     "tony.application.prepare-stage": "prep",
     "tony.application.training-stage": "prep,worker"},
], ids=["unknown-dependency", "stages-overlap"])
def test_bad_requests_are_refused_alike(settings):
    def run(conf, req, sch, ses):
        try:
            req.parse_container_requests(conf)
        except ValueError as e:
            return str(e)
        return "accepted"
    port, jax_ = _both(run, settings)
    assert port == jax_ != "accepted"


class _Recorder:
    def __init__(self):
        self.asked: list[tuple[str, int, int]] = []

    def request_containers(self, request) -> None:
        self.asked.append((request.job_name, request.num_instances,
                           request.priority))


def _gang(conf, req, sch, ses):
    """Schedule, allocate by priority, register everyone, return every
    answer along the way."""
    session = ses.TonySession(conf, session_id=3)
    rec = _Recorder()
    sched = sch.TaskScheduler(session, rec)
    sched.schedule_tasks()
    trail = [("asked", list(rec.asked), session.num_expected_tasks)]
    port_of = 7000
    for job, num, prio in list(rec.asked):
        for i in range(num):
            t = session.match_allocation(prio, f"c_{job}_{i}", "h0")
            trail.append(("matched", prio, t and t.task_id))
    trail.append(("unmatched", session.match_allocation(99, "c_x", "h0")))
    for job, tasks in session.job_tasks.items():
        if not sched.is_scheduled(job):
            continue
        for t in tasks:
            port_of += 1
            spec, gen, ok = session.register_worker_spec_with_generation(
                t.task_id, f"h{t.index}:{port_of}")
            trail.append(("registered", t.task_id, spec, gen, ok))
    trail.append(("spec", session.cluster_spec_json(),
                  session.all_tasks_registered(),
                  [(i.name, i.index, i.url, str(i.status))
                   for i in session.get_task_infos()]))
    trail.append(("chief", [session.is_chief(j, 0)
                            for j in sorted(session.job_tasks)]))
    return session, sched, rec, trail


@pytest.mark.parametrize("case", ["workers", "ps_chief", "serving"])
def test_the_gang_barrier_and_cluster_spec_agree(case):
    port, jax_ = _both(lambda *a: _gang(*a)[3], REQUEST_CASES[case])
    assert port == jax_


@pytest.mark.parametrize("case", ["depends", "stages"])
def test_the_scheduler_releases_dependents_in_the_same_order(case):
    def run(conf, req, sch, ses):
        session, sched, rec, trail = _gang(conf, req, sch, ses)
        order = [list(rec.asked)]
        # the prerequisite's instances complete one by one
        for job, tasks in sorted(session.job_tasks.items()):
            if sched.is_scheduled(job):
                for t in tasks:
                    session.on_task_completed(job, t.index, 0)
                    sched.register_dependency_completed(job)
                    order.append((t.task_id, list(rec.asked),
                                  session.num_expected_tasks))
        return trail, order
    port, jax_ = _both(run, REQUEST_CASES[case])
    assert port == jax_
    assert len(port[1][-1][1]) > len(port[1][0]), "no dependent released"


def test_a_cycle_fails_the_session_alike():
    settings = {"tony.a.instances": 1, "tony.b.instances": 1,
                "tony.a.depends-on": "b", "tony.b.depends-on": "a"}

    def run(conf, req, sch, ses):
        session = ses.TonySession(conf)
        sched = sch.TaskScheduler(session, _Recorder())
        sched.schedule_tasks()
        return (sched.dependency_check_passed, str(session.final_status),
                session.final_message)
    port, jax_ = _both(run, settings)
    assert port == jax_ and port[0] is False


def test_relaunch_bumps_the_generation_and_diffs_alike():
    def run(conf, req, sch, ses):
        session, sched, rec, _ = _gang(conf, req, sch, ses)
        out = [session.heartbeat_spec_fields(1)]
        relaunched = session.relaunch_task("worker", 1)
        out.append((relaunched.task_id, relaunched.attempt,
                    session.spec_generation,
                    session.heartbeat_spec_fields(1),
                    session.all_tasks_registered()))
        out.append(session.register_worker_spec_with_generation(
            "worker:1", "h9:9999", expected_attempt=0))   # a stale attempt
        out.append(session.register_worker_spec_with_generation(
            "worker:1", "h9:9999", expected_attempt=relaunched.attempt))
        out.append((session.heartbeat_spec_fields(1),
                    session.spec_diff_since(1), session.spec_diff_since(0),
                    session.spec_stats))
        return out
    port, jax_ = _both(run, REQUEST_CASES["workers"])
    assert port == jax_


FINAL_CASES = {
    "all-ok": ({}, [("worker", 0, 0), ("worker", 1, 0), ("worker", 2, 0)]),
    "one-fails": ({}, [("worker", 0, 0), ("worker", 1, 3),
                       ("worker", 2, 0)]),
    "all-fail": ({}, [("worker", 0, 1), ("worker", 1, 1), ("worker", 2, 1)]),
    "chief-fails": ({}, [("worker", 0, 2)]),
    "fail-on-worker": ({"tony.application.fail-on-worker-failure-enabled":
                        "true"}, [("worker", 2, 5)]),
    "stop-on-failure": ({"tony.application.stop-on-failure.jobtypes":
                         "worker"}, [("worker", 1, 4)]),
    "killed-by-am": ({}, [("worker", 0, -105), ("worker", 1, 0),
                          ("worker", 2, 0)]),
    "unfinished": ({}, [("worker", 0, 0)]),
}


@pytest.mark.parametrize("case", sorted(FINAL_CASES))
def test_final_status_rules_agree(case):
    extra, exits = FINAL_CASES[case]

    def run(conf, req, sch, ses):
        session, *_ = _gang(conf, req, sch, ses)
        trail = []
        for job, idx, code in exits:
            session.on_task_completed(job, idx, code)
            trail.append((session.training_finished,
                          str(session.final_status), session.final_message))
        session.update_session_status()
        trail.append((str(session.final_status), session.final_message,
                      session.num_failed_tasks(),
                      session.num_completed_tracked_tasks(),
                      session.all_tracked_tasks_completed()))
        return trail
    port, jax_ = _both(run, dict(REQUEST_CASES["workers"], **extra))
    assert port == jax_
