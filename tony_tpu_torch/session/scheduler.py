"""Dependency-DAG gang scheduler.

The port's copy of `tony_tpu/session/scheduler.py`.

Equivalent of the reference's TaskScheduler.java:32-190: builds a jobtype
dependency graph from `tony.<job>.depends-on` (+ prepare/training stages,
folded into depends_on at parse time), rejects cyclic graphs, submits
container requests for dependency-free jobs, and on each task completion
decrements dependency counters and releases newly-unblocked jobs.

The RM side is abstracted behind `ResourceRequestor` so the same scheduler
drives the local process backend today and a real cluster backend later.
"""

from __future__ import annotations

import abc
import dataclasses
import logging
import threading

from tony_tpu_torch.session.requests import JobContainerRequest
from tony_tpu_torch.session.session import TonySession, FinalStatus

LOG = logging.getLogger(__name__)


class ResourceRequestor(abc.ABC):
    """What the scheduler needs from a resource manager (AMRMClientAsync
    equivalent)."""

    @abc.abstractmethod
    def request_containers(self, request: JobContainerRequest) -> None:
        """Ask for request.num_instances containers at request.priority."""


def is_dag(requests: list[JobContainerRequest]) -> bool:
    """Cycle check over the depends-on graph (TaskScheduler.isDAG,
    TaskScheduler.java:153-189)."""
    by_name = {r.job_name: r for r in requests}
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {r.job_name: WHITE for r in requests}

    def visit(name: str) -> bool:
        color[name] = GRAY
        for dep in by_name[name].depends_on:
            if dep not in by_name:
                continue
            if color[dep] == GRAY:
                return False
            if color[dep] == WHITE and not visit(dep):
                return False
        color[name] = BLACK
        return True

    for name in list(color):
        if color[name] == WHITE and not visit(name):
            return False
    return True


class TaskScheduler:
    def __init__(self, session: TonySession, requestor: ResourceRequestor):
        self.session = session
        self.requestor = requestor
        # job -> {dependency job -> instances still running}
        self._waiting: dict[str, dict[str, int]] = {}
        self._scheduled: set[str] = set()
        self._lock = threading.Lock()
        self.dependency_check_passed = True

    def schedule_tasks(self) -> None:
        """Entry point (TaskScheduler.scheduleTasks, TaskScheduler.java:57-75)."""
        requests = list(self.session.requests.values())
        if not is_dag(requests):
            LOG.error("execution graph is not a DAG")
            self.session.set_final_status(
                FinalStatus.FAILED, "App failed due to it not being a DAG.")
            self.dependency_check_passed = False
            return
        with self._lock:
            for req in requests:
                deps = {d: self.session.requests[d].num_instances
                        for d in req.depends_on}
                if deps:
                    self._waiting[req.job_name] = deps
            for req in requests:
                if req.job_name not in self._waiting:
                    self._schedule_job(req)

    def _schedule_job(self, request: JobContainerRequest) -> None:
        """(TaskScheduler.scheduleJob, TaskScheduler.java:95-107)."""
        LOG.info("scheduling %d x %s (priority %d)", request.num_instances,
                 request.job_name, request.priority)
        self._scheduled.add(request.job_name)
        self.session.num_expected_tasks += request.num_instances
        self.requestor.request_containers(request)

    def schedule_replacement(self, job_name: str) -> None:
        """Re-request ONE container for a relaunched task slot at the
        jobtype's priority (no reference equivalent — the reference rebuilt
        the whole session). num_expected_tasks is untouched: the slot is
        recycled, not added, and the allocation matches it through the same
        unique-priority path as the original launch."""
        request = self.session.requests[job_name]
        LOG.info("re-requesting 1 x %s replacement (priority %d)",
                 job_name, request.priority)
        self.requestor.request_containers(
            dataclasses.replace(request, num_instances=1))

    def schedule_scale_up(self, job_name: str) -> None:
        """Request ONE container for a freshly ADDED task slot
        (serving-fleet scale-up — session.add_task_instance appended the
        slot): unlike schedule_replacement, the expected-task count grows,
        so the rendezvous barrier waits for the newcomer too."""
        request = self.session.requests[job_name]
        LOG.info("requesting 1 extra %s instance (priority %d, now %d "
                 "expected)", job_name, request.priority,
                 self.session.num_expected_tasks + 1)
        self.session.num_expected_tasks += 1
        self.requestor.request_containers(
            dataclasses.replace(request, num_instances=1))

    def register_dependency_completed(self, job_name: str) -> None:
        """One instance of `job_name` completed: decrement counters; release
        any job whose dependencies are all done
        (TaskScheduler.registerDependencyCompleted, TaskScheduler.java:129-151)."""
        with self._lock:
            for deps in self._waiting.values():
                if job_name in deps:
                    deps[job_name] -= 1
                    if deps[job_name] <= 0:
                        del deps[job_name]
            ready = [j for j, deps in self._waiting.items() if not deps]
            for job in ready:
                del self._waiting[job]
                self._schedule_job(self.session.requests[job])

    def is_scheduled(self, job_name: str) -> bool:
        with self._lock:
            return job_name in self._scheduled
