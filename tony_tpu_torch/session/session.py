"""TonySession: in-AM job state machine.

The port's copy of `tony_tpu/session/session.py`.

Equivalent of the reference's tensorflow/TonySession.java:43-561 —
task table per jobtype, allocation→task matching by priority, cluster-spec
construction, chief semantics (:364-367), exit-code→status transitions
(:480-497), failure short-circuit policy (:251-271), final-status aggregation
including "succeed despite some worker failures" (:276-330), and
tracked/untracked accounting.
"""

from __future__ import annotations

import enum
import json
import logging
import threading
from collections import OrderedDict
from typing import Optional

from tony_tpu_torch import constants as C
from tony_tpu_torch.conf import TonyConfiguration, keys as K
from tony_tpu_torch.rpc.messages import TaskInfo, TaskStatus
from tony_tpu_torch.session.requests import JobContainerRequest, parse_container_requests

LOG = logging.getLogger(__name__)

# How many generation bumps the session retains diff material for. An
# executor whose held generation fell further behind than this gets a
# spec_refetch verdict (full-spec fallback) instead of a diff — bounded
# memory beats a perfectly complete diff history.
SPEC_DIFF_WINDOW = 64

# Exit code the AM uses when it kills a container itself. Such exits get
# status FINISHED (not FAILED) and never trigger the failure short-circuit,
# but they DO count as failures in the final aggregation when
# fail-on-worker-failure is enabled — the reference deliberately counts them
# there "to capture any worker task that was killed by the application master
# which was not short circuited" (TonySession.java:316-320, 485-488).
EXIT_KILLED_BY_AM = C.EXIT_KILLED_BY_AM


class FinalStatus(str, enum.Enum):
    UNDEFINED = "UNDEFINED"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    KILLED = "KILLED"
    # checkpoint-then-evict: the application was drained on an arbiter/
    # operator preemption request and is expected to RESUME from its
    # checkpoint later — terminal for this AM, but neither a failure
    # nor an operator kill
    PREEMPTED = "PREEMPTED"


class Task:
    """One task slot (reference: TonySession.TonyTask, TonySession.java:440+).

    A slot survives its container: on a tracked task's crash or heartbeat
    expiry within budget, the slot is reset for a fresh attempt in a
    replacement container (no reference equivalent — the reference's fault
    model rebuilt the whole session instead)."""

    def __init__(self, job_name: str, index: int, session_id: int):
        self.job_name = job_name
        self.index = index
        self.session_id = session_id
        self.attempt = 0            # bumped by reset_for_relaunch
        # attempts consumed by OPERATOR lifecycle (rolling weight
        # updates), not failures: the attempt number still increments
        # (zombie fencing needs it) but these never count against the
        # failure budget — `cli rollout` twice must not eat a replica's
        # crash-relaunch allowance
        self.lifecycle_relaunches = 0
        self.host: str = ""
        self.port: int = -1
        self.container_id: str = ""
        self.url: str = ""
        self.completed = False
        self._exit_status: Optional[int] = None
        self.status = TaskStatus.NEW
        self._lock = threading.Lock()

    @property
    def task_id(self) -> str:
        return f"{self.job_name}:{self.index}"

    @property
    def host_port(self) -> str:
        return f"{self.host}:{self.port if self.port >= 0 else 0}"

    @property
    def exit_status(self) -> Optional[int]:
        return self._exit_status

    def set_host_port(self, host_port: str) -> None:
        host, _, port = host_port.rpartition(":")
        self.host, self.port = host, int(port)

    def set_exit_status(self, status: int, preempted: bool = False) -> None:
        """Settable exactly once — late container-completion callbacks must not
        overwrite the executor-registered result (TonySession.java:480-497).
        `preempted` marks a checkpoint-then-evict drain exit: terminal but
        not a failure, whatever the exit code."""
        with self._lock:
            if self._exit_status is not None:
                return
            self._exit_status = status
            if preempted:
                self.status = TaskStatus.PREEMPTED
            elif status == 0:
                self.status = TaskStatus.SUCCEEDED
            elif status == EXIT_KILLED_BY_AM:
                self.status = TaskStatus.FINISHED
            else:
                self.status = TaskStatus.FAILED
            self.completed = True

    def reset_for_relaunch(self) -> None:
        """Recycle this slot for a replacement container: next attempt, no
        container, no result. The unassigned slot matches the replacement
        allocation exactly like a first launch (match_allocation)."""
        with self._lock:
            self.attempt += 1
            self.host = ""
            self.port = -1
            self.container_id = ""
            self.url = ""
            self.completed = False
            self._exit_status = None
            self.status = TaskStatus.NEW

    def to_task_info(self) -> TaskInfo:
        return TaskInfo(self.job_name, self.index, self.url, self.status)

    def __repr__(self):
        return f"Task({self.task_id}, {self.status.value})"


class TonySession:
    """Session state machine; one per AM attempt (new instance on AM retry,
    reference: ApplicationMaster.reset, ApplicationMaster.java:558-574)."""

    def __init__(self, conf: TonyConfiguration, session_id: int = 0):
        self.conf = conf
        self.session_id = session_id
        self.requests: dict[str, JobContainerRequest] = parse_container_requests(conf)
        self.job_tasks: dict[str, list[Task]] = {
            job: [Task(job, i, session_id) for i in range(req.num_instances)]
            for job, req in self.requests.items()
        }
        self._untracked = set(conf.get_strings(K.APPLICATION_UNTRACKED_JOBTYPES))
        self._stop_on_failure = set(
            conf.get_strings(K.APPLICATION_STOP_ON_FAILURE_JOBTYPES))
        self._fail_on_worker_failure = conf.get_bool(
            K.APPLICATION_FAIL_ON_WORKER_FAILURE, False)
        self.num_expected_tasks = 0       # bumped as the scheduler submits jobs
        self.training_finished = False    # failure short-circuit flag
        self.final_status = FinalStatus.UNDEFINED
        self.final_message: Optional[str] = None
        self._registered: dict[str, str] = {}  # task_id -> host:port  # guarded-by: _lock
        # cluster-spec generation: bumped whenever a task's registration is
        # invalidated for relaunch. Executors compare it against the
        # generation their running spec came from; a newer generation means
        # "re-enter the rendezvous barrier" (without restarting containers).
        self.spec_generation = 1  # guarded-by: _lock
        # coalesced control plane: the rendered cluster-spec JSON is cached
        # per (generation, registration state) — barrier release and
        # get_cluster_spec serve the SAME string to every caller instead of
        # an O(width) json.dumps per poll. Invalidation points: any
        # registration change and every generation bump.
        self._spec_cache: Optional[str] = None  # guarded-by: _lock
        # generation -> {"changed": task_ids whose registration was
        # invalidated (or freshly added) at the bump TO that generation,
        # "removed": {job: {indices}} membership the bump REMOVED (elastic
        # shrink — trailing slots only)} — the diff material; bounded to
        # SPEC_DIFF_WINDOW bumps
        self._gen_changes: OrderedDict[int, dict] = OrderedDict()  # guarded-by: _lock
        # from_generation -> (rendered diff dict, serialized byte size)
        # for the CURRENT generation (cleared with the spec cache)
        self._diff_cache: dict[int, tuple[dict, int]] = {}  # guarded-by: _lock
        # tasks that re-registered at a NEW host:port without a relaunch
        # (no generation bump): folded into the next bump's diff material
        # so survivors patching by diff still pick up the rebind
        self._pending_rebinds: set[str] = set()  # guarded-by: _lock
        # control-plane self-accounting (the bench's spec_bytes_sent and
        # the chaos e2e's zero-full-refetch assertion read these):
        # renders = distinct O(width) json.dumps calls; full/diff serves
        # count payloads actually handed to a caller.
        # guarded-by: _lock
        self.spec_stats = {"renders": 0, "full_serves": 0, "full_bytes": 0,
                           "diff_serves": 0, "diff_bytes": 0}
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    # task lookup / allocation matching
    # ------------------------------------------------------------------
    def get_task(self, job_name: str, index: int) -> Optional[Task]:
        tasks = self.job_tasks.get(job_name)
        if tasks is None or not (0 <= index < len(tasks)):
            return None
        return tasks[index]

    def get_task_by_id(self, task_id: str) -> Optional[Task]:
        name, _, idx = task_id.rpartition(":")
        try:
            return self.get_task(name, int(idx))
        except ValueError:
            return None

    def match_allocation(self, priority: int, container_id: str,
                         host: str) -> Optional[Task]:
        """Match an allocated container to the next unassigned task of the
        jobtype carrying `priority` (reference: getAndInitMatchingTaskByPriority,
        TonySession.java:208-224 — priorities are unique per jobtype)."""
        with self._lock:
            for job, req in self.requests.items():
                if req.priority != priority:
                    continue
                for task in self.job_tasks[job]:
                    if not task.container_id:
                        task.container_id = container_id
                        task.host = host
                        task.status = TaskStatus.RUNNING
                        return task
            return None

    # ------------------------------------------------------------------
    # rendezvous
    # ------------------------------------------------------------------
    # inner primitive: the only RPC entry is
    # register_worker_spec_with_generation below, which fences the attempt
    # under the same lock acquisition before delegating here
    # tony: disable=attempt-fencing -- fenced by the _with_generation wrapper
    def register_worker_spec(self, task_id: str, host_port: str) -> Optional[str]:
        """Record a worker's host:port. Returns the full cluster-spec JSON once
        ALL expected tasks have registered, else None — the gang barrier
        (reference: ApplicationMaster.java:840-888)."""
        with self._lock:
            task = self.get_task_by_id(task_id)
            if task is None:
                LOG.warning("registration from unknown task %s", task_id)
                return None
            task.set_host_port(host_port)
            if task_id not in self._registered:
                LOG.info("registered %s at %s (%d/%d)", task_id, host_port,
                         len(self._registered) + 1, self.num_expected_tasks)
                self._invalidate_spec_cache()
            elif self._registered[task_id] != task.host_port:
                # executor restarted and rebound: refresh the address so the
                # spec never points peers at a dead port
                LOG.warning("task %s re-registered at %s (was %s)", task_id,
                            task.host_port, self._registered[task_id])
                # no generation bump here, so no diff ever carries this
                # rebind on its own — remember it and fold it into the
                # NEXT bump's diff material, matching what a survivor's
                # full re-fetch at that bump would have picked up
                self._pending_rebinds.add(task_id)
                self._invalidate_spec_cache()
            self._registered[task_id] = task.host_port
            spec = self.cluster_spec_json()
            if spec is not None:
                self.note_full_serve(spec)   # RLock: safe under self._lock
            return spec

    def register_worker_spec_with_generation(
            self, task_id: str, host_port: str,
            expected_attempt: int = -1) -> tuple[Optional[str], int, bool]:
        """register_worker_spec plus the generation the returned spec belongs
        to, read atomically — a relaunch between reading the spec and reading
        the generation would hand an executor a stale spec stamped with the
        new generation, and it would never notice the re-rendezvous.

        `expected_attempt` (>= 0) fences the registration itself: the AM's
        attempt check and this registration would otherwise be separate
        atomic sections, letting a relaunch interleave so a dead attempt's
        in-flight poll re-fills the barrier it was just evicted from.

        Returns (spec_json_or_None, generation, accepted): `accepted` tells
        the caller whether the registration was recorded (a None spec with
        accepted=True just means the barrier is still open), so liveliness
        tracking can be gated on it."""
        with self._lock:
            task = self.get_task_by_id(task_id)
            if (expected_attempt >= 0 and task is not None
                    and task.attempt != expected_attempt):
                LOG.warning("rejecting registration of %s attempt %d "
                            "(slot is at attempt %d)", task_id,
                            expected_attempt, task.attempt)
                return None, self.spec_generation, False
            return (self.register_worker_spec(task_id, host_port),
                    self.spec_generation, task is not None)

    def add_task_instance(self, job_name: str) -> Optional[Task]:
        """Append ONE fresh task slot to a jobtype (serving-fleet
        scale-up): the new slot matches its allocation through the same
        unique-priority path as a first launch, and the barrier re-opens
        until it registers (num_expected_tasks is bumped by the
        scheduler's schedule_scale_up, which requests the container).
        The request's instance count is kept in step so later
        parse-derived views agree with the live table."""
        with self._lock:
            req = self.requests.get(job_name)
            tasks = self.job_tasks.get(job_name)
            if req is None or tasks is None:
                LOG.error("cannot scale unknown jobtype %r", job_name)
                return None
            task = Task(job_name, len(tasks), self.session_id)
            tasks.append(task)
            req.num_instances += 1
            self._invalidate_spec_cache()
            LOG.info("added task slot %s (now %d %s instance(s))",
                     task.task_id, req.num_instances, job_name)
            return task

    def remove_task_instance(self, job_name: str, task_id: str) -> bool:
        """Abandon a never-launched trailing slot (a scale-up whose
        container never arrived): the inverse of add_task_instance.
        Refuses anything that ever held a container or registered — a
        live replica leaves through the normal completion path."""
        with self._lock:
            tasks = self.job_tasks.get(job_name) or []
            if not tasks:
                return False
            task = tasks[-1]
            if (task.task_id != task_id or task.container_id
                    or task.task_id in self._registered):
                return False
            tasks.pop()
            self.requests[job_name].num_instances -= 1
            self.num_expected_tasks -= 1
            self._invalidate_spec_cache()
            LOG.warning("abandoned task slot %s (allocation never "
                        "arrived; now %d %s instance(s))", task_id,
                        self.requests[job_name].num_instances, job_name)
            return True

    def relaunch_task(self, job_name: str, index: int) -> Optional[Task]:
        """Invalidate a task's registration and recycle its slot for a
        replacement attempt. Bumps the cluster-spec generation so surviving
        executors (which keep their containers and localized resources)
        re-enter the rendezvous barrier and pick up the replacement's
        host:port."""
        with self._lock:
            task = self.get_task(job_name, index)
            if task is None:
                return None
            self._registered.pop(task.task_id, None)
            task.reset_for_relaunch()
            # diff material: survivors holding the previous generation get
            # {this task: replacement host:port} piggybacked on heartbeats
            # once the barrier re-closes, instead of re-fetching the full
            # O(width) spec
            self._bump_generation({task.task_id}, {})
            LOG.info("task %s recycled for attempt %d (spec generation %d)",
                     task.task_id, task.attempt, self.spec_generation)
            return task

    # ------------------------------------------------------------------
    # AM crash recovery (journal replay; see am/journal.py)
    # ------------------------------------------------------------------
    def restore_for_recovery(self, num_expected: int, spec_generation: int,
                             instances: Optional[dict[str, int]] = None
                             ) -> None:
        """Rebuild scheduler-owned shape from a journal replay: the
        expected-task count (normally bumped only as the scheduler
        submits jobs — recovery never re-schedules an adopted gang) and
        the cluster-spec generation (so survivors' heartbeat-held
        generations stay meaningful across the AM restart). `instances`
        resizes jobtype tables that an elastic resize or autoscale grew/
        shrank after submit, so adopted task ids land in real slots."""
        with self._lock:
            for job, want in (instances or {}).items():
                tasks = self.job_tasks.get(job)
                req = self.requests.get(job)
                if tasks is None or req is None or want < 1:
                    continue
                while len(tasks) < want:
                    tasks.append(Task(job, len(tasks), self.session_id))
                while len(tasks) > want:
                    tasks.pop()
                req.num_instances = want
            self.num_expected_tasks = num_expected
            self.spec_generation = max(self.spec_generation,
                                       spec_generation)
            self._invalidate_spec_cache()

    def adopt_task(self, task_id: str, host_port: str, attempt: int,
                   container_id: str = "", host: str = "",
                   lifecycle_relaunches: int = 0, completed: bool = False,
                   exit_code: int = 0) -> Optional[Task]:
        """Fold one journaled task back into the table without touching
        its (still-running) container: restore attempt/address/container
        identity and re-close its barrier registration. Completed tasks
        replay their terminal result too — they stay registered exactly
        as they would have in the crashed AM, so the barrier math and
        the final-status aggregation are unchanged by recovery."""
        with self._lock:
            task = self.get_task_by_id(task_id)
            if task is None:
                LOG.warning("journal names unknown task %s; dropping",
                            task_id)
                return None
            task.attempt = attempt
            task.lifecycle_relaunches = lifecycle_relaunches
            if container_id:
                task.container_id = container_id
            if host:
                task.host = host
            if host_port:
                task.set_host_port(host_port)
                self._registered[task_id] = task.host_port
            if completed:
                task.set_exit_status(exit_code)
            else:
                task.completed = False
                task.status = TaskStatus.RUNNING
            self._invalidate_spec_cache()
            return task

    # holds: _lock (every generation bump happens under the session lock)
    def _bump_generation(self, changed_ids: set[str],
                         removed: dict[str, set[int]]) -> int:
        """Advance the spec generation recording its diff material:
        `changed_ids` (relaunched/rebound/added tasks whose host:port a
        survivor must pick up) and `removed` membership (elastic shrink;
        trailing indices only). Pending rebinds fold in, the retained
        window trims, and the render/diff caches invalidate."""
        self.spec_generation += 1
        self._gen_changes[self.spec_generation] = {
            "changed": set(changed_ids) | self._pending_rebinds,
            "removed": {job: set(idxs) for job, idxs in removed.items()
                        if idxs},
        }
        self._pending_rebinds = set()
        while len(self._gen_changes) > SPEC_DIFF_WINDOW:
            self._gen_changes.popitem(last=False)
        self._invalidate_spec_cache()
        return self.spec_generation

    def resize_bump_generation(self, changed_ids: set[str],
                               removed: dict[str, set[int]]) -> int:
        """Elastic-resize edge: one atomic generation bump covering a
        membership change (added task ids and/or removed trailing
        indices). Survivors holding the previous generation receive the
        membership delta as a heartbeat-piggybacked diff once the
        barrier closes at the new width."""
        with self._lock:
            return self._bump_generation(changed_ids, removed)

    def remove_task_slots(self, job_name: str, count: int) -> list[Task]:
        """Elastic shrink: pop `count` TRAILING slots of a jobtype —
        containers stopped (or stopping) by the caller; registrations
        and expected-task accounting leave with them. Unlike
        remove_task_instance (the autoscaler's never-launched abandon
        path) this removes slots that ran: the elastic coordinator has
        already drained their user processes. Returns the removed tasks
        (highest index first). The caller owns the generation bump."""
        removed: list[Task] = []
        with self._lock:
            tasks = self.job_tasks.get(job_name)
            req = self.requests.get(job_name)
            if tasks is None or req is None:
                return removed
            for _ in range(max(0, count)):
                if len(tasks) <= 1:
                    break   # never shrink a jobtype to zero
                task = tasks.pop()
                self._registered.pop(task.task_id, None)
                req.num_instances -= 1
                self.num_expected_tasks -= 1
                removed.append(task)
            if removed:
                self._invalidate_spec_cache()
                LOG.info("removed %d trailing %s slot(s) (now %d "
                         "instance(s))", len(removed), job_name,
                         req.num_instances)
        return removed

    def all_tasks_registered(self) -> bool:
        with self._lock:
            return (self.num_expected_tasks > 0
                    and len(self._registered) >= self.num_expected_tasks)

    def is_task_registered(self, task_id: str) -> bool:
        """Whether ONE task currently holds a barrier registration —
        the elastic grow's rollback clock watches the ADDED slots
        specifically (an unrelated survivor relaunch also reopens the
        barrier and must not be read as 'the grow failed')."""
        with self._lock:
            return task_id in self._registered

    def cluster_spec_json(self) -> Optional[str]:
        """JSON {jobtype: ["host:port", ...]} over registered tasks, or None
        while the barrier is open (TonySession.getClusterSpec,
        TonySession.java:226-246). The render is cached per generation /
        registration state: at width 1k every barrier poll re-rendering
        O(width) JSON was the AM's hottest needless loop."""
        with self._lock:
            if not self.all_tasks_registered():
                return None
            if self._spec_cache is None:
                spec: dict[str, list[str]] = {}
                for job, tasks in self.job_tasks.items():
                    entries = [t.host_port for t in tasks
                               if t.task_id in self._registered]
                    if entries:
                        spec[job] = entries
                self._spec_cache = json.dumps(spec)
                self.spec_stats["renders"] += 1
            return self._spec_cache

    # holds: _lock (every caller invalidates under the session lock)
    def _invalidate_spec_cache(self) -> None:
        self._spec_cache = None
        self._diff_cache.clear()

    def spec_diff_since(self, from_generation: int
                        ) -> tuple[Optional[dict], bool]:
        """Generation-keyed spec diff for an executor that already holds
        `from_generation`: returns (diff, refetch_needed).

        diff = {"generation": current, "changed": {job: {index: host_port}},
        "removed": {job: [indices]}?} covering every bump in
        (from_generation, current] — O(changed tasks) bytes instead of
        the O(width) full spec. Piggybacked on heartbeat responses by
        the AM. Membership changes ride it too (elastic resize): an
        added task appears under `changed` at its new index, a shrunk-
        away trailing slot under `removed`; the walk is generation-
        ordered, so an index removed then re-added across the window
        nets out to its newest state.

        (None, False) while up to date OR while the barrier is still open
        (the executor keeps waiting — the diff arrives on a later
        heartbeat); (None, True) when the diff window no longer covers
        from_generation (or it never held a rendered spec) and the
        executor must fall back to a full fetch."""
        with self._lock:
            current = self.spec_generation
            if from_generation >= current:
                return None, False
            if from_generation < 1:
                return None, True
            if not self.all_tasks_registered():
                # barrier open: the replacement hasn't registered yet, so
                # there is no complete spec to diff against — not a
                # refetch verdict, just "not yet"
                return None, False
            cached = self._diff_cache.get(from_generation)
            if cached is not None:
                diff, nbytes = cached
            else:
                changed_ids: set[str] = set()
                removed: dict[str, set[int]] = {}
                for gen in range(from_generation + 1, current + 1):
                    entry = self._gen_changes.get(gen)
                    if entry is None:
                        # bump fell out of the retained window
                        return None, True
                    # generation order matters: a later removal voids an
                    # earlier change of the same index, a later re-add
                    # voids an earlier removal
                    for job, idxs in entry.get("removed", {}).items():
                        bucket = removed.setdefault(job, set())
                        for i in idxs:
                            bucket.add(i)
                            changed_ids.discard(f"{job}:{i}")
                    for tid in entry.get("changed", ()):
                        changed_ids.add(tid)
                        name, _, idx_s = tid.rpartition(":")
                        bucket = removed.get(name)
                        if bucket:
                            try:
                                bucket.discard(int(idx_s))
                            except ValueError:
                                pass
                # a rebind since the last bump (no generation of its own):
                # a trailing survivor's full fetch would have picked it up
                # from the re-rendered spec, so the diff must carry it too
                changed_ids |= self._pending_rebinds
                changed: dict[str, dict[str, str]] = {}
                for tid in sorted(changed_ids):
                    task = self.get_task_by_id(tid)
                    if task is None or tid not in self._registered:
                        return None, True
                    changed.setdefault(task.job_name, {})[
                        str(task.index)] = task.host_port
                diff = {"generation": current, "changed": changed}
                removed_out = {job: sorted(idxs)
                               for job, idxs in sorted(removed.items())
                               if idxs}
                if removed_out:
                    diff["removed"] = removed_out
                # serialize ONCE for byte accounting — at width 1k the
                # same cached diff is served to ~width survivors and a
                # per-serve json.dumps would sit on the heartbeat hot path
                nbytes = len(json.dumps(diff))
                self._diff_cache[from_generation] = (diff, nbytes)
            self.spec_stats["diff_serves"] += 1
            self.spec_stats["diff_bytes"] += nbytes
            return diff, False

    def heartbeat_spec_fields(self, exec_generation: int) -> dict:
        """The spec-related fields a heartbeat RESPONSE carries for an
        executor reporting the generation of the spec it holds — the ONE
        implementation of the piggyback protocol, shared by the AM's
        handler and the bench's control-plane harness so the bench always
        measures the protocol production runs:

        - spec_ready: barrier state (lets the register poll back off hard
          and still fetch within ~one heartbeat of the gang completing);
        - spec_diff: generation-keyed diff when the executor trails the
          current generation and the window covers it;
        - spec_refetch: the executor's generation fell outside the diff
          window — it must fall back to a full fetch."""
        # under the session lock (RLock): the generation read and the
        # diff render must see one consistent state — an unlocked read
        # here raced relaunch_task's bump+invalidate (caught by tonylint's
        # guarded-by pass)
        with self._lock:
            fields = {"spec_ready": self.all_tasks_registered()}
            if 0 < exec_generation < self.spec_generation:
                diff, refetch = self.spec_diff_since(exec_generation)
                if diff is not None:
                    fields["spec_diff"] = diff
                elif refetch:
                    fields["spec_refetch"] = True
            return fields

    def note_full_serve(self, spec: str) -> None:
        """Account a full O(width) spec payload handed to a caller outside
        register_worker_spec (e.g. get_cluster_spec) — under the session
        lock so concurrent gRPC handler threads never lose an increment
        (the bench's spec_bytes and the chaos e2e's exact full_serves
        count read these)."""
        with self._lock:
            self.spec_stats["full_serves"] += 1
            self.spec_stats["full_bytes"] += len(spec)

    # ------------------------------------------------------------------
    # policy predicates
    # ------------------------------------------------------------------
    def is_chief(self, job_name: str, index: int) -> bool:
        """chief:* is chief; else worker:0 when no chief jobtype exists
        (TonySession.java:364-367)."""
        if job_name == C.CHIEF_JOB_NAME:
            return True
        return (C.CHIEF_JOB_NAME not in self.job_tasks
                and job_name == C.WORKER_JOB_NAME and index == 0)

    def is_tracked(self, job_name: str) -> bool:
        return job_name not in self._untracked

    def max_task_attempts(self, job_name: str) -> int:
        """Total attempts (first run + relaunches) a slot of this jobtype
        gets: tony.<job>.max-task-attempts, else tony.task.max-task-attempts
        (default 1 = the all-or-nothing reference behavior)."""
        per_job = self.conf.get_int(K.max_task_attempts_key(job_name), 0)
        if per_job >= 1:
            return per_job
        return max(1, self.conf.get_int(K.TASK_MAX_TASK_ATTEMPTS, 1))

    def total_tracked_tasks(self) -> int:
        return sum(len(t) for j, t in self.job_tasks.items() if self.is_tracked(j))

    def num_completed_tracked_tasks(self) -> int:
        return sum(1 for j, tasks in self.job_tasks.items() if self.is_tracked(j)
                   for t in tasks if t.completed)

    def num_completed_barrier_tasks(self) -> int:
        """Completed tracked tasks that are part of the gang RENDEZVOUS
        — the relaunch barrier's input. Serving replicas are excluded:
        they serve independently, never re-enter the barrier, and a
        scaled-down replica's clean exit is routine fleet lifecycle
        that must not disable crash relaunches for the rest of the
        application."""
        return sum(1 for j, tasks in self.job_tasks.items()
                   if self.is_tracked(j) and j != C.SERVING_JOB_NAME
                   for t in tasks if t.completed)

    def all_tracked_tasks_completed(self) -> bool:
        return self.num_completed_tracked_tasks() >= self.total_tracked_tasks()

    # ------------------------------------------------------------------
    # completion + final status
    # ------------------------------------------------------------------
    def on_task_completed(self, job_name: str, index: int, exit_code: int,
                          preempted: bool = False) -> None:
        """Record an exit code; short-circuit the session on chief failure,
        stop-on-failure jobtypes, or fail-on-worker-failure
        (TonySession.onTaskCompleted, TonySession.java:251-271). A
        `preempted` exit (graceful drain) is terminal-but-not-a-failure:
        it never short-circuits and never counts in the aggregation."""
        task = self.get_task(job_name, index)
        if task is None:
            LOG.error("completion for unknown task %s:%s", job_name, index)
            return
        LOG.info("task %s exited with %d%s", task.task_id, exit_code,
                 " (preempted)" if preempted else "")
        task.set_exit_status(exit_code, preempted=preempted)
        if not preempted and exit_code not in (0, EXIT_KILLED_BY_AM):
            if (self.is_chief(job_name, index)
                    or job_name in self._stop_on_failure
                    or self._fail_on_worker_failure):
                self.training_finished = True
                self.set_final_status(FinalStatus.FAILED,
                                      f"Exit status: {exit_code}")

    def update_session_status(self) -> None:
        """Aggregate the final status over tracked tasks
        (TonySession.updateSessionStatus, TonySession.java:276-330).
        PREEMPTED is sticky like FAILED: the drain path set it with full
        knowledge of the task states, and a preempted task's non-zero
        exit must never be re-read as a worker failure."""
        if self.final_status in (FinalStatus.FAILED, FinalStatus.PREEMPTED):
            return
        failure_count = 0
        for job, tasks in self.job_tasks.items():
            if not self.is_tracked(job):
                continue
            for task in tasks:
                if not task.completed:
                    self.set_final_status(
                        FinalStatus.FAILED,
                        f"Task {task.task_id} hasn't finished yet.")
                    return
                if task.status == TaskStatus.PREEMPTED:
                    continue
                if task.exit_status != 0:
                    failure_count += 1
        if failure_count > 0:
            if (self._fail_on_worker_failure
                    or failure_count >= self.total_tracked_tasks()):
                self.set_final_status(
                    FinalStatus.FAILED,
                    f"At least one task exited non-zero, failedCnt={failure_count}")
            else:
                # "succeeded with some worker failures"
                self.set_final_status(
                    FinalStatus.SUCCEEDED,
                    f"Completed with some failed tasks, failedCnt={failure_count}")
        else:
            self.set_final_status(FinalStatus.SUCCEEDED, None)

    def set_final_status(self, status: FinalStatus, message: Optional[str]) -> None:
        self.final_status = status
        self.final_message = message

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def get_task_infos(self) -> list[TaskInfo]:
        return [t.to_task_info() for tasks in self.job_tasks.values()
                for t in tasks]

    def num_failed_tasks(self) -> int:
        return sum(1 for tasks in self.job_tasks.values()
                   for t in tasks if t.status == TaskStatus.FAILED)

    def running_tasks(self) -> list[Task]:
        return [t for tasks in self.job_tasks.values() for t in tasks
                if t.container_id and not t.completed]
