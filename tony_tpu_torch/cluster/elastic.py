"""Elastic gang resize: grow/shrink a RUNNING trainer in place, no evict.

The port's copy of `tony_tpu/cluster/elastic.py`. Every AM builds one;
`tony.elastic.enabled` gates each trigger inside it.

The TF-Replicator elasticity story (arxiv 1902.00465) rebuilt on TonY's
gang machinery (arxiv 1904.01631): a checkpoint taken at one mesh
shape reshards on resume, and the generation-bumped spec diffs
already propagate membership changes over heartbeats — until now that
power was only reachable through a full checkpoint-then-EVICT round trip
(resubmit, re-allocate, re-localize). This module makes width change a
first-class lifecycle on the machinery that already exists:

    quiesce → in-place emergency checkpoint → membership change →
    generation bump → survivors re-rendezvous via spec diffs →
    reshard-restore → resume

- **Quiesce** reuses the TERM→checkpoint drain contract but
  WITHOUT process teardown for survivors: the resize ask rides every
  member's heartbeat, executors TERM only their user processes
  (trainers commit one synchronous emergency checkpoint inside the
  grace window), arm the barrier re-entry, and gossip a quiesce ack
  back on the next ping. The membership change is GATED on every ack —
  a new-width trainer can never restore before the checkpoint
  committed.
- **Grow** appends task slots (`session.add_task_instance` +
  `scheduler.schedule_scale_up`); **shrink** drains the highest-index
  tasks (they report a `resized` terminal result — never a fault, no
  relaunch budget) and pops their trailing slots. Either way ONE
  generation bump records the membership delta as diff material, so
  survivors re-join by PATCHING their held spec — zero full
  re-fetches on the happy path.
- **Rollback**: a grow whose new containers never register inside the
  allocation window abandons back to the old width without failing the
  application, mirroring the autoscaler's abandoned scale-up.
  A quiesce that never completes aborts the same way — a resize is
  never allowed to fail the app.
- **Downtime** (request → barrier re-closed) is priced into the
  goodput ledger as the `resize` phase (observability/perf.py).

Triggers: the arbiter's idle-chip offer loop (`offer_idle_chips` in
cluster/arbiter.py, fed by the annotated `fleet.chips_idle_while_queued`
alert), the arbiter's reclaim-instead-of-evict verdict
(`Arbiter.decide` → RECLAIM → `execute_reclaims`), and the operator
(`cli resize` → the attempt-fenced `request_resize` cluster RPC).

Width semantics: `width` is the elastic jobtype's task-instance count
(the gang width every fleet surface reports). For fixed-membership
gangs whose chips live inside one task (a single-process multi-chip
trainer), `tpus_per_task` re-meshes the slice instead — same state
machine, no membership change. Both flows re-render the implied
TPU_MESH_SHAPE (`scale_mesh_shape`) and deliver it to survivors on the
resize ask and to new containers via TONY_ELASTIC_MESH_SHAPE.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from tony_tpu_torch import constants as C
from tony_tpu_torch.conf import keys as K

LOG = logging.getLogger(__name__)

# state machine states (docs/ELASTICITY.md)
IDLE = "idle"
QUIESCING = "quiescing"      # asks riding heartbeats; waiting for acks
RESHAPING = "reshaping"      # membership changed; waiting for the barrier
REVERTING = "reverting"      # corrective ask after an abort/rollback


def scale_mesh_shape(shape_s: str, axes_s: str, old_chips: int,
                     new_chips: int) -> str:
    """Scale a frozen TPU_MESH_SHAPE to a resized chip count by scaling
    ONE data axis (dp, else fsdp, else the largest axis): the model-
    parallel axes (tp/sp/pp/ep) describe intra-model layout the resize
    must not distort, while the data axes are exactly the dimension
    elasticity adds/removes replicas-or-shards along. Raises ValueError
    when the scale doesn't land on integers — caught at request time so
    an impossible resize is refused before anything quiesces."""
    dims = [int(x) for x in shape_s.split(",") if x.strip()]
    axes = [a.strip() for a in axes_s.split(",") if a.strip()]
    if not dims:
        return ""
    if len(axes) != len(dims):
        axes = [""] * len(dims)
    if old_chips <= 0 or new_chips <= 0:
        raise ValueError("chip counts must be positive")
    target = None
    for name in ("dp", "fsdp"):
        if name in axes:
            target = axes.index(name)
            break
    if target is None:
        target = max(range(len(dims)), key=lambda i: dims[i])
    scaled = dims[target] * new_chips
    if scaled % old_chips != 0:
        raise ValueError(
            f"mesh axis {axes[target] or target} = {dims[target]} does "
            f"not scale by {new_chips}/{old_chips}")
    dims[target] = scaled // old_chips
    return ",".join(str(d) for d in dims)


def reclaim_rpc_args(summary: dict, chips_to_free: int) -> Optional[dict]:
    """Translate an arbiter reclaim verdict ("free `chips_to_free` chips
    from this elastic job") into request_resize kwargs against the
    victim's AM: multi-task gangs shrink task instances; a single-task
    gang re-meshes its per-task chips. None when the summary can't size
    a shrink (not elastic, no chip accounting)."""
    from tony_tpu_torch.observability.fleet import chips_of
    job = str(summary.get("elastic_job", "") or "")
    # the ELASTIC jobtype's own shape when the summary carries it
    # (mixed-jobtype apps: gang_width/chips span serving replicas too);
    # blended fallback for summaries that predate the scoped fields
    width = int(summary.get("elastic_width", 0) or 0) \
        or int(summary.get("gang_width", 0) or 0)
    chips = chips_of(summary)
    if not job or width <= 0 or chips <= 0 or chips_to_free <= 0:
        return None
    cpt = int(summary.get("elastic_chips_per_task", 0) or 0) \
        or max(1, chips // width)
    if width > 1:
        new_width = max(1, width - (chips_to_free + cpt - 1) // cpt)
        if new_width >= width:
            return None
        return {"job_name": job, "width": new_width}
    new_chips = width * cpt - chips_to_free
    if new_chips < 1 or new_chips >= width * cpt:
        return None
    return {"job_name": job, "tpus_per_task": new_chips}


def find_widenable(summaries: list[dict]) -> list[dict]:
    """RUNNING elastic jobs that could absorb idle chips (width below
    their declared max, or unbounded) — the candidates the annotated
    `fleet.chips_idle_while_queued` alert names for the offer loop."""
    out = []
    for s in summaries:
        if s.get("state") != "RUNNING":
            continue
        if not s.get("elastic_job"):
            continue
        # the elastic jobtype's OWN width (gang_width spans every
        # jobtype and would wrongly hit max-width on mixed apps)
        width = int(s.get("elastic_width", 0) or 0) \
            or int(s.get("gang_width", 0) or 0)
        max_width = int(s.get("elastic_max_width", 0) or 0)
        if width <= 0:
            continue
        if max_width and width >= max_width:
            continue
        out.append(s)
    return out


class ElasticCoordinator:
    """The AM-side resize state machine, advanced on the monitor cadence
    (`check()` — its only periodic call site) with the quiesce asks and
    acks riding the existing heartbeat channel. Holds a narrow view of
    the ApplicationMaster (session, scheduler, backend, hb_monitor,
    event_handler, conf) so a stub AM drives it in unit tests.

    Locking: `_lock` is strictly INNER — the coordinator never calls
    back into the AM while holding it; state is snapshotted under the
    lock and acted on outside. `heartbeat_fields` pre-checks the
    in-flight record lock-free (W pings per interval must not serialize
    on a resize that almost never exists)."""

    def __init__(self, am):
        self.am = am
        conf = am.conf
        self.enabled = conf.get_bool(K.ELASTIC_ENABLED, False)
        self.min_width = max(1, conf.get_int(K.ELASTIC_MIN_WIDTH, 1))
        self.max_width = max(0, conf.get_int(K.ELASTIC_MAX_WIDTH, 0))
        self.cooldown_ms = conf.get_time_ms(K.ELASTIC_COOLDOWN_MS, 60_000)
        self.quiesce_grace_ms = conf.get_time_ms(
            K.ELASTIC_QUIESCE_GRACE_MS, 30_000)
        self._resize: Optional[dict] = None  # guarded-by: _lock
        self._seq = 0                        # guarded-by: _lock
        self.resizes_total = 0
        self._downtime_s = 0.0               # guarded-by: _lock
        self._last_done = 0.0                # monotonic; cooldown clock
        # container ids whose exit is an elastic release, not a task
        # completion — the AM's completion callback swallows them
        self._released_cids: set[str] = set()  # guarded-by: _lock
        self._lock = threading.Lock()

    # -- cheap read surface (AM hot paths) -----------------------------
    @property
    def active(self) -> bool:
        # tony: disable=guarded-by -- lock-free heartbeat fast path
        return self._resize is not None

    def is_released_container(self, container_id: str) -> bool:
        with self._lock:
            return container_id in self._released_cids

    def downtime_s(self) -> float:
        """Accumulated resize downtime plus the in-flight resize's
        elapsed-so-far — the goodput ledger's `resize` phase input."""
        with self._lock:
            total = self._downtime_s
            if self._resize is not None:
                total += time.monotonic() - self._resize["t0"]
        return total

    def width_fields(self, current_width: int) -> dict:
        """The jobstate width surface: requested width tracks the
        in-flight resize target so `cli top` / the portal show a resize
        fleet-wide while it runs."""
        with self._lock:
            r = self._resize
            requested = current_width
            # the delta only applies while QUIESCING: the task table
            # still shows from_width. During RESHAPING the membership
            # already changed, so current width IS the requested width
            # (adding the delta again would render "4>0" on a shrink)
            if r is not None and r["state"] == QUIESCING:
                requested = current_width \
                    + (r["to_width"] - r["from_width"])
        return {"requested_width": requested,
                "elastic_min_width": self.min_width if self.enabled else 0,
                "elastic_max_width": self.max_width if self.enabled else 0}

    def mesh_override(self) -> str:
        """The mesh shape the CURRENT width implies ("" = the frozen
        conf's) — rendered into every container launched mid- or
        post-resize via TONY_ELASTIC_MESH_SHAPE."""
        with self._lock:
            r = self._resize
            if r is not None and r["state"] in (QUIESCING, RESHAPING):
                return r["mesh_shape"]
            return self._settled_mesh()

    # holds: _lock
    def _settled_mesh(self) -> str:
        return getattr(self, "_settled_mesh_shape", "")

    # -- trigger: the attempt-fenced request_resize RPC ----------------
    def request_resize(self, req: dict) -> dict:
        """Validate and arm one resize. The AM's handler already fenced
        the session attempt; everything else (elastic enabled, width
        bounds, mesh scalability, steady gang, no competing lifecycle)
        is judged here so an impossible ask is refused before anything
        quiesces. Idempotent while in flight."""
        am = self.am
        session = am.session
        if not self.enabled:
            return {"error": "elasticity disabled (tony.elastic.enabled)"}
        if session is None:
            return {"error": "no active session"}
        requested_by = str(req.get("requested_by", "") or "operator")
        if getattr(am, "_preemption", None) is not None:
            return {"error": "preemption drain in flight"}
        # in-flight check FIRST: while a resize runs, every ask answers
        # `duplicate` — validating against the half-reshaped widths
        # would produce misleading refusals ("already at width N" the
        # moment the membership books changed). The check under the
        # lock below stays authoritative against a concurrent ask.
        with self._lock:
            if self._resize is not None:
                r = self._resize
                return {"app_id": am.app_id, "duplicate": True,
                        "job_name": r["job"],
                        "from_width": r["from_width"],
                        "to_width": r["to_width"], "state": r["state"]}
        job = str(req.get("job_name", "") or "") or self._default_job()
        if job is None:
            return {"error": "no tracked training jobtype to resize"}
        tasks = session.job_tasks.get(job)
        if tasks is None or not session.is_tracked(job) \
                or job == C.SERVING_JOB_NAME:
            return {"error": f"jobtype {job!r} is not an elastic "
                             f"training jobtype (serving scales via the "
                             f"autoscaler)"}
        if not session.all_tasks_registered():
            return {"error": "gang is not steady (barrier open) — "
                             "retry once every task has registered"}
        from_width = len(tasks)
        from_tpus = session.requests[job].tpus
        to_width = int(req.get("width", 0) or 0)
        to_tpus = int(req.get("tpus_per_task", 0) or 0)
        if to_width and to_tpus:
            return {"error": "pass width OR tpus_per_task, not both"}
        if not to_width and not to_tpus:
            return {"error": "pass a target width (task instances) or "
                             "tpus_per_task"}
        if to_width:
            if to_width == from_width:
                return {"error": f"already at width {from_width}"}
            if to_width < self.min_width:
                return {"error": f"width {to_width} below "
                                 f"tony.elastic.min-width "
                                 f"{self.min_width}"}
            if self.max_width and to_width > self.max_width:
                return {"error": f"width {to_width} above "
                                 f"tony.elastic.max-width "
                                 f"{self.max_width}"}
            to_tpus = from_tpus
        else:
            if to_tpus == from_tpus:
                return {"error": f"already at {from_tpus} tpus per task"}
            if to_tpus < 1:
                return {"error": "tpus_per_task must be >= 1"}
            to_width = from_width
        old_chips = max(1, from_width * max(1, from_tpus))
        new_chips = max(1, to_width * max(1, to_tpus))
        mesh_shape = ""
        conf_mesh = am.conf.get_str(K.TPU_MESH_SHAPE, "")
        base_mesh = self._settled_mesh() or conf_mesh
        if base_mesh:
            try:
                mesh_shape = scale_mesh_shape(
                    base_mesh, am.conf.get_str(K.TPU_MESH_AXES, ""),
                    old_chips, new_chips)
            except ValueError as e:
                return {"error": f"mesh cannot scale: {e}"}
        grace_ms = int(req.get("grace_ms", 0) or 0) or self.quiesce_grace_ms
        reason = str(req.get("reason", "") or "")
        now = time.monotonic()
        with self._lock:
            if self._resize is not None:
                r = self._resize
                return {"app_id": am.app_id, "duplicate": True,
                        "job_name": r["job"],
                        "from_width": r["from_width"],
                        "to_width": r["to_width"], "state": r["state"]}
            # cooldown applies to automatic triggers only: a human
            # override must never be refused because an automatic
            # resize just happened
            if (requested_by in ("arbiter", "autoscaler")
                    and self._last_done > 0
                    and now - self._last_done < self.cooldown_ms / 1000.0):
                return {"error": f"resize cooldown "
                                 f"({self.cooldown_ms} ms) active"}
            self._seq += 1
            members = {t.task_id: t.attempt
                       for j, ts in session.job_tasks.items()
                       if session.is_tracked(j) and j != C.SERVING_JOB_NAME
                       for t in ts if not t.completed}
            # release asks target LIVE victims only: a trailing slot
            # that already completed sends no heartbeats and could
            # never report a release — it simply pops at reshape
            victims = ({t.task_id for t in tasks[to_width:]
                        if not t.completed}
                       if to_width < from_width else set())
            self._resize = {
                "id": self._seq, "state": QUIESCING, "job": job,
                "from_width": from_width, "to_width": to_width,
                "from_tpus": from_tpus, "to_tpus": to_tpus,
                "mesh_shape": mesh_shape,
                "reason": reason, "requested_by": requested_by,
                "grace_ms": grace_ms,
                "deadline": now + grace_ms / 1000.0,
                "members": members, "victims": set(victims),
                "acked": set(), "released": set(),
                "added": [], "t0": now,
            }
        from tony_tpu_torch.events.schema import (
            Event, EventType, ResizeRequested, ResizeStarted,
        )
        LOG.warning("elastic resize requested by %s: %s %d -> %d task(s) "
                    "(%d -> %d chips, %d ms quiesce grace): %s",
                    requested_by, job, from_width, to_width, old_chips,
                    new_chips, grace_ms, reason or "unspecified")
        am.event_handler.emit(Event(
            EventType.RESIZE_REQUESTED,
            ResizeRequested(am.app_id, job, from_width, to_width,
                            from_chips=old_chips, to_chips=new_chips,
                            reason=reason, requested_by=requested_by,
                            grace_ms=grace_ms)))
        am.event_handler.emit(Event(
            EventType.RESIZE_STARTED,
            ResizeStarted(am.app_id, job, from_width, to_width,
                          members=len(members))))
        self._publish()
        self._wake()
        return {"app_id": am.app_id, "job_name": job,
                "from_width": from_width, "to_width": to_width,
                "from_chips": old_chips, "to_chips": new_chips,
                "grace_ms": grace_ms}

    def _default_job(self) -> Optional[str]:
        """The widest tracked non-serving jobtype — the training gang in
        every shipped example (`worker`)."""
        session = self.am.session
        best = None
        for job, tasks in session.job_tasks.items():
            if not session.is_tracked(job) or job == C.SERVING_JOB_NAME:
                continue
            if best is None or len(tasks) > len(session.job_tasks[best]):
                best = job
        return best

    # -- heartbeat piggyback -------------------------------------------
    def heartbeat_fields(self, task_id: str) -> Optional[dict]:
        """The resize ask riding one member's heartbeat response while a
        quiesce (or a corrective revert) is in flight. Resends are
        harmless — the executor's handling is one-shot per resize id."""
        # tony: disable=guarded-by -- lock-free heartbeat fast path
        r = self._resize
        if r is None or r["state"] not in (QUIESCING, REVERTING):
            return None
        with self._lock:
            r = self._resize
            if r is None or r["state"] not in (QUIESCING, REVERTING):
                return None
            if task_id not in r["members"]:
                return None
            return {
                "id": r["id"],
                "width": r["to_width"],
                "grace_ms": max(0, int((r["deadline"] - time.monotonic())
                                       * 1000)),
                "mesh_shape": r["mesh_shape"],
                "release": task_id in r["victims"],
                "reason": r["reason"],
            }

    def note_quiesced(self, task_id: str, resize_id: int) -> None:
        """A member's heartbeat acked resize `resize_id`: its user
        process has exited (emergency checkpoint committed)."""
        with self._lock:
            r = self._resize
            if r is None or r["id"] != int(resize_id):
                return
            if task_id in r["members"]:
                r["acked"].add(task_id)
        self._wake()

    def note_generation(self, task_id: str, generation: int) -> None:
        """A member's heartbeat reported the spec generation it holds —
        the coordinator's evidence that a survivor has actually
        re-rendezvoused at the post-reshape generation (its user
        process relaunches right after the patch), so RESIZE_COMPLETED
        and the resize-downtime clock close on the gang being BACK, not
        merely on the membership books changing."""
        if generation <= 0:
            return
        with self._lock:
            r = self._resize
            if r is None or task_id not in r["members"]:
                return
            gens = r.setdefault("gens", {})
            if generation > int(gens.get(task_id, 0)):
                gens[task_id] = int(generation)

    def note_released(self, task_id: str, container_id: str) -> bool:
        """A shrink victim reported its `resized` terminal result: the
        slot is leaving the gang. Returns False when no resize names
        this task a victim (e.g. the release raced an abort) — the
        caller then treats the exit through the normal ladder."""
        with self._lock:
            r = self._resize
            if r is None or task_id not in r["victims"]:
                return False
            r["released"].add(task_id)
            r["acked"].add(task_id)
            if container_id:
                self._released_cids.add(container_id)
        self._wake()
        return True

    # -- the monitor-cadence pass --------------------------------------
    def check(self) -> None:
        """One state-machine pass (the AM monitor loop's only elastic
        call site). Never raises — a resize must never kill the AM."""
        try:
            self._check_inner()
        except Exception:  # noqa: BLE001 — resizing must never kill the AM
            LOG.exception("elastic resize check failed")

    def _check_inner(self) -> None:
        with self._lock:
            r = self._resize
        if r is None:
            return
        session = self.am.session
        if session is None:
            self.reset()
            return
        if getattr(self.am, "_preemption", None) is not None \
                and r["state"] in (QUIESCING, RESHAPING):
            # a checkpoint-then-evict drain arrived mid-resize: the
            # whole gang is leaving — the eviction owns the lifecycle
            # from here, the resize steps aside without failing anything
            self._fail(r, "superseded by a preemption drain",
                       rolled_back=False)
            return
        now = time.monotonic()
        if r["state"] == QUIESCING:
            pending = (set(r["members"]) - r["acked"]) \
                | (r["victims"] - r["released"])
            if not pending:
                self._reshape(r)
            elif now > r["deadline"]:
                self._abort(r, f"quiesce window expired with "
                               f"{len(pending)} task(s) not quiesced "
                               f"({sorted(pending)[:4]}...)")
        elif r["state"] == RESHAPING:
            if session.all_tasks_registered() \
                    and self._survivors_settled(r, now):
                self._complete(r)
            elif (r["added"]
                  and any(not session.is_task_registered(tid)
                          for tid in r["added"])
                  and now > r.get("rollback_deadline", now + 1)):
                # the rollback clock watches the ADDED slots only: an
                # unrelated survivor relaunch also reopens the barrier
                # and must not be read as "the grow failed"
                self._rollback(r)
        elif r["state"] == REVERTING:
            pending = set(r["members"]) - r["acked"]
            if not pending or now > r["deadline"]:
                with self._lock:
                    if self._resize is r:
                        self._resize = None
                LOG.warning("elastic resize %d settled after revert "
                            "(%d member(s) pending at close)", r["id"],
                            len(pending))

    def _survivors_settled(self, r: dict, now: float) -> bool:
        """True once every surviving member has reported (via heartbeat)
        that it holds the post-reshape spec generation — i.e. the gang
        genuinely re-rendezvoused — with a bounded fallback: past the
        settle deadline the resize completes anyway (a survivor whose
        heartbeats died mid-resize is the relaunch machinery's problem,
        not a reason to pin the resize state open forever)."""
        target = int(r.get("target_gen", 0))
        if target <= 0:
            return True
        with self._lock:
            gens = dict(r.get("gens", {}))
            survivors = set(r["members"]) - r["victims"]
        if all(int(gens.get(tid, 0)) >= target for tid in survivors):
            return True
        if now > r.get("settle_deadline", now + 1):
            LOG.warning("resize settle deadline passed with survivor(s) "
                        "still below generation %d — completing anyway",
                        target)
            return True
        return False

    def _reshape(self, r: dict) -> None:
        """Every member quiesced (checkpoint committed): apply the
        membership / chips change and bump the generation so survivors
        re-rendezvous against the new width via spec diffs."""
        am = self.am
        session = am.session
        job = r["job"]
        if r["to_tpus"] != r["from_tpus"]:
            session.requests[job].tpus = r["to_tpus"]
        if r["to_width"] > r["from_width"]:
            added = []
            for _ in range(r["to_width"] - r["from_width"]):
                task = session.add_task_instance(job)
                if task is None:
                    break
                added.append(task.task_id)
                am.scheduler.schedule_scale_up(job)
            r["added"] = added
            alloc_ms = getattr(am, "_alloc_timeout_ms", 0) or 0
            r["rollback_deadline"] = time.monotonic() + (
                alloc_ms / 1000.0 if alloc_ms > 0 else 15 * 60.0)
            r["target_gen"] = session.resize_bump_generation(set(added), {})
            LOG.warning("elastic grow: %s %d -> %d — %d slot(s) added, "
                        "containers requested, rollback arms in %.0f s",
                        job, r["from_width"], r["to_width"], len(added),
                        r["rollback_deadline"] - time.monotonic())
        elif r["to_width"] < r["from_width"]:
            removed = session.remove_task_slots(
                job, r["from_width"] - r["to_width"])
            cids = []
            with self._lock:
                for task in removed:
                    if task.container_id:
                        self._released_cids.add(task.container_id)
                        cids.append(task.container_id)
            for task in removed:
                am.hb_monitor.unregister(task.task_id)
                clear_util = getattr(
                    getattr(am, "metrics_store", None),
                    "clear_utilization_state", None)
                if clear_util is not None:
                    clear_util(task.job_name, task.index)
                clear_profile = getattr(am, "_clear_profile_request", None)
                if clear_profile is not None:
                    clear_profile(task.task_id)
            r["removed_count"] = len(removed)
            r["target_gen"] = session.resize_bump_generation(
                set(), {job: {t.index for t in removed}})
            # container stops OUTSIDE every lock (process teardown blocks)
            for cid in cids:
                am.backend.stop_container(cid)
            LOG.warning("elastic shrink: %s %d -> %d — %d trailing "
                        "slot(s) drained and removed", job,
                        r["from_width"], r["to_width"], len(removed))
        else:
            # pure re-mesh: membership unchanged, the bump alone sends
            # survivors back through the barrier at the new chip count
            r["target_gen"] = session.resize_bump_generation(set(), {})
            LOG.warning("elastic re-mesh: %s stays %d task(s), %d -> %d "
                        "tpus/task (mesh %s)", job, r["from_width"],
                        r["from_tpus"], r["to_tpus"],
                        r["mesh_shape"] or "<from devices>")
        alloc_ms = getattr(am, "_alloc_timeout_ms", 0) or 0
        with self._lock:
            r["state"] = RESHAPING
            # honest completion has a floor: a survivor whose heartbeats
            # die mid-resize must not pin the state machine open forever
            r["settle_deadline"] = time.monotonic() + (
                alloc_ms / 1000.0 if alloc_ms > 0 else 15 * 60.0)
        self._wake()

    def _complete(self, r: dict) -> None:
        am = self.am
        now = time.monotonic()
        duration_ms = int((now - r["t0"]) * 1000)
        with self._lock:
            if self._resize is not r:
                return
            self._resize = None
            self._downtime_s += now - r["t0"]
            self._last_done = now
            self.resizes_total += 1
            # the settled mesh becomes the base a future resize scales
            self._settled_mesh_shape = r["mesh_shape"]
        from tony_tpu_torch.events.schema import Event, EventType, ResizeCompleted
        LOG.warning("elastic resize completed: %s %d -> %d task(s) in "
                    "%d ms", r["job"], r["from_width"], r["to_width"],
                    duration_ms)
        am.event_handler.emit(Event(
            EventType.RESIZE_COMPLETED,
            ResizeCompleted(am.app_id, r["job"], r["from_width"],
                            r["to_width"], duration_ms=duration_ms,
                            added_tasks=len(r["added"]),
                            removed_tasks=int(r.get("removed_count", 0)))))
        self._publish()
        self._wake()

    def _rollback(self, r: dict) -> None:
        """Grow rollback: the new containers never registered inside the
        window — abandon the added slots and settle back at the old
        width. The application keeps running; survivors (quiesced, at
        the barrier) refetch the old-width spec once the expected count
        shrinks back."""
        am = self.am
        session = am.session
        job = r["job"]
        removed = session.remove_task_slots(job, len(r["added"]))
        # every removed index goes into the diff material: an index a
        # survivor never saw removes as a no-op, one that registered
        # mid-rollback is genuinely deleted from its held spec
        removed_idxs = {t.index for t in removed}
        cids = []
        with self._lock:
            for task in removed:
                if task.container_id:
                    self._released_cids.add(task.container_id)
                    cids.append(task.container_id)
        for task in removed:
            am.hb_monitor.unregister(task.task_id)
        if r["to_tpus"] != r["from_tpus"]:
            session.requests[job].tpus = r["from_tpus"]
        # the bump settles the survivors: the reshape bump's changed ids
        # now resolve to missing tasks, so diff-waiting survivors get a
        # refetch verdict (or a removal diff) and converge on the
        # restored old-width spec
        session.resize_bump_generation(set(), {job: removed_idxs})
        for cid in cids:
            am.backend.stop_container(cid)
        self._fail(r, f"grow rolled back: {len(removed)} added "
                      f"container(s) never registered inside the window",
                   rolled_back=True)

    def _abort(self, r: dict, reason: str) -> None:
        """Quiesce never completed: no membership changed — abandon the
        resize. An EMPTY generation bump wakes the already-quiesced
        survivors immediately (their diff wait gets a verdict instead
        of idling out to the full-poll fallback); a corrective ask
        reverts any delivered mesh override."""
        session = self.am.session
        if session is not None:
            session.resize_bump_generation(set(), {})
        self._fail(r, reason, rolled_back=False)

    def _fail(self, r: dict, reason: str, rolled_back: bool) -> None:
        am = self.am
        now = time.monotonic()
        duration_ms = int((now - r["t0"]) * 1000)
        from tony_tpu_torch.events.schema import Event, EventType, ResizeFailed
        LOG.error("elastic resize FAILED (%s %d -> %d): %s", r["job"],
                  r["from_width"], r["to_width"], reason)
        am.event_handler.emit(Event(
            EventType.RESIZE_FAILED,
            ResizeFailed(am.app_id, r["job"], r["from_width"],
                         r["to_width"], reason=reason,
                         rolled_back=rolled_back,
                         duration_ms=duration_ms)))
        with self._lock:
            if self._resize is not r:
                return
            self._downtime_s += now - r["t0"]
            self._last_done = now
            # snapshot BEFORE the revert-phase update below clears it
            already_released = sorted(r.get("released", ()))
            old_mesh = self._settled_mesh()
            if r["mesh_shape"] and r["mesh_shape"] != old_mesh:
                # survivors may hold the new mesh override — serve a
                # corrective ask (fresh id) until each acks the revert,
                # bounded by one more grace window
                self._seq += 1
                r.update({
                    "id": self._seq, "state": REVERTING,
                    "to_width": r["from_width"],
                    "to_tpus": r["from_tpus"],
                    "mesh_shape": old_mesh,
                    "reason": f"revert: {reason}",
                    "victims": set(), "acked": set(), "released": set(),
                    "deadline": now + r["grace_ms"] / 1000.0,
                    # the failed span was folded into _downtime_s just
                    # above — the in-flight clock restarts for the
                    # revert window, or downtime_s() would double-count
                    "t0": now,
                })
            else:
                self._resize = None
        # victims that already released BEFORE the failure: their user
        # processes reported `resized` and stopped, but their slots
        # never left the table (only _reshape removes slots) — left
        # alone they would be silent holes in the resumed gang. Heal
        # them through the budget-exempt lifecycle relaunch, exactly
        # like a release racing the abort.
        relaunch = getattr(am, "_maybe_relaunch_task", None)
        session = am.session
        if relaunch is not None and session is not None:
            for task_id in already_released:
                task = session.get_task_by_id(task_id)
                if task is not None and not task.completed:
                    relaunch(task, f"elastic shrink victim released "
                                   f"before the resize failed ({reason})",
                             count_failure=False, force=True)
        self._publish()
        self._wake()

    # -- session lifecycle ---------------------------------------------
    def reset(self) -> None:
        """A session retry tore the gang down: whatever resize was in
        flight is moot (the new session rebuilds at the conf width)."""
        with self._lock:
            if self._resize is not None:
                self._downtime_s += time.monotonic() - self._resize["t0"]
            self._resize = None
            self._released_cids.clear()
            self._settled_mesh_shape = ""

    def _publish(self) -> None:
        publish = getattr(self.am, "_publish_fleet_state", None)
        if publish is not None:
            try:
                publish(force=True)
            except Exception:  # noqa: BLE001 — fleet must not block a resize
                LOG.debug("fleet publish after resize transition failed",
                          exc_info=True)

    def _wake(self) -> None:
        wake = getattr(self.am, "_wake", None)
        if wake is not None:
            wake.set()
