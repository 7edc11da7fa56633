"""Gang-aware admission arbiter: queues, quotas, priorities, preemption.

The port's copy of `tony_tpu/cluster/arbiter.py`. The TonY paper's
YARN-queue story (arxiv 1904.01631) without YARN: the reference
submitted into a YARN queue and inherited the capacity scheduler's
cross-application arbitration for free; this build has no RM
process, so the arbitration layer lives here — a deterministic decision
engine over a modeled chip inventory plus the fleet registry's live view
(observability/fleet.py jobstate summaries carry queue, user, priority,
chips, and the AM's control-plane address).

Core invariants:

- **All-or-nothing gang admission.** A gang ask is granted whole or not
  at all — chips are never incrementally held while waiting for the
  rest, so a 48-wide ask can never deadlock against two 32-wide ones:
  whichever fits whole runs; the other queues at zero held chips.
- **Hierarchical queues with capacity shares.** `tony.queues.<q>.*`
  declares the tree (conf/queues.py QueueSpec): `capacity-share` is a
  percentage of the parent's capacity (root: of the inventory) a queue
  may hold across RUNNING jobs; `max-tpus-per-user` caps one user
  inside the queue; usage charges every ancestor.
- **Priority + minimal preemption.** When a higher-priority gang does
  not fit whole, victims are selected lowest-priority-first, youngest
  first within a priority (the cheapest work to replay), accumulating
  until the ask fits — then a reverse pass drops any victim whose
  eviction turns out unnecessary, so the set is minimal under the
  policy order. Victims are checkpoint-then-evicted via their AM's
  request_preemption RPC (graceful drain → emergency checkpoint →
  PREEMPTED jobstate), never killed.

The engine is pure (decide() has no side effects); `Arbiter.admit()`
applies a grant to the book, `sync_from_fleet()` rebuilds the book from
live registry summaries, and `execute_preemption()` is the one
side-effecting edge — it delivers request_preemption to each victim AM.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.queues import QueueSpec, queue_ancestry, queue_specs

LOG = logging.getLogger(__name__)

ADMIT = "admit"
QUEUE = "queue"
PREEMPT = "preempt"
# elastic reclaim (cluster/elastic.py): the ask fits after SHRINKING one
# or more running elastic jobs toward their tony.elastic.min-width —
# chips flow without any job losing its containers, so a reclaim is
# strictly preferred over checkpoint-then-evicting anything whole
RECLAIM = "reclaim"


@dataclass
class GangAsk:
    """One application's atomic chip ask (or granted allocation)."""
    app_id: str
    chips: int
    queue: str = "default"
    user: str = ""
    priority: int = 0
    started_ms: int = 0
    am_addr: str = ""           # victim control plane (fleet registry)
    # elastic surface (cluster/elastic.py): the resizable jobtype, ITS
    # OWN shape (gang_width spans every tracked jobtype — a serving
    # replica's chips must never blend into a worker slice's size), and
    # the reclaim floor in chips ("" / 0 = not elastic — never
    # reclaimed, only evicted whole)
    elastic_job: str = ""
    elastic_min_chips: int = 0
    gang_width: int = 0
    elastic_width: int = 0
    elastic_cpt: int = 0        # chips per task of the elastic jobtype

    @classmethod
    def from_summary(cls, summary: dict) -> "GangAsk":
        """A fleet-registry jobstate entry as a running allocation."""
        from tony_tpu_torch.observability.fleet import chips_of
        return cls(
            app_id=str(summary.get("app_id", "") or ""),
            chips=chips_of(summary),
            queue=str(summary.get("queue", "default") or "default"),
            user=str(summary.get("user", "") or ""),
            priority=int(summary.get("priority", 0) or 0),
            started_ms=int(summary.get("started_ms", 0) or 0),
            am_addr=str(summary.get("am_addr", "") or ""),
            elastic_job=str(summary.get("elastic_job", "") or ""),
            elastic_min_chips=int(summary.get("elastic_min_chips", 0)
                                  or 0),
            gang_width=int(summary.get("gang_width", 0) or 0),
            elastic_width=int(summary.get("elastic_width", 0) or 0),
            elastic_cpt=int(summary.get("elastic_chips_per_task", 0)
                            or 0))

    @property
    def chips_per_task(self) -> int:
        """Reclaim granularity: an elastic shrink returns whole task
        slices of the ELASTIC jobtype, never fractions of one. The
        blended chips//gang_width ratio is only the fallback for
        summaries that predate the scoped fields."""
        if self.elastic_cpt > 0:
            return self.elastic_cpt
        return max(1, self.chips // max(1, self.gang_width))

    @property
    def reclaimable_chips(self) -> int:
        """Chips an elastic shrink could free without dropping this job
        below its declared floor (whole chips_per_task slices only) —
        bounded by the elastic jobtype's OWN chips, not the app total."""
        if not self.elastic_job or self.elastic_min_chips <= 0:
            return 0
        elastic_chips = (self.elastic_width * self.elastic_cpt
                         if self.elastic_width > 0 and self.elastic_cpt > 0
                         else self.chips)
        room = max(0, min(self.chips, elastic_chips)
                   - self.elastic_min_chips)
        return room - room % self.chips_per_task


@dataclass
class Decision:
    """decide()'s verdict: ADMIT (fits now), RECLAIM (fits after
    shrinking the elastic jobs in `reclaims` toward their floors — no
    job loses its containers), PREEMPT (fits after evicting `victims`,
    already policy-minimal), or QUEUE (cannot fit whole even with every
    eligible victim gone — the ask waits; nothing is partially
    granted). Reclaim is judged FIRST: taking a slice from an elastic
    job is always preferred over fully evicting anything."""
    action: str
    reason: str = ""
    victims: list = field(default_factory=list)   # [GangAsk]
    reclaims: list = field(default_factory=list)  # [(GangAsk, chips)]

    @property
    def admitted(self) -> bool:
        return self.action == ADMIT


class Arbiter:
    """Deterministic admission book over a modeled inventory.

    total_chips <= 0 models an unbounded pool (admission is then
    constrained only by queue capacities/quotas — useful when the real
    bound is enforced elsewhere)."""

    def __init__(self, total_chips: int = 0,
                 queues: Optional[dict[str, QueueSpec]] = None,
                 preemption_enabled: bool = True):
        self.total_chips = int(total_chips)
        self.queues = dict(queues or {})
        self.preemption_enabled = preemption_enabled
        self.running: dict[str, GangAsk] = {}

    @classmethod
    def from_conf(cls, conf) -> "Arbiter":
        """tony.arbiter.* + the tony.queues.* tree. With no explicit
        inventory, the summed ROOT-queue max-tpus quotas stand in (the
        closest declared statement of pool size)."""
        queues = queue_specs(conf)
        total = conf.get_int(K.ARBITER_TOTAL_TPUS, 0)
        if total <= 0:
            total = sum(q.max_tpus for q in queues.values()
                        if q.parent is None and q.max_tpus > 0)
        return cls(total_chips=total, queues=queues,
                   preemption_enabled=conf.get_bool(
                       K.ARBITER_PREEMPTION_ENABLED, True))

    # -- book ----------------------------------------------------------
    def sync_from_fleet(self, summaries: list[dict]) -> None:
        """Rebuild the running book from live fleet-registry entries
        (state RUNNING; terminal/LOST jobs hold no chips)."""
        from tony_tpu_torch.observability.fleet import LIVE_STATES
        self.running = {}
        for s in summaries:
            if s.get("state") not in LIVE_STATES:
                continue
            ask = GangAsk.from_summary(s)
            if ask.app_id and ask.chips > 0:
                self.running[ask.app_id] = ask

    def release(self, app_id: str) -> None:
        self.running.pop(app_id, None)

    # `reduced` maps app_id -> chips an elastic reclaim would take away;
    # the job keeps running at (chips - reduction) everywhere usage is
    # charged — the arbiter's model of a shrink-in-place
    def _chips_held(self, a: GangAsk, reduced: dict) -> int:
        return max(0, a.chips - int(reduced.get(a.app_id, 0)))

    def used_chips(self, exclude: frozenset = frozenset(),
                   reduced: Optional[dict] = None) -> int:
        reduced = reduced or {}
        return sum(self._chips_held(a, reduced)
                   for a in self.running.values()
                   if a.app_id not in exclude)

    def free_chips(self, exclude: frozenset = frozenset(),
                   reduced: Optional[dict] = None) -> int:
        if self.total_chips <= 0:
            return 1 << 30
        return self.total_chips - self.used_chips(exclude, reduced)

    # -- constraints ---------------------------------------------------
    def _queue_usage(self, queue: str, exclude: frozenset,
                     reduced: Optional[dict] = None) -> int:
        """Chips running in `queue` or any of its descendants (usage
        charges every ancestor, so a parent's view sums its subtree)."""
        reduced = reduced or {}
        total = 0
        for a in self.running.values():
            if a.app_id in exclude:
                continue
            if queue in queue_ancestry(a.queue, self.queues):
                total += self._chips_held(a, reduced)
        return total

    def _user_usage(self, queue: str, user: str, exclude: frozenset,
                    reduced: Optional[dict] = None) -> int:
        reduced = reduced or {}
        return sum(self._chips_held(a, reduced)
                   for a in self.running.values()
                   if a.app_id not in exclude and a.user == user
                   and queue in queue_ancestry(a.queue, self.queues))

    def _constraint_violation(self, ask: GangAsk, exclude: frozenset,
                              reduced: Optional[dict] = None
                              ) -> Optional[str]:
        """First violated constraint for granting `ask` with `exclude`d
        jobs gone and `reduced` jobs shrunk, or None when it fits
        whole."""
        if self.queues and ask.queue not in self.queues:
            return (f"unknown queue {ask.queue!r} (configured: "
                    f"{sorted(self.queues)})")
        if self.free_chips(exclude, reduced) < ask.chips:
            return (f"pool: {ask.chips} chips asked, "
                    f"{max(0, self.free_chips(exclude, reduced))} free of "
                    f"{self.total_chips}")
        for level in queue_ancestry(ask.queue, self.queues):
            spec = self.queues.get(level)
            if spec is None:
                continue
            cap = (spec.capacity_chips(self.total_chips, self.queues)
                   if self.total_chips > 0 and spec.capacity_share >= 0
                   else (1 << 30))
            used = self._queue_usage(level, exclude, reduced)
            if used + ask.chips > cap:
                return (f"queue {level!r} capacity: {used} running + "
                        f"{ask.chips} asked > {cap} chips "
                        f"({spec.capacity_share:g}% share)")
            if spec.max_tpus_per_user >= 0 and ask.user:
                uused = self._user_usage(level, ask.user, exclude, reduced)
                if uused + ask.chips > spec.max_tpus_per_user:
                    return (f"user {ask.user!r} quota in queue "
                            f"{level!r}: {uused} running + {ask.chips} "
                            f"asked > {spec.max_tpus_per_user}")
        return None

    # -- decisions -----------------------------------------------------
    def decide(self, ask: GangAsk) -> Decision:
        """Pure verdict for one gang ask against the current book.
        Elastic reclaim is judged BEFORE full eviction: shrinking a
        lower-priority elastic job toward its floor keeps it running,
        so it is always preferred over checkpoint-then-evicting a
        non-elastic job whole."""
        violation = self._constraint_violation(ask, frozenset())
        if violation is None:
            return Decision(ADMIT, "fits whole")
        reclaims = self._select_reclaims(ask)
        if reclaims is not None:
            return Decision(
                RECLAIM,
                f"fits after reclaiming "
                f"{[(a.app_id, c) for a, c in reclaims]} chips from "
                f"elastic job(s) ({violation})",
                reclaims=reclaims)
        victims = self._select_victims(ask)
        if victims is not None:
            return Decision(
                PREEMPT,
                f"fits after checkpoint-then-evicting "
                f"{[v.app_id for v in victims]} ({violation})",
                victims=victims)
        return Decision(QUEUE, violation)

    def admit(self, ask: GangAsk) -> Decision:
        """decide() + apply: an ADMIT grants the chips in the book (the
        atomic all-or-nothing grant); PREEMPT/QUEUE change nothing —
        the caller evicts victims (execute_preemption), re-syncs, and
        asks again once the registry shows them gone."""
        decision = self.decide(ask)
        if decision.admitted:
            self.running[ask.app_id] = ask
        return decision

    def _select_reclaims(self, ask: GangAsk
                         ) -> Optional[list[tuple[GangAsk, int]]]:
        """Reclaim-only plan: shrink lower-priority ELASTIC jobs toward
        their tony.elastic.min-width floors (whole chips-per-task
        slices, lowest-priority-first, youngest-first within a
        priority) until the ask fits whole; a reverse pass then hands
        back any slice the later picks made unnecessary, so the plan is
        minimal under the policy order. None = no reclaim-only plan
        satisfies the ask (full eviction is judged next)."""
        if not self.preemption_enabled:
            return None
        eligible = sorted(
            (a for a in self.running.values()
             if a.priority < ask.priority and a.reclaimable_chips > 0),
            key=lambda a: (a.priority, -a.started_ms))
        if not eligible:
            return None
        reductions: dict[str, int] = {}
        order: list[GangAsk] = []
        for a in eligible:
            if self._constraint_violation(ask, frozenset(),
                                          reductions) is None:
                break
            reductions[a.app_id] = a.reclaimable_chips
            order.append(a)
        if self._constraint_violation(ask, frozenset(),
                                      reductions) is not None:
            return None
        # minimality: hand slices back newest-pick-first, one
        # chips-per-task step at a time — no elastic job shrinks further
        # than the final plan actually needs
        for a in reversed(order):
            step = a.chips_per_task
            while reductions.get(a.app_id, 0) > 0:
                trial = dict(reductions)
                trial[a.app_id] -= step
                if trial[a.app_id] <= 0:
                    trial.pop(a.app_id)
                if self._constraint_violation(ask, frozenset(),
                                              trial) is None:
                    reductions = trial
                else:
                    break
        plan = [(a, reductions[a.app_id]) for a in order
                if reductions.get(a.app_id, 0) > 0]
        return plan or None

    def _select_victims(self, ask: GangAsk) -> Optional[list[GangAsk]]:
        """Minimal preemption set under the policy order: only jobs with
        STRICTLY lower priority are eligible, taken lowest-priority
        first and youngest-first within a priority (cheapest replay),
        until the ask fits whole; a reverse pass then drops any victim
        whose eviction the later picks made unnecessary. None = no
        eligible set satisfies the ask (gang stays atomic — queue it)."""
        if not self.preemption_enabled:
            return None
        eligible = sorted(
            (a for a in self.running.values()
             if a.priority < ask.priority),
            key=lambda a: (a.priority, -a.started_ms))
        chosen: list[GangAsk] = []
        excluded: set[str] = set()
        fits = False
        for victim in eligible:
            chosen.append(victim)
            excluded.add(victim.app_id)
            if self._constraint_violation(ask,
                                          frozenset(excluded)) is None:
                fits = True
                break
        if not fits:
            return None
        # minimality pass: try dropping victims newest-pick-first (the
        # LEAST preferred under the policy order) — whatever still fits
        # without one is kept running, so no job is evicted that the
        # final set doesn't actually need
        for victim in list(reversed(chosen)):
            trial = excluded - {victim.app_id}
            if self._constraint_violation(ask, frozenset(trial)) is None:
                excluded = trial
                chosen.remove(victim)
        return chosen


# ---------------------------------------------------------------------------
# side-effecting edges: evict via the victim AMs, resume lineage conf
# ---------------------------------------------------------------------------

def execute_preemption(victims: list[GangAsk], grace_ms: int = 0,
                       reason: str = "", requested_by: str = "arbiter",
                       auth_token: Optional[str] = None) -> list[str]:
    """Deliver request_preemption to every victim's AM (address from its
    fleet-registry entry). Returns the app ids actually reached; a
    victim whose AM is unreachable is skipped (its registry entry will
    go LOST and release the chips anyway)."""
    from tony_tpu_torch.rpc.client import ClusterServiceClient
    reached = []
    for victim in victims:
        host, _, port = victim.am_addr.rpartition(":")
        if not host or not port.isdigit():
            LOG.warning("victim %s has no am_addr in its registry "
                        "entry — skipping", victim.app_id)
            continue
        client = ClusterServiceClient(host, int(port),
                                      auth_token=auth_token)
        try:
            resp = client.request_preemption(
                grace_ms=grace_ms, reason=reason,
                requested_by=requested_by)
            if not (resp or {}).get("error"):
                reached.append(victim.app_id)
                LOG.info("preemption delivered to %s (%s)",
                         victim.app_id, victim.am_addr)
        except Exception:  # noqa: BLE001 — a dead AM releases via LOST
            LOG.warning("could not reach victim %s at %s",
                        victim.app_id, victim.am_addr, exc_info=True)
        finally:
            client.close()
    return reached


def execute_reclaims(reclaims: list, grace_ms: int = 0, reason: str = "",
                     requested_by: str = "arbiter",
                     auth_token: Optional[str] = None) -> list[str]:
    """Deliver the reclaim half of a RECLAIM verdict: each elastic
    victim's AM gets a request_resize shrinking it by the reclaimed
    slice (sized via elastic.reclaim_rpc_args — whole task slices for
    multi-task gangs, a re-mesh for single-task ones). The sibling of
    execute_preemption, but nobody loses their containers. Returns the
    app ids actually reached."""
    from tony_tpu_torch.cluster.elastic import reclaim_rpc_args
    from tony_tpu_torch.rpc.client import ClusterServiceClient
    reached = []
    for victim, chips in reclaims:
        summary = {"gang_width": victim.gang_width, "app_id": victim.app_id,
                   "allocated_chips": victim.chips,
                   "elastic_job": victim.elastic_job,
                   "elastic_width": victim.elastic_width,
                   "elastic_chips_per_task": victim.elastic_cpt}
        args = reclaim_rpc_args(summary, int(chips))
        host, _, port = victim.am_addr.rpartition(":")
        if args is None or not host or not port.isdigit():
            LOG.warning("reclaim victim %s not reachable/sizable "
                        "(am_addr=%r) — skipping", victim.app_id,
                        victim.am_addr)
            continue
        client = ClusterServiceClient(host, int(port),
                                      auth_token=auth_token)
        try:
            resp = client.request_resize(
                grace_ms=grace_ms, reason=reason,
                requested_by=requested_by, **args)
            if not (resp or {}).get("error"):
                reached.append(victim.app_id)
                LOG.info("reclaim of %d chip(s) delivered to %s (%s)",
                         chips, victim.app_id, victim.am_addr)
            else:
                LOG.warning("reclaim refused by %s: %s", victim.app_id,
                            resp.get("error"))
        except Exception:  # noqa: BLE001 — a dead AM releases via LOST
            LOG.warning("could not reach reclaim victim %s at %s",
                        victim.app_id, victim.am_addr, exc_info=True)
        finally:
            client.close()
    return reached


def offer_idle_chips(summaries: list[dict], idle_chips: int,
                     reason: str = "", requested_by: str = "arbiter",
                     auth_token: Optional[str] = None) -> list[dict]:
    """The offer loop's delivery edge: hand `idle_chips` spare chips to
    RUNNING elastic jobs that can widen (the candidates the annotated
    `fleet.chips_idle_while_queued` alert names), widest-headroom
    first. Each offer is a request_resize GROW against the job's AM;
    the AM's own validation (bounds, cooldown, competing lifecycle) is
    the final arbiter. Returns [{app_id, job_name, width}] actually
    delivered."""
    from tony_tpu_torch.cluster.elastic import find_widenable
    from tony_tpu_torch.observability.fleet import chips_of
    from tony_tpu_torch.rpc.client import ClusterServiceClient
    delivered = []
    remaining = int(idle_chips)
    for s in find_widenable(summaries):
        if remaining <= 0:
            break
        # the ELASTIC jobtype's own shape (blended gang_width/chips_of
        # would mis-size grows for mixed train+serve apps), with the
        # blended ratio as the legacy-summary fallback
        width = int(s.get("elastic_width", 0) or 0) \
            or int(s.get("gang_width", 0) or 0)
        cpt = int(s.get("elastic_chips_per_task", 0) or 0) \
            or max(1, chips_of(s) // max(1, width))
        grow = remaining // cpt
        max_width = int(s.get("elastic_max_width", 0) or 0)
        if max_width:
            grow = min(grow, max_width - width)
        if width <= 0 or grow <= 0:
            continue
        host, _, port = str(s.get("am_addr", "")).rpartition(":")
        if not host or not port.isdigit():
            continue
        client = ClusterServiceClient(host, int(port),
                                      auth_token=auth_token)
        try:
            resp = client.request_resize(
                job_name=str(s.get("elastic_job", "")),
                width=width + grow,
                reason=reason or f"offer: {remaining} idle chip(s)",
                requested_by=requested_by)
            if not (resp or {}).get("error"):
                delivered.append({"app_id": s.get("app_id"),
                                  "job_name": s.get("elastic_job"),
                                  "width": width + grow})
                remaining -= grow * cpt
            else:
                LOG.info("offer refused by %s: %s", s.get("app_id"),
                         resp.get("error"))
        except Exception:  # noqa: BLE001 — an offer is best-effort
            LOG.warning("could not offer chips to %s", s.get("app_id"),
                        exc_info=True)
        finally:
            client.close()
    return delivered


def resume_conf_overrides(preempted_summary: dict) -> dict[str, str]:
    """The conf keys a re-submission must carry to continue a PREEMPTED
    application: lineage (resumed-from), the eviction timestamp the
    goodput ledger prices into preemption_downtime_s, and the
    cumulative preemption count. The caller picks the new gang width —
    the resharding restore (train/checkpoint.py) maps the saved shards
    onto whatever mesh the re-admitted width builds."""
    return {
        K.APPLICATION_RESUMED_FROM:
            str(preempted_summary.get("app_id", "") or ""),
        K.APPLICATION_PREEMPTED_AT_MS:
            str(int(preempted_summary.get("heartbeat_ms", 0) or 0)),
        K.APPLICATION_PREEMPT_COUNT:
            str(int(preempted_summary.get("preemptions", 0) or 0)),
    }
