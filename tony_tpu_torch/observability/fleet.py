"""Fleet observability: live cross-job registry + chip-hour accounting.

The port's copy of `tony_tpu/observability/fleet.py`: the AM's jobstate
writer and the readers over a shared staging location. Every
observability surface before this one is scoped to a single application;
the multi-tenant view ("many jobs, many replicas" on one pool of
accelerators) is the cluster view the reference's history-server portal
gave operators (paper §portal):

- **Registry** (`FleetRegistry`): each AM periodically publishes a
  compact, heartbeat-stamped `jobstate.json` summary into its own
  staging namespace (`<location>/<app_id>/fleet/jobstate.json`) — no new
  RPC surface, the store IS the wire. The registry scans
  `*/fleet/jobstate.json`, demoting a RUNNING entry whose heartbeat aged
  past `tony.fleet.stale-after-ms` to **LOST** (its AM died without a
  terminal publish). Memory is bounded at `tony.fleet.history-jobs`
  entries; non-live entries evict oldest-first.
- **Ledger** (`FleetLedger`): folds terminal/LOST summaries — preferring
  the job's final published `goodput.json` bundle when present — into
  chip-second accounting split productive-vs-overhead, rolled up per
  job / queue / user, durable across restarts at
  `<location>/fleet/accounting.json`. Evicted per-job entries fold into
  the queue/user running totals: chip-hours are never lost, only
  coarsened.
- **Quota view** (`quota_utilization`): live chips-in-use per queue
  against the `tony.queues.<name>.max-tpus` quotas already declared in
  `conf/queues.py` — the utilization-of-quota number the arbiter
  (`cluster/arbiter.py`) judges asks against.
- **Exposition** (`fleet_families`): the fleet-level `/metrics` —
  re-exposes every `tony_job_*` gauge across all live jobs with
  `{app_id, queue, user}` labels through the shared prometheus encoder.
  `JOB_GAUGES` is the aggregation map; `tests/test_torch_fleet.py`
  holds every `tony_job_*` name the port's AM exports to a key here, so
  a new job gauge cannot be silently dropped from the fleet view.
- **`FleetView`**: registry + ledger + queue quotas bundled for the
  portal's index page / `/api/fleet` / `/api/fleet/queues` and for
  `python -m tony_tpu_torch.cli top`.

Pure stdlib; reads/writes go through the storage seam, so the same code
serves a local shared dir and a gs:// bucket.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Callable, Optional

from tony_tpu_torch import constants as C

LOG = logging.getLogger(__name__)

# store keys (relative): per-app live entry + fleet-root durable ledger
JOBSTATE_KEY = f"{C.FLEET_DIR_NAME}/{C.JOBSTATE_FILE}"
ACCOUNTING_KEY = f"{C.FLEET_DIR_NAME}/accounting.json"

LIVE_STATES = ("RUNNING",)
LOST_STATE = "LOST"
# PREEMPTED is terminal-but-resumable: the AM drained its gang on a
# checkpoint-then-evict request and the arbiter may re-admit the job
# later (the successor is a NEW app id carrying resumed-from lineage)
PREEMPTED_STATE = "PREEMPTED"
TERMINAL_STATES = ("SUCCEEDED", "FAILED", "KILLED", PREEMPTED_STATE,
                   LOST_STATE)

# display/sort order of states on the portal index + `cli top`
STATE_ORDER = ("RUNNING", LOST_STATE, PREEMPTED_STATE, "FAILED", "KILLED",
               "SUCCEEDED")

# The aggregation map: every job-level Prometheus gauge the AM exports →
# the jobstate summary field it is published under. The fleet /metrics
# re-exposes exactly these names with {app_id, queue, user} labels;
# tests/test_torch_fleet.py asserts every `tony_job_*` literal in the
# port's AM source is a key here, so a future job gauge cannot silently
# vanish from the cross-job view.
JOB_GAUGES = {
    "tony_job_goodput_pct": "goodput_pct",
    "tony_job_productive_seconds": "productive_s",
    "tony_job_relaunch_downtime_seconds": "relaunch_downtime_s",
    "tony_job_straggler_count": "straggler_count",
    "tony_job_alerts_firing": "alerts_firing",
    "tony_job_preemptions_total": "preemptions",
    "tony_job_resizes_total": "resizes",
    "tony_job_step_time_p50_ms": "step_time_p50_ms",
    "tony_job_step_time_p95_ms": "step_time_p95_ms",
    "tony_job_step_time_p99_ms": "step_time_p99_ms",
}

# the gang step-time spread gauges _check_stragglers refreshes each
# closed window — named HERE (not f-string-assembled in the AM) so the
# static check sees literal names that are JOB_GAUGES keys
STEP_TIME_GAUGES = {
    "p50": "tony_job_step_time_p50_ms",
    "p95": "tony_job_step_time_p95_ms",
    "p99": "tony_job_step_time_p99_ms",
}


def job_summary(app_id: str, user: str, queue: str, state: str, *,
                gang_width: int = 0, requested_chips: int = 0,
                allocated_chips: int = 0, started_ms: int = 0,
                goodput_pct: Optional[float] = None,
                mfu_pct: Optional[float] = None,
                straggler_count: int = 0,
                alerts_firing: int = 0,
                serving_tokens_per_sec: Optional[float] = None,
                preemptions: int = 0,
                resizes: int = 0,
                requested_width: Optional[int] = None,
                elastic_job: str = "",
                elastic_width: int = 0,
                elastic_chips_per_task: int = 0,
                elastic_min_width: int = 0,
                elastic_max_width: int = 0,
                elastic_min_chips: int = 0,
                priority: int = 0,
                am_addr: str = "",
                gauges: Optional[dict] = None,
                heartbeat_ms: Optional[int] = None) -> dict:
    """The one jobstate schema (writer: AM; readers: registry, ledger,
    portal, CLI). Compact by design — a 1k-job fleet scan must stay
    cheap — and heartbeat-stamped so staleness is a property of the
    entry, not of file mtimes a GCS round-trip can't see."""
    return {
        "app_id": app_id,
        "user": user,
        "queue": queue or "default",
        "state": state,
        "gang_width": int(gang_width),
        # elastic width surface: requested_width diverges from
        # gang_width while a resize is in flight (the fleet table and
        # `cli top` render "cur>req"); elastic_* name the resizable
        # jobtype and the floor/ceiling the arbiter's offer/reclaim
        # verdicts respect (elastic_job == "" means not elastic)
        "requested_width": int(requested_width if requested_width
                               is not None else gang_width),
        "resizes": int(resizes),
        "elastic_job": elastic_job,
        # the ELASTIC jobtype's own shape (gang_width spans every
        # tracked jobtype — reclaim arithmetic must never blend a
        # serving replica's chips into a worker slice's size)
        "elastic_width": int(elastic_width),
        "elastic_chips_per_task": int(elastic_chips_per_task),
        "elastic_min_width": int(elastic_min_width),
        "elastic_max_width": int(elastic_max_width),
        "elastic_min_chips": int(elastic_min_chips),
        "requested_chips": int(requested_chips),
        "allocated_chips": int(allocated_chips),
        "started_ms": int(started_ms),
        "heartbeat_ms": int(heartbeat_ms if heartbeat_ms is not None
                            else time.time() * 1000),
        "goodput_pct": goodput_pct,
        "mfu_pct": mfu_pct,
        "straggler_count": int(straggler_count),
        "alerts_firing": int(alerts_firing),
        "serving_tokens_per_sec": serving_tokens_per_sec,
        # arbitration surface: the admission arbiter reads victim
        # priority from the registry entry and reaches the AM's control
        # plane at am_addr to deliver request_preemption
        "preemptions": int(preemptions),
        "priority": int(priority),
        "am_addr": am_addr,
        "gauges": dict(gauges or {}),
    }


def chips_of(summary: dict) -> int:
    """The chip count a summary occupies: allocated when containers are
    live, else the requested ask (pre-allocation, and terminal summaries
    whose containers already exited — the reservation the quota was
    charged for)."""
    return int(summary.get("allocated_chips") or 0) \
        or int(summary.get("requested_chips") or 0)


def publish_job_state(store, summary: dict, scratch_dir: str) -> str:
    """AM-side: atomically publish one summary as this app's
    `fleet/jobstate.json` (tmp-file + store.put — the put itself is the
    store's atomicity problem). Returns the published URI."""
    fd, tmp = tempfile.mkstemp(prefix="jobstate-", suffix=".json",
                               dir=scratch_dir or None)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
        return store.put(tmp, JOBSTATE_KEY)
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass


def _read_json_key(store, key: str):
    """One store key parsed as JSON (None on absence/damage). Local
    stores read in place; remote stores fetch to a scratch file."""
    uri = store.uri(key)
    path = uri[len("file://"):] if uri.startswith("file://") else uri
    tmp = None
    try:
        if not os.path.isfile(path):
            fd, tmp = tempfile.mkstemp(prefix="fleet-", suffix=".json")
            os.close(fd)
            store.fetch(uri, tmp)
            path = tmp
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except Exception:  # noqa: BLE001 — a damaged entry must not kill the scan
        return None
    finally:
        if tmp is not None:
            try:
                os.remove(tmp)
            except OSError:
                pass


def _state_rank(state: str) -> int:
    try:
        return STATE_ORDER.index(state)
    except ValueError:
        return len(STATE_ORDER)


def sort_jobs(jobs: list[dict]) -> list[dict]:
    """State-then-start-time ordering (RUNNING first, newest first
    within a state) — the portal index and `cli top` contract."""
    return sorted(jobs, key=lambda j: (_state_rank(str(j.get("state", ""))),
                                       -int(j.get("started_ms", 0) or 0),
                                       str(j.get("app_id", ""))))


class FleetRegistry:
    """The live cross-job view over a staging location.

    `refresh()` re-scans `*/fleet/jobstate.json` (throttled), folds each
    summary via `observe()`, demotes stale RUNNING entries to LOST, and
    appends the cluster chips-in-use sample to a bounded timeline.
    Everything is bounded: at most `max_jobs` entries (non-live evict
    oldest first) and one decimating TimeSeries for the timeline."""

    def __init__(self, location: str = "", stale_after_ms: int = 30_000,
                 max_jobs: int = 200, refresh_interval_ms: int = 1000,
                 clock: Callable[[], float] = time.time, store=None):
        if store is None and location:
            from tony_tpu_torch.storage import location_store
            store = location_store(location)
        self._store = store
        self._stale_after_ms = max(1, int(stale_after_ms))
        self._max_jobs = max(1, int(max_jobs))
        self._refresh_interval_s = max(0.0, refresh_interval_ms / 1000.0)
        self._clock = clock
        self._jobs: dict[str, dict] = {}  # guarded-by: _lock
        # app ids whose NON-LOST terminal state has been observed: their
        # jobstate files are immutable, so the scan never refetches them
        # — even after the bounded job map evicts the entry itself.
        # Ids only (bytes per job), insertion-ordered, capped well above
        # the job bound; falling off the memo merely costs a refetch.
        self._settled: dict[str, bool] = {}  # guarded-by: _lock
        self._settled_cap = max(1000, 50 * self._max_jobs)
        self._last_refresh = 0.0
        from tony_tpu_torch.observability.metrics import TimeSeries
        self._timeline = TimeSeries(256)
        self._lock = threading.Lock()

    def observe(self, summary: dict) -> None:
        """Fold one summary into the registry (also the unit-test entry
        point). A terminal state never regresses to RUNNING — a stale
        live file listed after the terminal one must not resurrect a
        finished job."""
        app_id = str(summary.get("app_id", "") or "")
        if not app_id:
            return
        with self._lock:
            cur = self._jobs.get(app_id)
            if cur is not None:
                cur_terminal = cur.get("state") in TERMINAL_STATES \
                    and cur.get("state") != LOST_STATE
                if cur_terminal and summary.get("state") in LIVE_STATES:
                    return
                if int(summary.get("heartbeat_ms", 0) or 0) < int(
                        cur.get("heartbeat_ms", 0) or 0):
                    return
            self._jobs[app_id] = dict(summary)
            state = summary.get("state")
            if state in TERMINAL_STATES and state != LOST_STATE:
                self._settled[app_id] = True
                while len(self._settled) > self._settled_cap:
                    self._settled.pop(next(iter(self._settled)))
            # bound enforcement only — the full staleness pass runs once
            # per refresh(), not once per observed summary (a 1k-job
            # scan must stay O(n), not O(n²))
            self._evict_locked()

    # holds: _lock (the _locked suffix is the caller contract)
    def _demote_and_evict_locked(self) -> None:
        now_ms = int(self._clock() * 1000)
        for job in self._jobs.values():
            if (job.get("state") in LIVE_STATES
                    and now_ms - int(job.get("heartbeat_ms", 0) or 0)
                    > self._stale_after_ms):
                job["state"] = LOST_STATE
                job["demoted_ms"] = now_ms
        self._evict_locked()

    # holds: _lock (the _locked suffix is the caller contract)
    def _evict_locked(self) -> None:
        while len(self._jobs) > self._max_jobs:
            # one victim per overflow: non-live first, then oldest
            # heartbeat; live entries go only when the fleet itself
            # exceeds the bound. Steady-state overflow is 1, so a min
            # scan beats re-sorting the whole map per insert.
            victim = min(
                self._jobs.values(),
                key=lambda j: (j.get("state") in LIVE_STATES,
                               int(j.get("heartbeat_ms", 0) or 0)))
            self._jobs.pop(victim["app_id"], None)

    def refresh(self, force: bool = False) -> None:
        """One throttled scan of the store (no-op without a store — a
        registry fed purely via observe() still demotes/evicts)."""
        now = self._clock()
        if not force and now - self._last_refresh < self._refresh_interval_s:
            return
        self._last_refresh = now
        if self._store is not None:
            try:
                keys = self._store.glob(f"*/{JOBSTATE_KEY}")
            except Exception:  # noqa: BLE001 — store hiccup ≠ fleet outage
                LOG.exception("fleet jobstate scan failed")
                keys = []
            for key in keys:
                # a settled (non-LOST terminal) entry is immutable — a
                # terminal state never regresses, so re-fetching its
                # file every pass only burns I/O (on GCS, a subprocess
                # per key per refresh). LOST entries stay hot: their AM
                # may turn out alive and republish.
                app_id = key.split("/", 1)[0]
                with self._lock:
                    settled = app_id in self._settled
                if settled:
                    continue
                summary = _read_json_key(self._store, key)
                if isinstance(summary, dict):
                    self.observe(summary)
        with self._lock:
            self._demote_and_evict_locked()
            chips = sum(chips_of(j) for j in self._jobs.values()
                        if j.get("state") in LIVE_STATES)
        self._timeline.append(int(now * 1000), float(chips))

    # -- views --------------------------------------------------------
    def jobs(self) -> list[dict]:
        with self._lock:
            return sort_jobs([dict(j) for j in self._jobs.values()])

    def live_jobs(self) -> list[dict]:
        return [j for j in self.jobs() if j.get("state") in LIVE_STATES]

    def get(self, app_id: str) -> Optional[dict]:
        with self._lock:
            job = self._jobs.get(app_id)
            return dict(job) if job is not None else None

    def chips_in_use(self) -> int:
        return sum(chips_of(j) for j in self.live_jobs())

    def timeline(self) -> list[list]:
        """[[ts_ms, chips_in_use], ...] — the cluster chip-utilization
        series behind the portal's timeline SVG."""
        return self._timeline.to_list()

    def __len__(self) -> int:
        with self._lock:
            return len(self._jobs)


def _hours(chip_seconds: float) -> float:
    return round(chip_seconds / 3600.0, 4)


def _empty_bucket() -> dict:
    return {"jobs": 0, "chip_seconds": 0.0,
            "productive_chip_seconds": 0.0, "overhead_chip_seconds": 0.0}


def _add_to_bucket(bucket: dict, entry: dict) -> None:
    bucket["jobs"] += 1
    for k in ("chip_seconds", "productive_chip_seconds",
              "overhead_chip_seconds"):
        bucket[k] = round(bucket[k] + entry[k], 4)


def _sub_from_bucket(bucket: dict, entry: dict) -> None:
    """Inverse of _add_to_bucket — un-folds a provisional LOST entry's
    contribution when the job's real terminal state shows up."""
    bucket["jobs"] = max(0, bucket["jobs"] - 1)
    for k in ("chip_seconds", "productive_chip_seconds",
              "overhead_chip_seconds"):
        bucket[k] = round(max(0.0, bucket[k] - entry[k]), 4)


class FleetLedger:
    """Durable chip-second accounting across completed (and LOST) jobs.

    `fold()` turns one terminal summary into a per-job entry:
    chip_seconds = chips × job extent (started→last heartbeat), split
    productive vs overhead by the job's goodput percentage — the final
    `goodput.json` bundle's number when the caller has it (authoritative:
    it includes relaunch downtime), else the last live-pushed one.
    Entries are idempotent per app_id and capped at `history_jobs`;
    evictions fold into per-queue/per-user running totals, and the whole
    state round-trips through `fleet/accounting.json` on the store so a
    portal restart loses nothing."""

    def __init__(self, location: str = "", history_jobs: int = 200,
                 clock: Callable[[], float] = time.time, store=None):
        if store is None and location:
            from tony_tpu_torch.storage import location_store
            store = location_store(location)
        self._store = store
        self._history_jobs = max(1, int(history_jobs))
        self._clock = clock
        self._jobs: dict[str, dict] = {}
        self._queues: dict[str, dict] = {}
        self._users: dict[str, dict] = {}
        self._folded_jobs = 0
        # LOST entries evicted into the rollups, retained (bounded) so a
        # resurrected job's real terminal state can un-fold the stale
        # extent instead of double-counting it
        self._evicted_lost: dict[str, dict] = {}
        self._dirty = False
        self._lock = threading.Lock()
        # one writer at a time through save(): two portal handler
        # threads must not interleave the snapshot/put cycle
        self._save_lock = threading.Lock()
        self.load()

    # -- persistence --------------------------------------------------
    def load(self) -> None:
        if self._store is None:
            return
        data = _read_json_key(self._store, ACCOUNTING_KEY)
        if not isinstance(data, dict):
            return
        with self._lock:
            self._jobs = {k: v for k, v in (data.get("jobs") or {}).items()
                          if isinstance(v, dict)}
            # the RAW eviction accumulators, not the derived per-queue/
            # per-user view (which already includes the retained jobs —
            # restoring it would double-count them on every reload)
            self._queues = {
                k: v for k, v in (data.get("folded_queues") or {}).items()
                if isinstance(v, dict)}
            self._users = {
                k: v for k, v in (data.get("folded_users") or {}).items()
                if isinstance(v, dict)}
            self._folded_jobs = int(data.get("folded_jobs", 0) or 0)
            self._evicted_lost = {
                k: v for k, v in (data.get("evicted_lost") or {}).items()
                if isinstance(v, dict)}

    def save(self, force: bool = False) -> None:
        if self._store is None or (not self._dirty and not force):
            return
        with self._save_lock:
            # derived view for human readers + the raw accumulators
            # load() actually restores
            snapshot = self.accounting()
            with self._lock:
                snapshot["folded_queues"] = {
                    k: dict(v) for k, v in self._queues.items()}
                snapshot["folded_users"] = {
                    k: dict(v) for k, v in self._users.items()}
                snapshot["evicted_lost"] = {
                    k: dict(v) for k, v in self._evicted_lost.items()}
            fd, tmp = tempfile.mkstemp(prefix="accounting-",
                                       suffix=".json")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(snapshot, f, indent=1, sort_keys=True)
                self._store.put(tmp, ACCOUNTING_KEY)
                self._dirty = False
            except Exception:  # noqa: BLE001 — must not kill the portal
                LOG.exception("failed to persist fleet accounting")
            finally:
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    # -- folding ------------------------------------------------------
    def has(self, app_id: str) -> bool:
        with self._lock:
            return app_id in self._jobs

    def should_fold(self, summary: dict) -> bool:
        """Does this summary still owe the ledger an entry? Terminal/
        LOST states not yet folded — plus the resurrection case: a job
        provisionally folded as LOST whose AM turned out alive (stalled
        publisher) and later published a REAL terminal state must be
        re-accounted at its true extent, not the 30-second stale
        snapshot."""
        state = str(summary.get("state", "") or "")
        if state not in TERMINAL_STATES:
            return False
        app_id = str(summary.get("app_id", "") or "")
        with self._lock:
            cur = self._jobs.get(app_id)
            if cur is None:
                # an evicted-LOST ghost also owes a refold on a real
                # terminal state (its stale extent sits in the rollups)
                if app_id in self._evicted_lost:
                    return state != LOST_STATE
                return True
        return cur.get("state") == LOST_STATE and state != LOST_STATE

    def fold(self, summary: dict, goodput: Optional[dict] = None
             ) -> Optional[dict]:
        """Account one finished/LOST job; returns the entry (None when
        the summary is still live or already folded)."""
        app_id = str(summary.get("app_id", "") or "")
        state = str(summary.get("state", "") or "")
        if not app_id or state not in TERMINAL_STATES:
            return None
        started = int(summary.get("started_ms", 0) or 0)
        ended = int(summary.get("heartbeat_ms", 0) or 0)
        extent_s = max(0.0, (ended - started) / 1000.0) if started else 0.0
        chips = chips_of(summary)
        goodput_pct = summary.get("goodput_pct")
        if isinstance(goodput, dict):
            job = goodput.get("job") or {}
            if isinstance(job.get("goodput_pct"), (int, float)):
                goodput_pct = job["goodput_pct"]
        frac = min(1.0, max(0.0, float(goodput_pct or 0.0) / 100.0))
        chip_s = chips * extent_s
        entry = {
            "app_id": app_id,
            "queue": str(summary.get("queue", "default") or "default"),
            "user": str(summary.get("user", "") or ""),
            "state": state,
            "chips": chips,
            "extent_s": round(extent_s, 3),
            "chip_seconds": round(chip_s, 4),
            "productive_chip_seconds": round(chip_s * frac, 4),
            "overhead_chip_seconds": round(chip_s * (1.0 - frac), 4),
            "goodput_pct": round(float(goodput_pct or 0.0), 3),
            "ended_ms": ended,
        }
        with self._lock:
            cur = self._jobs.get(app_id)
            if cur is not None and not (cur.get("state") == LOST_STATE
                                        and state != LOST_STATE):
                # idempotent — except a provisional LOST entry, which a
                # genuine terminal summary replaces wholesale (the
                # per-job entry hasn't hit the rollup accumulators yet,
                # so replacing recomputes the derived totals honestly)
                return None
            ghost = self._evicted_lost.pop(app_id, None)
            if ghost is not None:
                if state == LOST_STATE:
                    # same stale evidence re-listed: stay idempotent
                    self._evicted_lost[app_id] = ghost
                    return None
                # the provisional LOST extent already reached the
                # rollup accumulators at eviction — un-fold it before
                # accounting the true extent
                _sub_from_bucket(self._queues.setdefault(
                    ghost["queue"], _empty_bucket()), ghost)
                _sub_from_bucket(self._users.setdefault(
                    ghost["user"], _empty_bucket()), ghost)
                self._folded_jobs = max(0, self._folded_jobs - 1)
            self._jobs[app_id] = entry
            self._dirty = True
            overflow = len(self._jobs) - self._history_jobs
            if overflow > 0:
                oldest = sorted(self._jobs.values(),
                                key=lambda e: int(e.get("ended_ms", 0) or 0))
                for victim in oldest[:overflow]:
                    self._fold_away_locked(victim)
        return entry

    def _fold_away_locked(self, entry: dict) -> None:
        """Evict one per-job entry into the coarse rollups (chip-hours
        survive, per-job detail doesn't — the boundedness contract)."""
        self._jobs.pop(entry["app_id"], None)
        _add_to_bucket(self._queues.setdefault(entry["queue"],
                                               _empty_bucket()), entry)
        _add_to_bucket(self._users.setdefault(entry["user"],
                                              _empty_bucket()), entry)
        self._folded_jobs += 1
        if entry.get("state") == LOST_STATE:
            # remember the provisional extent (bounded) so a late real
            # terminal state can un-fold it instead of double-counting
            self._evicted_lost[entry["app_id"]] = entry
            while len(self._evicted_lost) > self._history_jobs:
                self._evicted_lost.pop(next(iter(self._evicted_lost)))

    def __len__(self) -> int:
        with self._lock:
            return len(self._jobs)

    # -- views --------------------------------------------------------
    def accounting(self) -> dict:
        """The durable shape: per-job entries + folded rollups + derived
        per-queue/per-user totals (folded + retained), chip-hours
        included for the human surfaces."""
        with self._lock:
            jobs = {k: dict(v) for k, v in self._jobs.items()}
            queues = {k: dict(v) for k, v in self._queues.items()}
            users = {k: dict(v) for k, v in self._users.items()}
            folded = self._folded_jobs
        for entry in jobs.values():
            _add_to_bucket(queues.setdefault(entry["queue"],
                                             _empty_bucket()), entry)
            _add_to_bucket(users.setdefault(entry["user"],
                                            _empty_bucket()), entry)
        for bucket in list(queues.values()) + list(users.values()):
            bucket["chip_hours"] = _hours(bucket["chip_seconds"])
            bucket["productive_chip_hours"] = _hours(
                bucket["productive_chip_seconds"])
            bucket["overhead_chip_hours"] = _hours(
                bucket["overhead_chip_seconds"])
        return {"jobs": jobs, "queues": queues, "users": users,
                "folded_jobs": folded,
                "generated_ms": int(self._clock() * 1000)}


def quota_utilization(queues: dict[str, int],
                      live_jobs: list[dict]) -> dict[str, dict]:
    """Live chips-in-use per queue against the declared
    `tony.queues.<name>.max-tpus` quotas. Queues with live jobs but no
    declared quota appear with max_tpus=0 and no utilization_pct (the
    standalone tag-only mode of conf/queues.py)."""
    out: dict[str, dict] = {
        q: {"max_tpus": int(cap), "chips_in_use": 0, "live_jobs": 0}
        for q, cap in queues.items()}
    for job in live_jobs:
        q = str(job.get("queue", "default") or "default")
        bucket = out.setdefault(
            q, {"max_tpus": 0, "chips_in_use": 0, "live_jobs": 0})
        bucket["chips_in_use"] += chips_of(job)
        bucket["live_jobs"] += 1
    for bucket in out.values():
        if bucket["max_tpus"] > 0:
            bucket["utilization_pct"] = round(
                100.0 * bucket["chips_in_use"] / bucket["max_tpus"], 2)
    return out


def fleet_families(live_jobs: list[dict],
                   queues: Optional[dict[str, int]] = None) -> list[dict]:
    """Prometheus families for the fleet `/metrics`: every JOB_GAUGES
    entry of every live job with {app_id, queue, user} labels, plus the
    cluster rollup gauges. Render with observability.prometheus.render."""
    per_gauge: dict[str, dict] = {}
    chips = 0
    for job in live_jobs:
        labels = {"app_id": str(job.get("app_id", "")),
                  "queue": str(job.get("queue", "default") or "default"),
                  "user": str(job.get("user", "") or "")}
        chips += chips_of(job)
        gauges = job.get("gauges") or {}
        for name, summary_field in JOB_GAUGES.items():
            # the gauges map is authoritative; the named summary field
            # backfills entries published before the gauge existed
            value = gauges.get(name)
            if not isinstance(value, (int, float)):
                value = job.get(summary_field)
            if isinstance(value, (int, float)):
                fam = per_gauge.setdefault(
                    name, {"name": name, "type": "gauge", "help": "",
                           "samples": []})
                fam["samples"].append((labels, float(value)))
    families = [per_gauge[k] for k in sorted(per_gauge)]
    families.append({"name": "tony_fleet_live_jobs", "type": "gauge",
                     "help": "", "samples": [({}, float(len(live_jobs)))]})
    families.append({"name": "tony_fleet_chips_in_use", "type": "gauge",
                     "help": "", "samples": [({}, float(chips))]})
    if queues is not None:
        util = quota_utilization(queues, live_jobs)
        quota_fam = {"name": "tony_fleet_queue_quota_tpus", "type": "gauge",
                     "help": "", "samples": []}
        used_fam = {"name": "tony_fleet_queue_chips_in_use", "type": "gauge",
                    "help": "", "samples": []}
        for q in sorted(util):
            labels = {"queue": q}
            quota_fam["samples"].append((labels,
                                         float(util[q]["max_tpus"])))
            used_fam["samples"].append((labels,
                                        float(util[q]["chips_in_use"])))
        families += [quota_fam, used_fam]
    return families


class FleetView:
    """Registry + ledger + declared quotas behind one refresh() — what
    the portal server and `cli top` hold. refresh() also advances the
    accounting: any registry entry that went terminal (or LOST) folds
    into the ledger, with the job's final published goodput.json
    preferred as the productive/overhead split."""

    def __init__(self, location: str, queues: Optional[dict] = None,
                 stale_after_ms: int = 30_000, history_jobs: int = 200,
                 refresh_interval_ms: int = 1000,
                 clock: Callable[[], float] = time.time,
                 settle_accounting: bool = True,
                 alert_engine=None):
        self.location = location
        self.queues = {str(q): int(cap) for q, cap in (queues or {}).items()}
        # fleet-scope alerting (observability/alerts.py: queue-quota
        # saturation, job LOST, chips idle while queued), evaluated on
        # THIS refresh cadence over the registry snapshot — the portal
        # passes an engine built from its conf; `cli top` and tests may
        # run without one
        self.alert_engine = alert_engine
        # observers (cli top) read the durable accounting but never
        # advance it: ONE writer — the portal, running with the
        # cluster's configured staleness/bounds — owns the fold-and-save
        # cycle, so a status command with default knobs can't demote a
        # momentarily-quiet job and persist the mis-accounting
        self._settle_accounting = settle_accounting
        self.registry = FleetRegistry(
            location, stale_after_ms=stale_after_ms, max_jobs=history_jobs,
            refresh_interval_ms=refresh_interval_ms, clock=clock)
        self.ledger = FleetLedger(location, history_jobs=history_jobs,
                                  clock=clock)
        self._store = self.registry._store

    def refresh(self, force: bool = False) -> None:
        self.registry.refresh(force=force)
        self._check_alerts()
        if not self._settle_accounting:
            return
        for job in self.registry.jobs():
            if not self.ledger.should_fold(job):
                continue
            goodput = None
            if self._store is not None:
                goodput = _read_json_key(
                    self._store,
                    f"{job.get('app_id', '')}/history/{C.GOODPUT_FILE}")
            self.ledger.fold(job, goodput=goodput)
        self.ledger.save()

    def _check_alerts(self) -> None:
        """One fleet-scope alert pass (the engine's only fleet-side
        call site — fleet-scan cadence, nothing hotter). Transitions go
        to the engine's sinks; the portal reads firing state via
        api_alerts()/families()."""
        if self.alert_engine is None:
            return
        try:
            from tony_tpu_torch.observability.alerts import AlertContext
            self.alert_engine.evaluate(AlertContext(
                fleet={"jobs": self.registry.jobs(),
                       "queues": self.queues}))
        except Exception:  # noqa: BLE001 — alerting must not break refresh
            LOG.exception("fleet alert check failed")

    # -- API payloads (portal /api/fleet + /api/fleet/queues) ---------
    def api_fleet(self) -> dict:
        jobs = self.registry.jobs()
        return {
            "jobs": jobs,
            "live_jobs": sum(1 for j in jobs
                             if j.get("state") in LIVE_STATES),
            "chips_in_use": self.registry.chips_in_use(),
            "timeline": self.registry.timeline(),
            "generated_ms": int(time.time() * 1000),
        }

    def api_queues(self) -> dict:
        accounting = self.ledger.accounting()
        return {
            "queues": quota_utilization(self.queues,
                                        self.registry.live_jobs()),
            "accounting": accounting,
        }

    def api_alerts(self) -> dict:
        """GET /api/fleet/alerts payload: the fleet-scope engine's
        bundle plus every registry job's own firing count (the
        tony_job_alerts_firing gauge each AM publishes in its
        jobstate) — one endpoint answering 'what is paging, anywhere'."""
        out: dict = {"firing": [], "log": [], "rules": []}
        if self.alert_engine is not None:
            out = self.alert_engine.bundle()
        out["jobs"] = [
            {"app_id": j.get("app_id", ""), "state": j.get("state", ""),
             "queue": j.get("queue", ""), "user": j.get("user", ""),
             "alerts_firing": int(j.get("alerts_firing", 0) or 0)}
            for j in self.registry.jobs()
            if int(j.get("alerts_firing", 0) or 0) > 0
            or j.get("state") == LOST_STATE]
        return out

    def families(self) -> list[dict]:
        families = fleet_families(self.registry.live_jobs(), self.queues)
        if self.alert_engine is not None:
            from tony_tpu_torch.observability.alerts import (
                alert_firing_families,
            )
            families += alert_firing_families(self.alert_engine.firing())
        return families
