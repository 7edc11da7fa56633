"""Write-ahead journal of AM control-plane state (crash survivability).

The port's copy of `tony_tpu/am/journal.py`: the same journal format,
so a port AM replays what either package's AM wrote.

The AM's in-memory control plane — which tasks registered at which
attempt, the cluster-spec generation, serving endpoints and their
draining flags, in-flight preemption/resize state, and the goodput
downtime clocks — dies with the AM process. The reference system
treats AM retry as a core capability (TonY, arxiv 1904.01631 §3.3:
a new AM attempt rebuilds state and the gang re-registers); this
module is the durable half of that story for tony-tpu.

Design: an append-only JSON-lines journal (`journal.jsonl`) in the
app staging dir, every record flushed + fsync'd before the mutation
it describes is acknowledged to anyone outside the process, layered
over a tmp+rename snapshot (`journal-snapshot.json`) that compacts
the prefix every `tony.am.journal-snapshot-every` records so replay
length stays bounded. Records are attempt-stamped (`am_attempt`) and
sequence-numbered; replay:

- tolerates a torn final line (a crash mid-append leaves at most one
  partial record, which is dropped);
- fences per-task attempt regressions (a record that would move a
  task's attempt backwards is ignored — late journal writes from a
  doomed attempt cannot resurrect superseded state);
- resets task/endpoint state on a `session` record with a newer
  session id (an in-process session retry voids prior registrations)
  while carrying the downtime clocks across.

The recovering AM attempt replays into a `RecoveredState`, applies it
to a fresh `TonySession` (session.restore_for_recovery / adopt_task),
and then gates RUNNING on the adoption barrier — see
ApplicationMaster._run_session.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from tony_tpu_torch import constants as C
from tony_tpu_torch.events.history import write_json_atomic

log = logging.getLogger(__name__)

# record types — the full journaled control-plane vocabulary
REC_SESSION = "session"        # session start: id, expected width, instances
REC_REGISTER = "register"      # task registered: host_port/attempt/generation
REC_CONTAINER = "container"    # container allocated for a task attempt
REC_RELAUNCH = "relaunch"      # task relaunched: attempt bump + generation
REC_COMPLETED = "completed"    # task finished: exit code + terminal status
REC_ENDPOINT = "endpoint"      # serving endpoint published/drained/removed
REC_PREEMPTION = "preemption"  # preemption drain in flight (or cleared)
REC_RESIZE = "resize"          # elastic resize in flight (or cleared)
REC_CLOCK = "clock"            # goodput downtime clocks (periodic)


def journal_path(app_dir: str) -> str:
    return os.path.join(app_dir, C.AM_JOURNAL_FILE)


def snapshot_path(app_dir: str) -> str:
    return os.path.join(app_dir, C.AM_JOURNAL_SNAPSHOT_FILE)


class RecoveredState:
    """Accumulator a journal replays into: the minimal control-plane
    image a fresh AM attempt needs to adopt a still-running gang.

    Plain mutable object, no locking — it is either owned by the
    journal (which applies records under its own lock) or built
    single-threaded during replay before the recovering AM starts
    serving RPCs.
    """

    def __init__(self) -> None:
        self.session_id = 0
        self.num_expected = 0
        self.instances: Dict[str, int] = {}       # job name -> count
        self.spec_generation = 1
        # task_id -> {host_port, attempt, session_id, container_id, host,
        #             completed, exit_code, status, lifecycle_relaunches}
        self.tasks: Dict[str, Dict[str, Any]] = {}
        # task_id -> {url, generation, draining}
        self.endpoints: Dict[str, Dict[str, Any]] = {}
        self.preemption: Optional[Dict[str, Any]] = None
        self.resize: Optional[Dict[str, Any]] = None
        self.clocks: Dict[str, float] = {
            "relaunch_downtime_s": 0.0,
            "preemption_downtime_s": 0.0,
            "resize_downtime_s": 0.0,
            "am_downtime_s": 0.0,
        }
        self.am_attempt = 0
        self.replayed_records = 0
        self.last_ts_ms = 0        # downtime anchor: last record's stamp

    # ------------------------------------------------------------------
    def _task(self, task_id: str) -> Dict[str, Any]:
        return self.tasks.setdefault(task_id, {
            "host_port": "", "attempt": 0, "session_id": self.session_id,
            "container_id": "", "host": "", "completed": False,
            "exit_code": 0, "status": "", "lifecycle_relaunches": 0,
        })

    def apply(self, rec: Dict[str, Any]) -> None:
        """Fold one journal record in. Fences per-task attempt
        regressions; unknown record types are skipped (forward
        compatibility across AM versions sharing a staging dir)."""
        rtype = rec.get("type")
        self.replayed_records += 1
        self.last_ts_ms = max(self.last_ts_ms, int(rec.get("ts_ms", 0)))
        self.am_attempt = max(self.am_attempt, int(rec.get("am_attempt", 0)))
        if rtype == REC_SESSION:
            sid = int(rec.get("session_id", 0))
            if sid > self.session_id or not self.tasks:
                # a newer in-process session retry voids registrations
                # and in-flight machinery, but the clocks carry across
                self.tasks.clear()
                self.endpoints.clear()
                self.preemption = None
                self.resize = None
            self.session_id = sid
            self.num_expected = int(rec.get("expected", self.num_expected))
            self.instances = dict(rec.get("instances", self.instances))
        elif rtype == REC_REGISTER:
            t = self._task(rec["task_id"])
            if int(rec.get("attempt", 0)) < t["attempt"]:
                return          # attempt fence: stale record
            t["attempt"] = int(rec.get("attempt", 0))
            t["host_port"] = rec.get("host_port", "")
            t["session_id"] = int(rec.get("session_id", self.session_id))
            t["completed"] = False
            self.spec_generation = max(self.spec_generation,
                                       int(rec.get("generation", 1)))
        elif rtype == REC_CONTAINER:
            t = self._task(rec["task_id"])
            if int(rec.get("attempt", 0)) < t["attempt"]:
                return
            t["attempt"] = int(rec.get("attempt", 0))
            t["container_id"] = rec.get("container_id", "")
            t["host"] = rec.get("host", "")
        elif rtype == REC_RELAUNCH:
            t = self._task(rec["task_id"])
            if int(rec.get("attempt", 0)) < t["attempt"]:
                return
            t["attempt"] = int(rec.get("attempt", 0))
            t["host_port"] = ""          # registration voided by relaunch
            t["completed"] = False
            if rec.get("lifecycle"):
                t["lifecycle_relaunches"] = t.get("lifecycle_relaunches",
                                                  0) + 1
            self.spec_generation = max(self.spec_generation,
                                       int(rec.get("generation",
                                                   self.spec_generation)))
            self.endpoints.pop(rec["task_id"], None)
        elif rtype == REC_COMPLETED:
            t = self._task(rec["task_id"])
            if int(rec.get("attempt", -1)) not in (-1, t["attempt"]):
                return          # a superseded attempt's late completion
            t["completed"] = True
            t["exit_code"] = int(rec.get("exit_code", 0))
            t["status"] = rec.get("status", "")
            self.endpoints.pop(rec["task_id"], None)
        elif rtype == REC_ENDPOINT:
            if rec.get("removed"):
                self.endpoints.pop(rec["task_id"], None)
            else:
                self.endpoints[rec["task_id"]] = {
                    "url": rec.get("url", ""),
                    "generation": int(rec.get("generation", 0)),
                    "draining": bool(rec.get("draining", False)),
                    "role": rec.get("role", ""),
                }
        elif rtype == REC_PREEMPTION:
            self.preemption = None if rec.get("cleared") else {
                k: v for k, v in rec.items()
                if k not in ("type", "seq", "ts_ms", "am_attempt")}
        elif rtype == REC_RESIZE:
            self.resize = None if rec.get("cleared") else {
                k: v for k, v in rec.items()
                if k not in ("type", "seq", "ts_ms", "am_attempt")}
        elif rtype == REC_CLOCK:
            for key in self.clocks:
                if key in rec:
                    self.clocks[key] = float(rec[key])

    # ------------------------------------------------------------------
    def live_tasks(self) -> Dict[str, Dict[str, Any]]:
        """Tasks that were registered and not terminal at crash time —
        the adoption barrier's membership."""
        return {tid: t for tid, t in self.tasks.items()
                if t.get("host_port") and not t.get("completed")}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "session_id": self.session_id,
            "num_expected": self.num_expected,
            "instances": self.instances,
            "spec_generation": self.spec_generation,
            "tasks": self.tasks,
            "endpoints": self.endpoints,
            "preemption": self.preemption,
            "resize": self.resize,
            "clocks": self.clocks,
            "am_attempt": self.am_attempt,
            "replayed_records": self.replayed_records,
            "last_ts_ms": self.last_ts_ms,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RecoveredState":
        st = cls()
        st.session_id = int(d.get("session_id", 0))
        st.num_expected = int(d.get("num_expected", 0))
        st.instances = dict(d.get("instances", {}))
        st.spec_generation = int(d.get("spec_generation", 1))
        st.tasks = {k: dict(v) for k, v in d.get("tasks", {}).items()}
        st.endpoints = {k: dict(v) for k, v in d.get("endpoints", {}).items()}
        st.preemption = d.get("preemption")
        st.resize = d.get("resize")
        st.clocks.update(d.get("clocks", {}))
        st.am_attempt = int(d.get("am_attempt", 0))
        st.replayed_records = int(d.get("replayed_records", 0))
        st.last_ts_ms = int(d.get("last_ts_ms", 0))
        return st


class ControlPlaneJournal:
    """Appender half: fsync'd incremental records + periodic compaction.

    Thread-safe; the AM calls `append` from RPC handler threads, the
    monitor loop, and completion callbacks concurrently. `append`
    never raises — a journal-write failure must degrade crash
    survivability, never the running application.
    """

    def __init__(self, app_dir: str, am_attempt: int = 0,
                 snapshot_every: int = 256, enabled: bool = True):
        self._lock = threading.Lock()
        self._app_dir = app_dir
        self._enabled = enabled
        self._path = journal_path(app_dir)
        self._snapshot_path = snapshot_path(app_dir)
        self._am_attempt = am_attempt
        self._snapshot_every = max(0, int(snapshot_every))
        self._seq = 0                    # guarded-by: _lock
        self._since_snapshot = 0         # guarded-by: _lock
        self._file = None                # guarded-by: _lock
        self._state = RecoveredState()   # guarded-by: _lock
        self._state.am_attempt = am_attempt

    @property
    def path(self) -> str:
        return self._path

    def seed(self, state: RecoveredState) -> None:
        """Adopt a replayed state as the compaction baseline (recovering
        attempt) and snapshot it immediately so the journal restarts
        from a clean prefix."""
        if not self._enabled:
            return
        with self._lock:
            self._state = state
            self._seq = state.replayed_records
            self._snapshot_now()

    def append(self, rtype: str, **fields: Any) -> None:
        if not self._enabled:
            return
        rec = dict(fields)
        rec["type"] = rtype
        rec["ts_ms"] = int(time.time() * 1000)
        rec["am_attempt"] = self._am_attempt
        try:
            with self._lock:
                self._seq += 1
                rec["seq"] = self._seq
                if self._file is None:
                    self._file = open(self._path, "a", encoding="utf-8")
                self._file.write(json.dumps(rec, sort_keys=True) + "\n")
                self._file.flush()
                os.fsync(self._file.fileno())
                self._state.apply(rec)
                self._since_snapshot += 1
                if (self._snapshot_every
                        and self._since_snapshot >= self._snapshot_every):
                    self._snapshot_now()
        except Exception as exc:  # never let journaling take the AM down
            log.warning("journal append failed (%s record): %s", rtype, exc)

    def _snapshot_now(self) -> None:  # holds: _lock
        """Compact: snapshot the accumulated state tmp+rename, then
        truncate the incremental journal. Crash ordering is safe either
        way — before the rename the old snapshot + full journal replay;
        after it the new snapshot alone carries everything."""
        write_json_atomic(self._snapshot_path, self._state.to_dict())
        if self._file is not None:
            self._file.close()
        self._file = open(self._path, "w", encoding="utf-8")
        self._file.flush()
        os.fsync(self._file.fileno())
        self._since_snapshot = 0

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def discard(self) -> None:
        """Remove journal artifacts (application reached a terminal
        state through the normal lifecycle — nothing left to recover)."""
        self.close()
        for p in (self._path, self._snapshot_path):
            try:
                os.remove(p)
            except OSError:
                pass


def replay(app_dir: str) -> RecoveredState:
    """Load snapshot + incremental journal into a RecoveredState.

    Tolerates: missing files (fresh start), a torn final line (crash
    mid-append), and unknown record types. A malformed line aborts the
    incremental scan at that point — everything before it is kept,
    matching the fsync ordering guarantee that only the tail can tear.
    """
    state = RecoveredState()
    snap = snapshot_path(app_dir)
    if os.path.exists(snap):
        try:
            with open(snap, "r", encoding="utf-8") as fh:
                state = RecoveredState.from_dict(json.load(fh))
        except (OSError, ValueError) as exc:
            log.warning("journal snapshot unreadable, replaying journal "
                        "only: %s", exc)
            state = RecoveredState()
    jpath = journal_path(app_dir)
    if os.path.exists(jpath):
        try:
            with open(jpath, "r", encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        log.warning("journal torn tail dropped: %r",
                                    line[:80])
                        break
                    state.apply(rec)
        except OSError as exc:
            log.warning("journal unreadable: %s", exc)
    return state


def has_journal(app_dir: str) -> bool:
    return (os.path.exists(journal_path(app_dir))
            or os.path.exists(snapshot_path(app_dir)))
