"""Heartbeat liveliness monitor (sharded).

The port's copy of `tony_tpu/am/liveliness.py`.

Equivalent of the reference's use of YARN's AbstractLivelinessMonitor
(ApplicationMaster.java:183-208): tasks ping on every heartbeat RPC; a
monitor thread sweeps registered tasks and fires an expiry callback for any
task whose last ping is older than `hb_interval * max(3, max_missed)` —
the reference's exact expiry formula (ApplicationMaster.java:197-204).

Unlike the reference — where onTaskDeemedDead ended the application — the
expiry callback now feeds the AM's task-relaunch decision first
(ApplicationMaster._on_task_deemed_dead → _maybe_relaunch_task): within the
attempt budget the dead task's container is replaced and the gang
re-rendezvouses; only an exhausted budget escalates to session failure. The
expired entry is dropped before the callback fires, so the replacement
attempt re-registers under the same task id with a clean slate.

Sharding (the width-1k rebuild): with one lock over one dict, every 1 s
ping from every task contended with the full-table expiry scan — at width
1024 the sweep held the lock for an O(width) pass while 1k pings/s queued
behind it. Entries are now hashed across N shards, each with its own lock,
and the sweep thread touches ONE shard per tick (tick = sweep_period /
shards), so per-entry examination cadence — and therefore detection
latency — is unchanged from the unsharded monitor while any single lock
hold is O(width / shards) and contends with only 1/N of pings.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from tony_tpu_torch.observability.metrics import REGISTRY

LOG = logging.getLogger(__name__)


def auto_liveliness_shards(width: int) -> int:
    """Width-aware default for tony.am.liveliness-shards: one shard per
    ~64 tasks, capped at 16 (width 1024 → 16 shards; small test gangs
    keep the unsharded single-lock behavior)."""
    return max(1, min(16, int(width) // 64))


class LivelinessMonitor:
    def __init__(self, hb_interval_ms: int, max_missed: int,
                 on_expired: Callable[[str, int], None],
                 shards: int = 1):
        self._hb_interval_sec = hb_interval_ms / 1000.0
        self._expiry_sec = hb_interval_ms * max(3, max_missed) / 1000.0
        # sweep frequently relative to the expiry window so detection latency
        # stays a fraction of the window even with test-scale intervals
        self._sweep_sec = max(0.05, min(1.0, self._expiry_sec / 10))
        self.num_shards = max(1, int(shards))
        # one shard is examined per tick; a full rotation covers every
        # entry once per _sweep_sec — same cadence as the unsharded sweep
        self._tick_sec = self._sweep_sec / self.num_shards
        self._on_expired = on_expired
        # observability (docs/FAULT_TOLERANCE.md failure matrix numbers):
        # heartbeat round-trip lag = inter-ping gap minus the nominal
        # cadence (network + AM queueing + executor scheduling jitter);
        # detection latency = silence start (last ping) → expiry sweep.
        # Kept as attributes AND pushed into the health registry.
        self.last_ping_lag_sec: Optional[float] = None
        self.last_detection_latency_sec: Optional[float] = None
        # per-task lag consumer (the AM wires the skew tracker in):
        # called OUTSIDE the monitor lock as lag_sink(task_id, lag_sec) —
        # heartbeat lag is one of the cross-task straggler signals
        self.lag_sink: Optional[Callable[[str, float], None]] = None
        # per shard: task_id -> (last ping, attempt the entry belongs to).
        # The expiry callback reports WHICH attempt went silent, so a
        # stale expiry racing a relaunch can be fenced instead of judging
        # the healthy replacement by the dead attempt's silence.
        # guarded-by: _locks
        self._shards: list[dict[str, tuple[float, int]]] = [
            {} for _ in range(self.num_shards)]
        self._locks = [threading.Lock() for _ in range(self.num_shards)]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="hb-monitor",
                                        daemon=True)

    def _shard_of(self, task_id: str) -> int:
        # stable within the process; cross-process stability is not needed
        return hash(task_id) % self.num_shards

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2)

    def register(self, task_id: str, attempt: int = 0) -> None:
        """Plant (or refresh) a task's liveliness entry. Attempt-monotonic:
        a stalled registration thread of a superseded attempt re-planting
        after the replacement registered must not downgrade the entry's
        attempt — a downgraded attempt would make the replacement's real
        expiry look stale and be fenced off forever."""
        idx = self._shard_of(task_id)
        with self._locks[idx]:
            entry = self._shards[idx].get(task_id)
            if entry is not None and entry[1] > attempt:
                LOG.warning("ignoring stale registration of %s attempt %d "
                            "(entry is at attempt %d)", task_id, attempt,
                            entry[1])
                return
            self._shards[idx][task_id] = (time.monotonic(), attempt)

    def unregister(self, task_id: str) -> None:
        """Must be called when an executor registers its result, BEFORE the
        container-completion callback arrives — otherwise a task that exited
        cleanly but whose completion notification is delayed would be deemed
        dead (reference rationale: ApplicationMaster.java:890-902)."""
        idx = self._shard_of(task_id)
        with self._locks[idx]:
            self._shards[idx].pop(task_id, None)

    def ping(self, task_id: str) -> bool:
        """Refresh a registered task's liveness; returns False for unknown
        ids (never resurrects an expired/unregistered entry — a zombie
        attempt pinging after its slot was relaunched must stay dead).
        Records the ping's lag beyond the nominal heartbeat cadence —
        the AM-side view of heartbeat round-trip + scheduling delay.
        Touches only this task's shard lock: a ping never waits behind
        an expiry scan of the other shards."""
        now = time.monotonic()
        idx = self._shard_of(task_id)
        with self._locks[idx]:
            entry = self._shards[idx].get(task_id)
            if entry is not None:
                lag = max(0.0, (now - entry[0]) - self._hb_interval_sec)
                self.last_ping_lag_sec = lag
                self._shards[idx][task_id] = (now, entry[1])
            else:
                return False
        REGISTRY.summary("tony_heartbeat_lag_seconds").observe(lag)
        sink = self.lag_sink
        if sink is not None:
            try:
                sink(task_id, lag)
            except Exception:  # noqa: BLE001 — skew must never break pings
                LOG.debug("heartbeat lag sink failed", exc_info=True)
        return True

    def registered(self, task_id: str) -> bool:
        idx = self._shard_of(task_id)
        with self._locks[idx]:
            return task_id in self._shards[idx]

    def entry(self, task_id: str) -> Optional[tuple[float, int]]:
        """(last ping, attempt) for a registered task, else None —
        introspection for tests and the control-plane bench."""
        idx = self._shard_of(task_id)
        with self._locks[idx]:
            return self._shards[idx].get(task_id)

    def __len__(self) -> int:
        # per-shard locks: a concurrent register/expiry resizing a shard
        # dict mid-iteration raced this unlocked sum (caught by tonylint's
        # guarded-by pass)
        total = 0
        for idx in range(self.num_shards):
            with self._locks[idx]:
                total += len(self._shards[idx])
        return total

    def clear(self) -> None:
        for idx in range(self.num_shards):
            with self._locks[idx]:
                self._shards[idx].clear()

    def _run(self) -> None:
        # stall-watchdog beacon: a wedged sweep loop means silent tasks
        # are never expired — exactly the wedge the watchdog must name
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon("liveliness-sweep", self._tick_sec)
        last_tick = time.monotonic()
        shard_idx = 0
        while not self._stop.wait(self._tick_sec):
            beacon.beat()
            now = time.monotonic()
            # sweep lag: how far past the nominal cadence this tick ran
            # (a loaded AM sweeping late ADDS to every detection latency)
            REGISTRY.gauge("tony_liveliness_sweep_lag_seconds").set(
                max(0.0, (now - last_tick) - self._tick_sec))
            last_tick = now
            idx = shard_idx
            shard_idx = (shard_idx + 1) % self.num_shards
            with self._locks[idx]:
                shard = self._shards[idx]
                expired = [(tid, attempt, now - last)
                           for tid, (last, attempt) in shard.items()
                           if now - last > self._expiry_sec]
                for tid, _, _ in expired:
                    del shard[tid]
            for tid, attempt, silence in expired:
                # detection latency: last ping → this sweep. Lower bound
                # is the expiry window (interval * max(3, max_missed));
                # the excess over it is sweep-cadence + load-induced lag.
                self.last_detection_latency_sec = silence
                REGISTRY.summary(
                    "tony_liveliness_detection_latency_seconds").observe(
                    silence)
                LOG.error("task %s (attempt %d) missed heartbeats for %.1fs "
                          "— expired (detection latency %.2fs over a %.1fs "
                          "window)", tid, attempt, self._expiry_sec, silence,
                          self._expiry_sec)
                try:
                    self._on_expired(tid, attempt)
                except Exception:  # noqa: BLE001
                    LOG.exception("expiry callback failed for %s", tid)
        beacon.idle()
