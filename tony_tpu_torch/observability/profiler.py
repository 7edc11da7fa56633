"""The always-on sampling profiler and stall watchdog of a port process.

The port's copy of `tony_tpu/observability/profiler.py`, installed by the
AM, train and serve entry points as the JAX package's are:
- ``SamplingProfiler``: a daemon thread walking ``sys._current_frames()``
  at ``tony.profiler.hz`` (jittered ±25%), folding samples into a bounded
  collapsed-stack table. It measures its own cost and exports
  ``tony_profiler_overhead_pct`` against ``tony.profiler.overhead-budget-
  pct``; past the budget it halves its own cadence.
- ``StallWatchdog`` + ``Beacon``: each daemon loop (the engine's stepper,
  the metrics pusher) beats a beacon per iteration and marks itself
  ``idle()`` before it blocks on work; an active beacon stale past
  ``tony.profiler.stall-factor`` x its cadence is a stall: an all-thread
  stack capture, one PROCESS_STALL_DETECTED / _CLEARED pair and
  ``tony_stalls_total``.
- ``enable_crash_dumps``: faulthandler, and an all-thread dump on SIGUSR2.
  The AM hands the watchdog its event sink, so its stalls land in the job
  history, and flushes the profile as ``profile.folded`` at finish.

On a card the decode loop is host-bound, so the sampler competes with the
launch loop for the GIL; its self-measured overhead is what
``chip_smoke.py``'s orch phase prints.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import random
import signal
import sys
import threading
import time
from typing import Callable, Iterable, Optional

from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.observability.logs import redact
from tony_tpu_torch.observability.metrics import REGISTRY

LOG = logging.getLogger(__name__)

DEFAULT_HZ = 19.0               # prime-ish so it never beats with 1 s loops
DEFAULT_MAX_STACKS = 2000
DEFAULT_STALL_FACTOR = 4.0
OVERHEAD_BUDGET_PCT = 1.0       # the hard self-overhead ceiling
MAX_FRAME_DEPTH = 48
OTHER_KEY = "(other)"

# event names the watchdog hands its sink; the AM adapter maps them onto
# events.schema.EventType values (profiler stays import-free of events/)
STALL_DETECTED = "PROCESS_STALL_DETECTED"
STALL_CLEARED = "PROCESS_STALL_CLEARED"

# the profiler's own machinery, excluded from wedge attribution
_SELF_THREADS = ("tony-profiler", "tony-stall-watchdog")


class FoldTable:
    """Bounded collapsed-stack histogram: folded stack -> sample count.

    Overflow beyond ``max_stacks`` distinct stacks folds into an
    ``(other)`` bucket and is counted in ``dropped`` — memory stays
    capped no matter how polymorphic the workload's stacks are, and the
    flamegraph discloses exactly how much weight the cap ate.
    """

    def __init__(self, max_stacks: int = DEFAULT_MAX_STACKS):
        self.max_stacks = max(1, int(max_stacks))
        self._counts: dict[str, int] = {}   # guarded-by: _lock
        self.dropped = 0                    # guarded-by: _lock
        self._lock = threading.Lock()

    def add(self, stack: str, n: int = 1) -> None:
        with self._lock:
            cur = self._counts.get(stack)
            if cur is not None:
                self._counts[stack] = cur + n
            elif len(self._counts) < self.max_stacks:
                self._counts[stack] = n
            else:
                self._counts[OTHER_KEY] = self._counts.get(OTHER_KEY, 0) + n
                self.dropped += n

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def folded(self) -> str:
        """flamegraph.pl-compatible ``stack count`` lines, hottest first."""
        snap = self.snapshot()
        lines = [f"{stack} {count}" for stack, count in
                 sorted(snap.items(), key=lambda kv: (-kv[1], kv[0]))]
        return "\n".join(lines) + ("\n" if lines else "")

    def __len__(self) -> int:
        with self._lock:
            return len(self._counts)


def _frame_label(frame) -> str:
    code = frame.f_code
    mod = os.path.splitext(os.path.basename(code.co_filename))[0]
    return f"{mod}.{code.co_name}"


def fold_frames(frame, depth: int = MAX_FRAME_DEPTH) -> list[str]:
    """Root-first ``module.function`` labels for one thread's stack.

    The cap keeps the LEAF-most ``depth`` frames — for a wedge the leaf
    (where the thread actually blocks) is the frame that matters.
    """
    leaf_first = []
    while frame is not None and len(leaf_first) < depth:
        leaf_first.append(_frame_label(frame))
        frame = frame.f_back
    leaf_first.reverse()
    return leaf_first


def collect_thread_stacks(
        redactor: Optional[Callable[[str], str]] = redact) -> list[dict]:
    """All-thread snapshot: [{name, ident, daemon, frames}] with frames
    LEAF-first as ``file.py:line:function`` strings.

    Stacks cross process boundaries (executor -> AM -> diagnostics.json
    -> portal), so every string is redacted on the way out by default;
    pass ``redactor=None`` only for same-process consumption.
    """
    names = {t.ident: (t.name, t.daemon) for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        name, daemon = names.get(ident, (f"thread-{ident}", True))
        frames = []
        f = frame
        while f is not None and len(frames) < MAX_FRAME_DEPTH:
            code = f.f_code
            frames.append(f"{os.path.basename(code.co_filename)}:"
                          f"{f.f_lineno}:{code.co_name}")
            f = f.f_back
        if redactor is not None:
            name = redactor(str(name))
            frames = [redactor(fr) for fr in frames]
        out.append({"name": str(name), "ident": int(ident),
                    "daemon": bool(daemon), "frames": frames})
    out.sort(key=lambda t: t["name"])
    return out


def dominant_frame(threads: Iterable[dict], ident: int = 0) -> str:
    """The frame most likely to be the wedge: the named thread's leaf
    frame when ``ident`` matches, else MainThread's, else the first
    non-profiler thread's."""
    candidates = [t for t in threads if t.get("frames")]
    if not candidates:
        return ""
    if ident:
        for t in candidates:
            if t.get("ident") == ident:
                return str(t["frames"][0])
    for t in candidates:
        if t.get("name") == "MainThread":
            return str(t["frames"][0])
    for t in candidates:
        if t.get("name") not in _SELF_THREADS:
            return str(t["frames"][0])
    return str(candidates[0]["frames"][0])


class SamplingProfiler(threading.Thread):
    """Daemon sampling profiler with a self-overhead budget.

    Every sample's cost is accumulated against wall time; the ratio is
    exported as ``tony_profiler_overhead_pct`` and, past the budget, the
    profiler throttles its own cadence (doubling its interval, counted
    in ``tony_profiler_throttle_total``) — the observer never becomes
    the workload.
    """

    def __init__(self, process_name: str, hz: float = DEFAULT_HZ,
                 max_stacks: int = DEFAULT_MAX_STACKS,
                 overhead_budget_pct: float = OVERHEAD_BUDGET_PCT,
                 rng: Optional[random.Random] = None):
        super().__init__(name="tony-profiler", daemon=True)
        self.process_name = str(process_name)
        self.hz = min(250.0, max(0.1, float(hz)))
        self.budget_pct = float(overhead_budget_pct)
        self.table = FoldTable(max_stacks)
        self.samples = 0                      # guarded-by: _lock
        self._cost_s = 0.0                    # guarded-by: _lock
        self._throttle = 1.0                  # guarded-by: _lock
        self._started_s = time.monotonic()
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        self._rng = rng if rng is not None else random.Random()

    # -- sampling ---------------------------------------------------------
    def _interval(self) -> float:
        with self._lock:
            throttle = self._throttle
        # +/-25% jitter: never phase-lock with the loops being observed
        return (throttle / self.hz) * self._rng.uniform(0.75, 1.25)

    def sample_once(self) -> None:
        t0 = time.perf_counter()
        names = {t.ident: t.name for t in threading.enumerate()}
        own = threading.get_ident()
        for ident, frame in sys._current_frames().items():
            if ident == own:
                continue        # our own walk is cost, not workload
            labels = fold_frames(frame)
            if not labels:
                continue
            tname = names.get(ident, f"thread-{ident}")
            self.table.add(";".join([str(tname)] + labels))
        cost = time.perf_counter() - t0
        with self._lock:
            self.samples += 1
            self._cost_s += cost
            pct = self._overhead_pct_locked()
            if (self.samples >= 8 and pct > self.budget_pct
                    and self._throttle < 32.0):
                self._throttle *= 2.0
                REGISTRY.counter("tony_profiler_throttle_total",
                                 process=self.process_name).inc()
        REGISTRY.gauge("tony_profiler_overhead_pct",
                       process=self.process_name).set(pct)

    def _overhead_pct_locked(self) -> float:  # holds: _lock
        wall = max(1e-9, time.monotonic() - self._started_s)
        return 100.0 * self._cost_s / wall

    def overhead_pct(self) -> float:
        with self._lock:
            return self._overhead_pct_locked()

    # the observer cannot watch itself: this thread is excluded from
    # sampling and from staleness checks
    # tony: disable=watchdog-beacon -- the profiler is the observer
    def run(self) -> None:
        while not self._stop_evt.wait(self._interval()):
            try:
                self.sample_once()
            except Exception:   # a sampling hiccup must never kill the thread
                LOG.debug("profiler sample failed", exc_info=True)

    def stop(self, join_timeout_sec: float = 2.0) -> None:
        self._stop_evt.set()
        if self.is_alive():
            self.join(timeout=join_timeout_sec)

    # -- export -----------------------------------------------------------
    def folded_text(self) -> str:
        return self.table.folded()

    def snapshot(self) -> dict:
        with self._lock:
            samples = self.samples
            pct = self._overhead_pct_locked()
            throttle = self._throttle
        return {
            "process": self.process_name,
            "hz": self.hz,
            "samples": samples,
            "overhead_pct": round(pct, 4),
            "overhead_budget_pct": self.budget_pct,
            "throttle": throttle,
            "distinct_stacks": len(self.table),
            "dropped_samples": self.table.dropped,
        }


class Beacon:
    """One daemon loop's progress heartbeat.

    ``beat()`` each iteration; ``idle()`` immediately before blocking on
    work arrival (an empty queue / long poll) so genuine idleness is
    exempt from staleness until the next beat. The watchdog treats an
    ACTIVE beacon older than factor x cadence as a wedge.
    """

    IDLE = "idle"
    ACTIVE = "active"

    def __init__(self, name: str, cadence_sec: float):
        self.name = str(name)
        self.cadence_sec = max(0.01, float(cadence_sec))
        self._lock = threading.Lock()
        self._state = Beacon.IDLE           # guarded-by: _lock
        self._last = time.monotonic()       # guarded-by: _lock
        self._ident = 0                     # guarded-by: _lock

    def beat(self) -> None:
        with self._lock:
            self._state = Beacon.ACTIVE
            self._last = time.monotonic()
            self._ident = threading.get_ident()

    def idle(self) -> None:
        with self._lock:
            self._state = Beacon.IDLE
            self._last = time.monotonic()

    def age_sec(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            return max(0.0, now - self._last)

    def ident(self) -> int:
        with self._lock:
            return self._ident

    def is_stale(self, factor: float, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            return (self._state == Beacon.ACTIVE
                    and (now - self._last) > float(factor) * self.cadence_sec)


# process-global beacon registry: loops register at setup, the (single)
# per-process watchdog sweeps whatever is registered
_BEACONS: dict[str, Beacon] = {}    # guarded-by: _BEACONS_LOCK
_BEACONS_LOCK = threading.Lock()


def register_beacon(name: str, cadence_sec: float) -> Beacon:
    """Register (or re-register, replacing) a loop's progress beacon."""
    beacon = Beacon(name, cadence_sec)
    with _BEACONS_LOCK:
        _BEACONS[name] = beacon
    return beacon


def beacons() -> list[Beacon]:
    with _BEACONS_LOCK:
        return list(_BEACONS.values())


def _reset_beacons() -> None:
    """Test isolation only."""
    with _BEACONS_LOCK:
        _BEACONS.clear()


class StallWatchdog(threading.Thread):
    """Sweeps the beacon registry; latches a stall event pair per wedge.

    On detection: an all-thread stack capture, the stale loop's own leaf
    frame as the dominant blocking evidence, ``tony_stalls_total``, and
    one STALL_DETECTED through the event sink. The latch clears (one
    STALL_CLEARED) when the beacon beats again — detect/clear pairs,
    never a detect storm.
    """

    def __init__(self, process_name: str,
                 stall_factor: float = DEFAULT_STALL_FACTOR,
                 poll_sec: float = 1.0,
                 event_sink: Optional[Callable[[str, dict], None]] = None):
        super().__init__(name="tony-stall-watchdog", daemon=True)
        self.process_name = str(process_name)
        self.stall_factor = max(1.0, float(stall_factor))
        self.poll_sec = max(0.05, float(poll_sec))
        self._sink = event_sink             # guarded-by: _lock
        self._stalled: dict[str, dict] = {}  # guarded-by: _lock
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()

    def set_event_sink(self, sink: Callable[[str, dict], None]) -> None:
        with self._lock:
            self._sink = sink

    def _emit(self, event: str, payload: dict) -> None:
        with self._lock:
            sink = self._sink
        if sink is not None:
            try:
                sink(event, payload)
            except Exception:
                LOG.warning("stall event sink failed", exc_info=True)
        else:
            LOG.warning("%s %s", event, payload)

    def stalled(self) -> dict[str, dict]:
        with self._lock:
            return dict(self._stalled)

    def check_once(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        for beacon in beacons():
            stale = beacon.is_stale(self.stall_factor, now)
            with self._lock:
                latched = beacon.name in self._stalled
            if stale and not latched:
                threads = collect_thread_stacks()
                frame = dominant_frame(threads, ident=beacon.ident())
                payload = {
                    "process": self.process_name,
                    "beacon": beacon.name,
                    "stalled_ms": round(beacon.age_sec(now) * 1000.0, 1),
                    "cadence_ms": round(beacon.cadence_sec * 1000.0, 1),
                    "blocking_frame": frame,
                    "thread_count": len(threads),
                }
                with self._lock:
                    self._stalled[beacon.name] = {
                        "since": now, "blocking_frame": frame}
                REGISTRY.counter("tony_stalls_total",
                                 process=self.process_name).inc()
                self._emit(STALL_DETECTED, payload)
            elif latched and not stale:
                with self._lock:
                    entry = self._stalled.pop(beacon.name, None)
                since = entry["since"] if entry else now
                self._emit(STALL_CLEARED, {
                    "process": self.process_name,
                    "beacon": beacon.name,
                    "stalled_ms": round((now - since) * 1000.0, 1),
                    "blocking_frame":
                        entry.get("blocking_frame", "") if entry else "",
                })

    # a beacon here would be judged by the very loop that beats it
    # tony: disable=watchdog-beacon -- the watchdog cannot watch itself
    def run(self) -> None:
        while not self._stop_evt.wait(self.poll_sec):
            try:
                self.check_once()
            except Exception:
                LOG.debug("watchdog sweep failed", exc_info=True)

    def stop(self, join_timeout_sec: float = 2.0) -> None:
        self._stop_evt.set()
        if self.is_alive():
            self.join(timeout=join_timeout_sec)


def enable_crash_dumps(*sigs: int) -> bool:
    """``faulthandler.enable()`` + an all-thread stack dump on each given
    signal. The port's ``__main__``s pass SIGUSR2 only (they own their
    SIGTERM handlers)."""
    ok = True
    try:
        faulthandler.enable()
    except (RuntimeError, ValueError, OSError):
        return False            # stderr unusable (tests with closed fds)
    for sig in sigs:
        try:
            faulthandler.register(sig, all_threads=True, chain=False)
        except (AttributeError, RuntimeError, ValueError, OSError):
            ok = False          # e.g. platforms without register()
    return ok


def install_task_observability(role: str, env=None) -> None:
    """The process-wide half of a port task's reports, installed by its
    ``__main__`` only (tests call `main` in-process): structured JSON
    logs and, as the frozen conf asks, the profiler and watchdog, named
    ``<role>:<job>:<index>``."""
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.conf import TonyConfiguration
    from tony_tpu_torch.observability.logs import (
        configure_structured_logging,
    )
    e = os.environ if env is None else env
    configure_structured_logging(e)
    install_process_profiler(
        f"{role}:{e.get(C.JOB_NAME, role)}"
        f":{e.get(C.TASK_INDEX, str(os.getpid()))}",
        conf=TonyConfiguration.from_env(e))


def install_process_profiler(
        process_name: str, conf=None,
        event_sink: Optional[Callable[[str, dict], None]] = None,
        crash_signals: tuple = (signal.SIGUSR2,),
) -> tuple[Optional[SamplingProfiler], Optional[StallWatchdog]]:
    """One-call wiring for a long-running control-plane process: crash
    dumps + sampling profiler + stall watchdog. Returns the pair (either
    None when ``tony.profiler.enabled`` is off)."""
    enable_crash_dumps(*crash_signals)
    enabled, hz = True, DEFAULT_HZ
    max_stacks, factor = DEFAULT_MAX_STACKS, DEFAULT_STALL_FACTOR
    budget = OVERHEAD_BUDGET_PCT
    if conf is not None:
        enabled = conf.get_bool(K.PROFILER_ENABLED, True)
        hz = conf.get_float(K.PROFILER_HZ, DEFAULT_HZ)
        max_stacks = conf.get_int(K.PROFILER_MAX_STACKS, DEFAULT_MAX_STACKS)
        factor = conf.get_float(K.PROFILER_STALL_FACTOR, DEFAULT_STALL_FACTOR)
        budget = conf.get_float(K.PROFILER_OVERHEAD_BUDGET_PCT,
                                OVERHEAD_BUDGET_PCT)
    if not enabled:
        return None, None
    profiler = SamplingProfiler(process_name, hz=hz, max_stacks=max_stacks,
                                overhead_budget_pct=budget)
    profiler.start()
    watchdog = StallWatchdog(process_name, stall_factor=factor,
                             event_sink=event_sink)
    watchdog.start()
    return profiler, watchdog
