"""Performance truth of a port trainer: the goodput ledger, MFU and the
on-demand profile capture.

The port's copy of the task-side half of `tony_tpu/observability/perf.py`:
- `GoodputLedger`: every wall-clock second of the task lands in exactly
  one exclusive phase (init, compile, train_step, input_stall,
  checkpoint_save/restore, eval, idle, and the executor's localization
  and rendezvous_wait handed over in ``TONY_GOODPUT_SEED``). Transitions
  happen only at existing boundaries, so the hot loop gains no device
  sync; sum(phases) == wall by construction. Pushed to the AM as the
  ``GOODPUT_<PHASE>_SECONDS`` gauges under the JAX package's names.
- `mfu_pct` over the card's dense bf16 peak (`tony_tpu_torch.device`).
- `ProfileCapture`: the trainer's half of the ``request_profile``
  workflow. The executor writes ``profile_request.json`` into the task's
  cwd; at a log boundary the trainer starts `torch.profiler` for N
  steps, writes its Chrome trace into ``profiles/<request_id>/`` and
  publishes ``{request_id, path, num_steps, duration_ms}`` (the JAX
  payload's keys) through the metrics RPC. The profiler server on the
  task's ``TB_PORT`` (`profiler_server.py`) writes the same request file
  and reads the capture's state.
The AM's half: `aggregate_goodput` folds the tasks' ledgers into the job's
``goodput.json``, and `SloWatchdog` latches step-time regressions and a
goodput floor over the AM's trajectories.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from typing import Callable, Optional

LOG = logging.getLogger(__name__)

# exclusive phases; `input_stall` is carved out of `train_step`
PHASES = (
    "init", "localization", "rendezvous_wait", "compile", "train_step",
    "input_stall", "checkpoint_save", "checkpoint_restore", "eval",
    "relaunch_downtime", "resize", "idle",
)

GOODPUT_METRIC_PREFIX = "GOODPUT_"
GOODPUT_WALL_METRIC = "GOODPUT_WALL_SECONDS"
# the phases that count as productive in the job's goodput
PRODUCTIVE_PHASES = ("train_step",)


def goodput_metric_name(phase: str) -> str:
    return f"{GOODPUT_METRIC_PREFIX}{phase.upper()}_SECONDS"


def mfu_pct(tokens_per_sec: float, flops_per_token: float,
            device=None, peak: float = 0.0) -> float:
    """Model FLOPs utilization in percent: achieved training FLOP/s over
    the card's dense bf16 peak (`peak`, else that of the torch `device`;
    0 for the CPU or a card not in the table)."""
    if not peak and device is not None:
        from tony_tpu_torch.device import peak_flops
        peak = peak_flops(device)
    if peak <= 0 or flops_per_token <= 0:
        return 0.0
    return 100.0 * tokens_per_sec * flops_per_token / peak


def tokens_in_batch(batch) -> int:
    """B * S of a batch's 'inputs' or 'tokens' (0 when not token-like);
    reads shapes only, so never syncs the device."""
    if not isinstance(batch, dict):
        return 0
    for key in ("inputs", "tokens"):
        shape = getattr(batch.get(key), "shape", None)
        if shape and len(shape) >= 2:
            return int(shape[0]) * int(shape[1])
    return 0


class GoodputLedger:
    """Exclusive-phase wall-clock accounting for one task process.

    Exactly one phase is open; `transition` closes it and opens the next,
    `carve` moves seconds of one phase to another without touching the
    timeline. The snapshot includes the open phase's elapsed time, so
    sum(phases) == wall_s at any moment. Thread-safe (the metrics pusher
    reads it from its worker)."""

    def __init__(self, phase: str = "init",
                 clock: Callable[[], float] = time.monotonic,
                 seed: Optional[dict] = None):
        self._clock = clock
        self._t0 = clock()
        self._phase = phase
        self._phase_start = self._t0
        self._acc: dict[str, float] = {p: 0.0 for p in PHASES}
        self._acc.setdefault(phase, 0.0)
        # phases the executor already accounted for this task slot:
        # closed durations that extend this ledger's wall clock
        self._seed_total = 0.0
        for p, v in (seed or {}).items():
            v = max(0.0, float(v))
            self._acc[str(p)] = self._acc.get(str(p), 0.0) + v
            self._seed_total += v
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env, phase: str = "init") -> "GoodputLedger":
        """A ledger seeded with ``TONY_GOODPUT_SEED`` (none: bare)."""
        from tony_tpu_torch import constants as C
        seed = None
        raw = env.get(C.TONY_GOODPUT_SEED, "")
        if raw:
            try:
                parsed = json.loads(raw)
                if isinstance(parsed, dict):
                    seed = {str(k): float(v) for k, v in parsed.items()
                            if isinstance(v, (int, float))}
            except (ValueError, TypeError):
                seed = None
        return cls(phase=phase, seed=seed)

    @property
    def phase(self) -> str:
        return self._phase

    def transition(self, phase: str) -> None:
        """Close the open phase and open `phase` (the same phase: folds
        the elapsed segment in)."""
        now = self._clock()
        with self._lock:
            self._acc[self._phase] = self._acc.get(self._phase, 0.0) + (
                now - self._phase_start)
            self._phase = phase
            self._phase_start = now
            self._acc.setdefault(phase, 0.0)

    def carve(self, phase: str, seconds: float,
              source: Optional[str] = None) -> None:
        """Move `seconds` from `source` (default: the open phase) to
        `phase`; the wall-clock sum is kept."""
        if seconds <= 0:
            return
        with self._lock:
            src = source if source is not None else self._phase
            self._acc[phase] = self._acc.get(phase, 0.0) + seconds
            self._acc[src] = self._acc.get(src, 0.0) - seconds

    def snapshot(self) -> dict:
        """{"phases": {phase: seconds}, "wall_s": seconds}."""
        now = self._clock()
        with self._lock:
            phases = dict(self._acc)
            phases[self._phase] = phases.get(self._phase, 0.0) + (
                now - self._phase_start)
            wall = (now - self._t0) + self._seed_total
        return {"phases": phases, "wall_s": wall}

    def metrics(self) -> list[dict]:
        """GOODPUT_<PHASE>_SECONDS and GOODPUT_WALL_SECONDS metric dicts."""
        snap = self.snapshot()
        out = [{"name": goodput_metric_name(p), "value": round(v, 4)}
               for p, v in sorted(snap["phases"].items())]
        out.append({"name": GOODPUT_WALL_METRIC,
                    "value": round(snap["wall_s"], 4)})
        return out


# ---------------------------------------------------------------------------
# the AM side: the job's goodput and the SLO watchdog
# ---------------------------------------------------------------------------

def parse_goodput_gauges(gauges: dict[str, float]) -> Optional[dict]:
    """Invert `GoodputLedger.metrics()` from a task's latest-gauge map:
    -> {"phases": {...}, "wall_s": ...}, or None when the task never
    pushed a ledger."""
    phases: dict[str, float] = {}
    wall = None
    for name, value in gauges.items():
        if name == GOODPUT_WALL_METRIC:
            wall = float(value)
        elif (name.startswith(GOODPUT_METRIC_PREFIX)
              and name.endswith("_SECONDS")):
            phase = name[len(GOODPUT_METRIC_PREFIX):-len("_SECONDS")].lower()
            phases[phase] = float(value)
    if wall is None and not phases:
        return None
    return {"phases": phases,
            "wall_s": wall if wall is not None else sum(phases.values())}


def aggregate_goodput(per_task_gauges: dict[str, dict[str, float]],
                      relaunch_downtime_s: float = 0.0,
                      preemption_downtime_s: float = 0.0,
                      resize_downtime_s: float = 0.0,
                      am_downtime_s: float = 0.0) -> dict:
    """Fold per-task ledgers + AM-side relaunch downtime into the job
    view flushed as `goodput.json`:

    {"tasks": {task_id: {"phases", "wall_s", "mfu_pct"?,
                         "tokens_per_sec_per_chip"?}},
     "job": {"goodput_pct", "productive_s", "wall_s",
             "relaunch_downtime_s", "preemption_downtime_s",
             "resize_downtime_s", "am_downtime_s"}}

    goodput_pct = productive train-step seconds / (summed task wall +
    relaunch downtime + preemption downtime + resize downtime + AM
    downtime) — downtime the fault-tolerance layer spent between
    attempts, the eviction→resume gap a checkpoint-then-evict
    preemption cost this job's lineage, the quiesce→re-rendezvous gap
    of every elastic resize (the `resize` phase), and the control-plane
    blackout of an AM crash→adoption-barrier recovery (the
    `am_downtime` phase), all count AGAINST goodput even though no
    task process existed (or no AM was listening) to observe them."""
    tasks: dict[str, dict] = {}
    productive = 0.0
    wall_total = 0.0
    for task_id, gauges in sorted(per_task_gauges.items()):
        ledger = parse_goodput_gauges(gauges)
        if ledger is None:
            continue
        entry = dict(ledger)
        for gauge, key in (("TRAIN_MFU_PCT", "mfu_pct"),
                           ("TRAIN_TOKENS_PER_SEC_PER_CHIP",
                            "tokens_per_sec_per_chip")):
            if gauge in gauges:
                entry[key] = float(gauges[gauge])
        tasks[task_id] = entry
        wall_total += entry["wall_s"]
        productive += sum(entry["phases"].get(p, 0.0)
                          for p in PRODUCTIVE_PHASES)
    denom = wall_total + max(0.0, relaunch_downtime_s) \
        + max(0.0, preemption_downtime_s) + max(0.0, resize_downtime_s) \
        + max(0.0, am_downtime_s)
    return {
        "tasks": tasks,
        "job": {
            "goodput_pct": round(100.0 * productive / denom, 3)
            if denom > 0 else 0.0,
            "productive_s": round(productive, 4),
            "wall_s": round(denom, 4),
            "relaunch_downtime_s": round(max(0.0, relaunch_downtime_s), 4),
            "preemption_downtime_s": round(
                max(0.0, preemption_downtime_s), 4),
            "resize_downtime_s": round(max(0.0, resize_downtime_s), 4),
            "am_downtime_s": round(max(0.0, am_downtime_s), 4),
        },
    }


# ---------------------------------------------------------------------------
# SLO watchdog (AM-side)
# ---------------------------------------------------------------------------

class SloWatchdog:
    """Latched SLO checks over the AM's metric trajectories.

    - step-time regression: a task's latest TRAIN_STEP_TIME_MS exceeds
      its own baseline (median of the first samples **of its current
      attempt**) by more than `step_regression_pct` percent. The
      baseline is attempt-aware: a task relaunch (attempt bump) resets
      the baseline window to the new attempt's own samples, so a
      replacement's recompile steps become the new baseline instead of
      tripping the latch against the dead attempt's steady state;
    - goodput floor: job goodput_pct below `goodput_floor_pct`.

    `check()` returns only NEWLY-entered violations (the AM emits one
    WARNING history event per entry); the latch re-arms when the
    condition recovers. `current_step_regressions()` exposes the raw
    currently-violating set without the latch — the alert engine's
    step-regression rule reads that and runs its own lifecycle.
    Thresholds <= 0 disable the respective check."""

    BASELINE_POINTS = 5
    MIN_POINTS = 3

    def __init__(self, step_regression_pct: float = 0.0,
                 goodput_floor_pct: float = 0.0):
        self.step_regression_pct = step_regression_pct
        self.goodput_floor_pct = goodput_floor_pct
        self._latched: set[str] = set()
        # task_id -> (attempt the baseline belongs to, boundary
        # timestamp: samples at or before it belong to dead attempts).
        # A TIMESTAMP, not an index — the TimeSeries behind the series
        # decimates in place when full, so an absolute index would
        # drift (or point past the end forever) after a halving; the
        # boundary survives decimation because surviving points keep
        # their timestamps.
        self._baseline_marks: dict[str, tuple[int, int]] = {}

    @staticmethod
    def _median(values: list[float]) -> float:
        ordered = sorted(values)
        return ordered[len(ordered) // 2]

    def _baseline_boundary(self, task_id: str, attempt: int,
                           points: list) -> int:
        """Timestamp before which samples are excluded from the current
        attempt's baseline window. First sighting of a slot keeps the
        whole series; an attempt bump cuts at the series tail (the
        trajectories survive a relaunch, so the dead attempt's points
        must stay out of the new baseline) while keeping the newest
        point — the push that announced the new attempt; monitor
        cadence is at least as fast as the push cadence, so at most one
        new-attempt point predates the bump being observed."""
        mark = self._baseline_marks.get(task_id)
        if mark is not None and mark[0] == attempt:
            return mark[1]
        boundary = -1
        if mark is not None and len(points) >= 2:
            boundary = int(points[-2][0])
        self._baseline_marks[task_id] = (attempt, boundary)
        # the old attempt's latched violation (if any) describes a task
        # that no longer exists — re-arm
        self._latched.discard(f"step_time:{task_id}")
        return boundary

    def current_step_regressions(
            self, step_series: dict[str, list],
            attempts: Optional[dict[str, int]] = None) -> list[dict]:
        """The CURRENTLY-violating tasks (no latch): {"kind",
        "task_id", "value", "threshold", "message"} dicts. `attempts`
        maps task_id -> its latest attempt number (the MetricsStore's
        per-slot attempt tracking); absent entries read as attempt 0."""
        if self.step_regression_pct <= 0:
            return []
        attempts = attempts or {}
        out: list[dict] = []
        for task_id, points in sorted(step_series.items()):
            points = [p for p in points
                      if isinstance(p, (list, tuple)) and len(p) == 2]
            attempt = int(attempts.get(task_id, 0) or 0)
            boundary = self._baseline_boundary(task_id, attempt, points)
            values = [float(v) for ts, v in points if ts > boundary]
            if len(values) < max(self.MIN_POINTS,
                                 self.BASELINE_POINTS // 2 + 1):
                continue
            baseline = self._median(values[:self.BASELINE_POINTS])
            latest = values[-1]
            threshold = baseline * (1.0 + self.step_regression_pct
                                    / 100.0)
            if baseline > 0 and latest > threshold:
                out.append({
                    "kind": "step_time_regression",
                    "task_id": task_id,
                    "value": round(latest, 3),
                    "threshold": round(threshold, 3),
                    "message": (
                        f"step time {latest:.1f} ms exceeds baseline "
                        f"{baseline:.1f} ms (attempt {attempt}) by more "
                        f"than {self.step_regression_pct:.0f}%"),
                })
        return out

    def check(self, step_series: dict[str, list],
              goodput_pct: Optional[float] = None,
              attempts: Optional[dict[str, int]] = None) -> list[dict]:
        """`step_series`: {task_id: [[ts_ms, step_ms], ...]} (the
        MetricsStore's TRAIN_STEP_TIME_MS trajectories). Returns newly
        entered violations as {"kind", "task_id"?, "value",
        "threshold", "message"} dicts."""
        fresh: list[dict] = []
        seen: set[str] = set()
        for violation in self.current_step_regressions(step_series,
                                                       attempts=attempts):
            key = f"step_time:{violation['task_id']}"
            seen.add(key)
            if key not in self._latched:
                self._latched.add(key)
                fresh.append(violation)
        if self.goodput_floor_pct > 0 and goodput_pct is not None:
            key = "goodput_floor"
            if goodput_pct < self.goodput_floor_pct:
                seen.add(key)
                if key not in self._latched:
                    self._latched.add(key)
                    fresh.append({
                        "kind": "goodput_floor",
                        "value": round(goodput_pct, 3),
                        "threshold": self.goodput_floor_pct,
                        "message": (
                            f"job goodput {goodput_pct:.1f}% below the "
                            f"{self.goodput_floor_pct:.0f}% floor"),
                    })
        # re-arm every latch whose condition recovered this check
        self._latched &= seen
        return fresh

    def active(self) -> list[str]:
        """Currently-latched violation keys (alert gauge source)."""
        return sorted(self._latched)


def new_profile_request_id() -> str:
    return uuid.uuid4().hex[:12]


class _TorchTrace:
    """torch.profiler over the host and the card (CUDA activity when the
    card is present); `stop` writes its Chrome trace into the capture
    directory."""

    def __init__(self):
        self._prof = None
        self._dir = ""

    def start(self, out_dir: str) -> None:
        import torch
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._dir = out_dir
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(self._dir, "trace.json"))


class ProfileCapture:
    """The trainer's half of the ``request_profile`` workflow.

    `poll()` at log boundaries (a file read, never a device sync) starts
    a capture for an unseen request id; `on_step()` after each step
    counts it down, stops it and publishes the artifact. A request id
    seen once never restarts a trace, and its file is removed so a
    relaunched trainer does not replay it. `finished` maps each capture
    written to its directory, `failed` holds the ids that could not start
    or stop. `start_fn`/`stop_fn` replace torch.profiler (tests)."""

    def __init__(self, cwd: str = ".",
                 publish: Optional[Callable[[dict], None]] = None,
                 start_fn: Optional[Callable[[str], None]] = None,
                 stop_fn: Optional[Callable[[], None]] = None):
        from tony_tpu_torch import constants as C
        self._request_path = os.path.join(cwd, C.PROFILE_REQUEST_FILE)
        self._profiles_dir = os.path.join(cwd, C.PROFILES_DIR_NAME)
        self._publish = publish
        if start_fn is None or stop_fn is None:
            trace = _TorchTrace()
            start_fn, stop_fn = trace.start, trace.stop
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._seen: set[str] = set()
        self._active: Optional[dict] = None
        self.finished: dict[str, str] = {}
        self.failed: set[str] = set()

    @property
    def active(self) -> bool:
        return self._active is not None

    @property
    def active_request(self) -> Optional[str]:
        active = self._active
        return None if active is None else active["request_id"]

    @property
    def request_path(self) -> str:
        return self._request_path

    def poll(self) -> None:
        """Start a capture if the request file names an unseen id."""
        if self._active is not None:
            return
        try:
            with open(self._request_path, "r", encoding="utf-8") as f:
                req = json.load(f)
        except (OSError, ValueError):
            return
        rid = str(req.get("request_id", "") or "")
        if not rid:
            return
        if rid in self._seen:
            self._remove_request_file()
            return
        self._seen.add(rid)
        steps = max(1, int(req.get("num_steps", 1) or 1))
        out_dir = os.path.join(self._profiles_dir, rid)
        try:
            os.makedirs(out_dir, exist_ok=True)
            self._start_fn(out_dir)
        except Exception:  # noqa: BLE001 — profiling never kills training
            LOG.exception("could not start profiler trace for request %s",
                          rid)
            self.failed.add(rid)
            return
        LOG.info("profiler capture %s started (%d steps) -> %s", rid,
                 steps, out_dir)
        self._active = {"request_id": rid, "remaining": steps,
                        "num_steps": steps, "dir": out_dir,
                        "t0": time.monotonic()}

    def on_step(self) -> None:
        """Count one finished step; stop and publish when spent."""
        active = self._active
        if active is None:
            return
        active["remaining"] -= 1
        if active["remaining"] > 0:
            return
        self._active = None
        self._remove_request_file()
        try:
            self._stop_fn()
        except Exception:  # noqa: BLE001
            LOG.exception("profiler stop failed for request %s",
                          active["request_id"])
            self.failed.add(active["request_id"])
            return
        self.finished[active["request_id"]] = active["dir"]
        duration_ms = int(1000 * (time.monotonic() - active["t0"]))
        LOG.info("profiler capture %s finished after %d steps (%d ms)",
                 active["request_id"], active["num_steps"], duration_ms)
        if self._publish is not None:
            try:
                self._publish({
                    "request_id": active["request_id"],
                    "path": os.path.abspath(active["dir"]),
                    "num_steps": active["num_steps"],
                    "duration_ms": duration_ms,
                })
            except Exception:  # noqa: BLE001
                LOG.exception("profile publish failed")

    def _remove_request_file(self) -> None:
        try:
            os.remove(self._request_path)
        except OSError:
            pass
