"""Cross-task skew analytics: width-bounded sketches + straggler detection.

The port's copy of `tony_tpu/observability/skew.py`.

Synchronous SPMD means one lagging host sets the step time for the whole
gang — at widths of 48 → 1024 tasks the AM must answer
*which* task is dragging without itself melting. The metric stores keep
per-task trajectories (O(width × points)); this module is the
O(buckets)-per-window alternative the skew surfaces read from:

- **QuantileSketch**: a fixed-width log-bucketed streaming quantile
  sketch. Memory is ``buckets + 2`` counters regardless of how many
  samples (or tasks) fold into it — the gang-wide step-time distribution
  at width 1024 costs exactly what it costs at width 8. Relative
  quantile error is bounded by the bucket ratio (~±8% at 96 buckets over
  the 0.1 ms – 10^7 ms domain).
- **SkewTracker**: windowed cross-task state for a fixed signal set
  (step time, input stall, heartbeat lag — steady-state; localization /
  compile — startup). Per window it keeps ONE gang sketch per signal
  plus O(1) scalars (count/sum/max) per reporting task; closed windows
  retain only per-task means (the heatmap cell) in a bounded deque.
  Nothing here ever stores a per-task sample list.
- **StragglerAnalyzer**: the decision layer the AM runs on its
  monitor-loop cadence. A task whose windowed mean exceeds the gang
  median by ``threshold_pct`` for ``windows`` consecutive windows
  latches as a straggler; goodput-ledger startup phases (localization /
  compile) separate startup skew from steady-state lag; evidence
  (z-score, gang median, consecutive windows) travels with the latched
  record. Opt-in remediation: a steady-state straggler that persists
  ``relaunch_after_windows`` windows is nominated for the
  task-attempt relaunch machinery.

Stdlib only: the AM must never grow a heavy dependency for
observability.
"""

from __future__ import annotations

import math
import statistics
import threading
import time
from collections import deque
from typing import Optional

# ---------------------------------------------------------------------------
# fixed-width streaming quantile sketch
# ---------------------------------------------------------------------------

# value domain of every signal (milliseconds): 0.1 ms .. ~3 hours. Samples
# outside land in the under/overflow cells — counted, never lost.
SKETCH_LO_MS = 0.1
SKETCH_HI_MS = 1e7
DEFAULT_BUCKETS = 96


class QuantileSketch:
    """Log-bucketed streaming quantiles at fixed memory.

    ``buckets`` log-spaced cells over [lo, hi) plus an underflow and an
    overflow cell; `add` is two float ops + an int index, `quantile`
    walks the cumulative counts and interpolates geometrically inside
    the hit bucket. count/sum/sumsq ride along so mean/std (the z-score
    denominator) need no second pass."""

    __slots__ = ("buckets", "lo", "hi", "_log_lo", "_scale", "_counts",
                 "count", "total", "sumsq", "vmin", "vmax")

    def __init__(self, buckets: int = DEFAULT_BUCKETS,
                 lo: float = SKETCH_LO_MS, hi: float = SKETCH_HI_MS):
        self.buckets = max(8, int(buckets))
        self.lo = float(lo)
        self.hi = float(hi)
        self._log_lo = math.log(self.lo)
        self._scale = self.buckets / (math.log(self.hi) - self._log_lo)
        # [underflow] + buckets + [overflow] — the whole memory footprint
        self._counts = [0] * (self.buckets + 2)
        self.count = 0
        self.total = 0.0
        self.sumsq = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _index(self, value: float) -> int:
        if value < self.lo:
            return 0
        if value >= self.hi:
            return self.buckets + 1
        return 1 + int((math.log(value) - self._log_lo) * self._scale)

    def add(self, value: float, n: int = 1) -> None:
        v = float(value)
        if math.isnan(v) or math.isinf(v) or n <= 0:
            return
        v = max(0.0, v)
        self._counts[self._index(v)] += n
        self.count += n
        self.total += v * n
        self.sumsq += v * v * n
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def merge(self, other: "QuantileSketch") -> None:
        if other.buckets != self.buckets or other.lo != self.lo \
                or other.hi != self.hi:
            raise ValueError("sketch geometry mismatch")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.count += other.count
        self.total += other.total
        self.sumsq += other.sumsq
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        var = self.sumsq / self.count - self.mean ** 2
        return math.sqrt(max(0.0, var))

    def _bucket_edges(self, i: int) -> tuple[float, float]:
        """[lo, hi) of interior bucket i (1-based interior index)."""
        a = math.exp(self._log_lo + (i - 1) / self._scale)
        b = math.exp(self._log_lo + i / self._scale)
        return a, b

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0 <= q <= 1); 0.0 on an empty sketch.
        Interior hits interpolate geometrically inside the bucket; the
        under/overflow cells answer with the observed min/max."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0.0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if seen + c >= target:
                if i == 0:
                    return max(0.0, self.vmin)
                if i == self.buckets + 1:
                    return self.vmax
                a, b = self._bucket_edges(i)
                frac = (target - seen) / c
                # geometric interpolation matches the log spacing
                est = a * (b / a) ** max(0.0, min(1.0, frac))
                # never report outside the observed range
                return max(self.vmin, min(self.vmax, est))
            seen += c
        return self.vmax

    def quantiles(self, qs=(0.5, 0.95, 0.99)) -> dict[str, float]:
        return {f"p{int(q * 100)}": round(self.quantile(q), 3) for q in qs}

    def cells(self) -> int:
        """Memory footprint in counter cells — the bench's O(buckets)
        assertion reads this; it never depends on sample or task count."""
        return len(self._counts)

    def summary(self) -> dict:
        out = self.quantiles()
        out.update({"count": self.count, "mean": round(self.mean, 3),
                    "std": round(self.std, 3),
                    "min": round(self.vmin, 3) if self.count else 0.0,
                    "max": round(self.vmax, 3) if self.count else 0.0})
        return out


# ---------------------------------------------------------------------------
# windowed cross-task tracker
# ---------------------------------------------------------------------------

# signals folded per window (steady-state lag evidence)
STEADY_SIGNALS = ("step_time_ms", "input_stall_ms", "heartbeat_lag_ms")
# once-per-attempt signals (startup-skew evidence, goodput-ledger phases)
STARTUP_SIGNALS = ("localization_ms", "compile_ms")
# the signals detection actually drives on (heartbeat lag is evidence
# in the bundle, not a latch trigger — scheduling jitter would flap it)
DETECTION_SIGNALS = ("step_time_ms", "input_stall_ms")

# AM metric name -> (signal, unit scale to ms, cumulative?). Cumulative
# gauges (the goodput ledger's *_SECONDS counters) fold per-window DELTAS;
# startup signals keep the latest value per task instead of windowing.
# heartbeat_lag_ms has NO metric mapping on purpose: its sole source is
# the liveliness monitor's lag_sink calling observe() directly — a
# mapping here would double-fold the signal if a reporter ever pushed a
# gauge under that name.
WATCHED_METRICS = {
    "TRAIN_STEP_TIME_MS": ("step_time_ms", 1.0, False),
    "GOODPUT_INPUT_STALL_SECONDS": ("input_stall_ms", 1000.0, True),
    "GOODPUT_LOCALIZATION_SECONDS": ("localization_ms", 1000.0, True),
    "GOODPUT_COMPILE_SECONDS": ("compile_ms", 1000.0, True),
}


class _TaskWin:
    """O(1) per-task per-window accumulator — deliberately NOT a sample
    list; at width 1k this is three floats per reporting task."""

    __slots__ = ("count", "total", "vmax")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class SkewTracker:
    """Windowed distribution state for the fixed signal set.

    `observe_metric` is the MetricsStore's skew sink (every numeric gauge
    passes through; non-watched names are one dict miss). `maybe_roll`
    closes the open window on the AM's monitor cadence and returns the
    closed per-signal snapshot for the analyzer. Closed windows keep one
    float per reporting task (the heatmap cell) in a deque bounded by
    `heatmap_windows`; the gang distribution of every closed window
    survives only as its sketch summary dict."""

    def __init__(self, buckets: int = DEFAULT_BUCKETS,
                 heatmap_windows: int = 32,
                 clock=time.monotonic):
        self._buckets = max(8, int(buckets))
        self._heatmap_windows = max(2, int(heatmap_windows))
        self._clock = clock
        self._lock = threading.Lock()
        # None = the window opens at the first observation. The injected
        # clock (monotonic) governs window AGING only; the timestamps
        # recorded into closed windows are epoch ms so skew.json lines up
        # with events/spans/detections on one time base.
        self._window_open_ms: Optional[float] = None
        self._window_open_epoch_ms = 0.0
        # open window: signal -> gang sketch / per-task accumulators
        self._sketch: dict[str, QuantileSketch] = {}
        self._win: dict[str, dict[str, _TaskWin]] = {}
        # cumulative-gauge last values: (signal, task_id) -> last raw ms
        self._cum_last: dict[tuple[str, str], float] = {}
        # startup signals: signal -> {task_id: latest ms}
        self._startup: dict[str, dict[str, float]] = {
            s: {} for s in STARTUP_SIGNALS}
        # closed windows: signal -> deque of
        # {"start_ms","end_ms","gang": sketch summary, "tasks": {tid: mean}}
        self._closed: dict[str, deque] = {
            s: deque(maxlen=self._heatmap_windows) for s in STEADY_SIGNALS}

    # -- ingestion -----------------------------------------------------
    def observe_metric(self, task_id: str, name: str, value: float) -> None:
        """MetricsStore sink: fold one pushed gauge. Unwatched names are
        a single dict miss — safe on every metrics push at width 1k."""
        watched = WATCHED_METRICS.get(name)
        if watched is None:
            return
        signal, scale, cumulative = watched
        self.observe(task_id, signal, float(value) * scale,
                     cumulative=cumulative)

    def observe(self, task_id: str, signal: str, value_ms: float,
                cumulative: bool = False) -> None:
        if not math.isfinite(value_ms):
            # NaN/±inf must never reach the per-task accumulators — one
            # -inf mean would drag the gang median and falsely latch
            # every healthy peer
            return
        with self._lock:
            if signal in self._startup:
                # startup phases converge to a final value; keep latest
                self._startup[signal][task_id] = max(0.0, value_ms)
                return
            if signal not in STEADY_SIGNALS:
                return
            if cumulative:
                key = (signal, task_id)
                last = self._cum_last.get(key, 0.0)
                self._cum_last[key] = value_ms
                # a relaunch resets the counter — treat decrease as a
                # fresh epoch rather than a negative delta
                value_ms = max(0.0, value_ms - last) if value_ms >= last \
                    else value_ms
            if self._window_open_ms is None:
                self._window_open_ms = self._clock() * 1000.0
                self._window_open_epoch_ms = time.time() * 1000.0
            sk = self._sketch.get(signal)
            if sk is None:
                sk = self._sketch[signal] = QuantileSketch(self._buckets)
            sk.add(value_ms)
            per_task = self._win.setdefault(signal, {})
            tw = per_task.get(task_id)
            if tw is None:
                tw = per_task[task_id] = _TaskWin()
            tw.add(value_ms)

    # -- windowing -----------------------------------------------------
    def maybe_roll(self, window_ms: float,
                   force: bool = False) -> Optional[dict]:
        """Close the open window if it is older than `window_ms` (or
        `force`). Returns {signal: closed-window dict} or None when the
        window is still open / empty."""
        now_ms = self._clock() * 1000.0
        with self._lock:
            if not self._sketch:
                return None
            if not force and (self._window_open_ms is None
                              or now_ms - self._window_open_ms < window_ms):
                return None
            closed: dict[str, dict] = {}
            end_epoch_ms = time.time() * 1000.0
            for signal, sk in self._sketch.items():
                entry = {
                    "start_ms": round(self._window_open_epoch_ms
                                      or end_epoch_ms, 1),
                    "end_ms": round(end_epoch_ms, 1),
                    "gang": sk.summary(),
                    "tasks": {tid: round(tw.mean, 3)
                              for tid, tw in
                              self._win.get(signal, {}).items()},
                }
                closed[signal] = entry
                self._closed[signal].append(entry)
            self._sketch.clear()
            self._win.clear()
            self._window_open_ms = None
            return closed

    def clear_task(self, task_id: str) -> None:
        """Drop one slot's skew state (the slot was relaunched: the
        replacement attempt must be judged from a clean slate)."""
        with self._lock:
            for per_task in self._win.values():
                per_task.pop(task_id, None)
            for values in self._startup.values():
                values.pop(task_id, None)
            for signal in STEADY_SIGNALS:
                self._cum_last.pop((signal, task_id), None)

    def startup_values(self) -> dict[str, dict[str, float]]:
        """{signal: {task_id: ms}} for the startup phases."""
        with self._lock:
            return {s: dict(v) for s, v in self._startup.items()}

    # -- accounting (bench O(buckets) assertion) -----------------------
    def sketch_cells(self) -> int:
        """Total sketch counter cells currently held — bounded by
        len(STEADY_SIGNALS) * (buckets + 2) no matter the gang width."""
        with self._lock:
            return sum(sk.cells() for sk in self._sketch.values())

    def max_sketch_cells(self) -> int:
        """The width-independent ceiling `sketch_cells` can ever reach."""
        return len(STEADY_SIGNALS) * (self._buckets + 2)

    def per_task_cells(self) -> int:
        """Scalar cells retained per live state: open-window accumulators
        (3 per reporting task per signal) + heatmap means (1 per task per
        closed window) + startup scalars. The bench divides by task count
        to assert the per-task constant."""
        with self._lock:
            open_cells = sum(3 * len(p) for p in self._win.values())
            closed_cells = sum(len(e["tasks"]) for d in self._closed.values()
                               for e in d)
            startup_cells = sum(len(v) for v in self._startup.values())
            return open_cells + closed_cells + startup_cells

    # -- surfaces ------------------------------------------------------
    def heatmap(self, signal: str = "step_time_ms") -> dict:
        """tasks × windows matrix for the portal panel: window end
        timestamps + one row per task (None where the task didn't report
        in that window)."""
        with self._lock:
            windows = list(self._closed.get(signal, ()))
        ends = [w["end_ms"] for w in windows]
        tasks = sorted({tid for w in windows for tid in w["tasks"]})
        rows = {tid: [w["tasks"].get(tid) for w in windows]
                for tid in tasks}
        return {"signal": signal, "window_ends_ms": ends, "tasks": rows}

    def bundle(self, analyzer: Optional["StragglerAnalyzer"] = None) -> dict:
        """The skew.json / get_skew RPC shape: latest gang summaries per
        signal, the step-time heatmap, startup values, and the analyzer's
        latched stragglers + detection log."""
        with self._lock:
            signals = {
                s: {"windows": [
                    {"start_ms": w["start_ms"], "end_ms": w["end_ms"],
                     "gang": w["gang"]}
                    for w in d]}
                for s, d in self._closed.items() if d}
        out = {
            "generated_ms": int(time.time() * 1000),
            "signals": signals,
            "heatmap": self.heatmap("step_time_ms"),
            "startup": self.startup_values(),
        }
        if analyzer is not None:
            out["stragglers"] = analyzer.active()
            out["detections"] = analyzer.log()
        return out


# ---------------------------------------------------------------------------
# straggler analyzer
# ---------------------------------------------------------------------------

class _TaskState:
    __slots__ = ("lag_windows", "clear_windows", "latched", "signal",
                 "phase", "value_ms", "gang_median_ms", "z_score",
                 "latched_windows")

    def __init__(self):
        self.lag_windows = 0
        self.clear_windows = 0
        self.latched = False
        self.signal = ""
        self.phase = ""
        self.value_ms = 0.0
        self.gang_median_ms = 0.0
        self.z_score = 0.0
        # the lagging streak as of the last latch (or its last growth
        # while latched) — a recovered clear reports THIS, since the
        # healthy windows leading up to it zeroed lag_windows
        self.latched_windows = 0


class StragglerAnalyzer:
    """Latched cross-task lag detection over closed windows.

    A task is *lagging* in a window when its windowed mean exceeds the
    gang median of per-task means by more than `threshold_pct` percent
    AND by more than `min_excess_ms` absolute (so a 0.1 ms jitter over a
    ~0 median never counts). `windows` consecutive lagging windows latch
    a STRAGGLER_DETECTED; `windows` consecutive healthy windows (or a
    relaunch) clear it. Detection needs at least `min_tasks` reporting
    tasks — a gang of two has no meaningful median.

    Startup skew: once `min_tasks` tasks have reported their
    localization+compile totals, a task whose total exceeds the gang
    median by the same threshold latches with phase="startup" — it is a
    one-shot condition (the phase cannot recur), cleared by healthy
    steady-state windows.

    `analyze` returns the actions the AM turns into history events:
    {"action": "detected"|"cleared", ...evidence}. Remediation
    nomination (`remediate` list) fires for steady-state stragglers
    lagging >= `relaunch_after_windows` windows (0 disables)."""

    MAX_LOG = 256

    def __init__(self, threshold_pct: float = 50.0, windows: int = 3,
                 min_tasks: int = 3, relaunch_after_windows: int = 0,
                 min_excess_ms: float = 50.0,
                 startup_min_excess_ms: float = 1000.0):
        self.threshold_pct = float(threshold_pct)
        self.windows = max(1, int(windows))
        self.min_tasks = max(2, int(min_tasks))
        self.relaunch_after_windows = max(0, int(relaunch_after_windows))
        self.min_excess_ms = float(min_excess_ms)
        # startup phases jitter by tens of ms even on a healthy gang
        # (filesystem, fork timing); real startup skew — a task stuck
        # localizing or compiling — is seconds to minutes, so the
        # absolute floor is much higher than the per-window one
        self.startup_min_excess_ms = float(startup_min_excess_ms)
        self._tasks: dict[str, _TaskState] = {}
        self._startup_flagged: set[str] = set()
        self._log: deque = deque(maxlen=self.MAX_LOG)
        self._lock = threading.Lock()

    def _gang_stats(self, values: list[float]
                    ) -> tuple[float, float, float, float]:
        """(median, mean, population std, lagging threshold) of one
        gang's per-task values — the ONE lagging criterion both the
        steady-state and the startup pass judge against."""
        median = statistics.median(values)
        mean = statistics.fmean(values)
        std = statistics.pstdev(values, mu=mean)
        return median, mean, std, median * (1.0 + self.threshold_pct
                                            / 100.0)

    def _lag_of(self, closed: dict) -> dict[str, tuple[str, float, float,
                                                       float]]:
        """{task_id: (signal, value, gang_median, z)} for tasks lagging in
        this closed window, taking the worst signal per task."""
        lagging: dict[str, tuple[str, float, float, float]] = {}
        for signal in DETECTION_SIGNALS:
            entry = closed.get(signal)
            if entry is None:
                continue
            means = entry["tasks"]
            if len(means) < self.min_tasks:
                continue
            median, mean, std, threshold = self._gang_stats(
                list(means.values()))
            for tid, v in means.items():
                if v <= threshold or v - median <= self.min_excess_ms:
                    continue
                z = (v - mean) / std if std > 1e-9 else 99.0
                z = min(z, 99.0)
                prev = lagging.get(tid)
                # worst = largest relative excess over its gang median
                if prev is None or (v / max(median, 1e-9)
                                    > prev[1] / max(prev[2], 1e-9)):
                    lagging[tid] = (signal, v, median, z)
        return lagging

    def _reported(self, closed: dict) -> set[str]:
        """Tasks that reported in a JUDGEABLE detection window — one with
        at least min_tasks reporters. A window the gang shrank below
        min_tasks (peers completing) can neither latch nor clear: a
        still-slow latched straggler must not be auto-'recovered' just
        because its healthy peers finished and took the median with
        them."""
        out: set[str] = set()
        for signal in DETECTION_SIGNALS:
            tasks = (closed.get(signal) or {}).get("tasks", {})
            if len(tasks) >= self.min_tasks:
                out.update(tasks)
        return out

    def analyze(self, closed: dict,
                startup: Optional[dict[str, dict[str, float]]] = None
                ) -> tuple[list[dict], list[dict]]:
        """One pass over a closed window set. Returns (actions,
        remediate): history-event actions and the steady-state latched
        stragglers nominated for relaunch."""
        actions: list[dict] = []
        remediate: list[dict] = []
        lagging = self._lag_of(closed)
        reported = self._reported(closed)
        with self._lock:
            for tid in reported | set(lagging):
                st = self._tasks.get(tid)
                if st is None:
                    st = self._tasks[tid] = _TaskState()
                hit = lagging.get(tid)
                if hit is not None:
                    st.lag_windows += 1
                    if st.lag_windows > st.latched_windows:
                        st.latched_windows = st.lag_windows
                    st.clear_windows = 0
                    st.signal, st.value_ms, st.gang_median_ms, st.z_score \
                        = hit[0], hit[1], hit[2], hit[3]
                elif tid in reported:
                    st.lag_windows = 0
                    st.clear_windows += 1
                if (not st.latched and hit is not None
                        and st.lag_windows >= self.windows):
                    st.latched = True
                    st.phase = "steady_state"
                    actions.append(self._action("detected", tid, st))
                elif (st.latched and hit is None and tid in reported
                      and st.clear_windows >= self.windows):
                    actions.append(self._action(
                        "cleared", tid, st, reason="recovered"))
                    self._unlatch(tid, st)
                if (st.latched and st.phase == "steady_state"
                        and self.relaunch_after_windows > 0
                        and st.lag_windows >= self.relaunch_after_windows):
                    remediate.append(self._action("remediate", tid, st))
            actions.extend(self._startup_pass(startup or {}))
        return actions, remediate

    def _startup_pass(self, startup: dict) -> list[dict]:
        """Startup skew (caller holds the lock): compare each task's
        localization+compile total against the gang median once enough
        tasks reported. One-shot per task."""
        totals: dict[str, float] = {}
        for signal in STARTUP_SIGNALS:
            for tid, v in (startup.get(signal) or {}).items():
                totals[tid] = totals.get(tid, 0.0) + v
        if len(totals) < self.min_tasks:
            return []
        median, mean, std, threshold = self._gang_stats(
            list(totals.values()))
        actions = []
        for tid, v in totals.items():
            if (v <= threshold or v - median <= self.startup_min_excess_ms
                    or tid in self._startup_flagged):
                continue
            self._startup_flagged.add(tid)
            st = self._tasks.get(tid)
            if st is None:
                st = self._tasks[tid] = _TaskState()
            if st.latched:
                continue    # steady-state latch already tells the story
            st.latched = True
            st.phase = "startup"
            st.signal = "startup_ms"
            st.value_ms, st.gang_median_ms = v, median
            st.z_score = min((v - mean) / std if std > 1e-9 else 99.0, 99.0)
            actions.append(self._action("detected", tid, st))
        return actions

    def _action(self, action: str, task_id: str, st: _TaskState,
                reason: str = "") -> dict:
        out = {
            "action": action, "task_id": task_id, "signal": st.signal,
            "phase": st.phase, "value_ms": round(st.value_ms, 3),
            "gang_median_ms": round(st.gang_median_ms, 3),
            "z_score": round(st.z_score, 2),
            # a recovered clear arrives with lag_windows already zeroed
            # by the healthy windows — report the latched streak instead
            "windows": max(st.lag_windows, st.latched_windows),
            "ts_ms": int(time.time() * 1000),
        }
        if reason:
            out["reason"] = reason
        if action in ("detected", "cleared"):
            self._log.append(out)
        return out

    def _unlatch(self, task_id: str, st: _TaskState) -> None:
        """Release the latch but KEEP the startup one-shot flag: a task
        whose startup skew was detected and later recovered (healthy
        steady-state windows) must not re-detect from the same unchanged
        startup totals every clear cycle. Only a relaunch
        (clear_task) re-arms startup detection — the
        replacement attempt localizes and compiles afresh."""
        st.latched = False
        st.lag_windows = 0
        st.clear_windows = 0
        st.latched_windows = 0

    def clear_task(self, task_id: str,
                   reason: str = "relaunched") -> Optional[dict]:
        """Unlatch + reset one slot (the AM relaunched it). Returns the
        cleared action (for the STRAGGLER_CLEARED event) when the task
        was latched, else None."""
        with self._lock:
            self._startup_flagged.discard(task_id)
            st = self._tasks.get(task_id)
            if st is None:
                return None
            was_latched = st.latched
            action = (self._action("cleared", task_id, st, reason=reason)
                      if was_latched else None)
            self._unlatch(task_id, st)
            del self._tasks[task_id]
            return action

    def active(self) -> list[dict]:
        """Currently latched stragglers with their evidence."""
        with self._lock:
            return [
                {"task_id": tid, "signal": st.signal, "phase": st.phase,
                 "value_ms": round(st.value_ms, 3),
                 "gang_median_ms": round(st.gang_median_ms, 3),
                 "z_score": round(st.z_score, 2),
                 # a latched task mid-recovery has lag_windows zeroed by
                 # its healthy windows — report the latched streak
                 "windows": max(st.lag_windows, st.latched_windows)}
                for tid, st in sorted(self._tasks.items()) if st.latched]

    def log(self) -> list[dict]:
        """Bounded detected/cleared action history (bundle surface)."""
        with self._lock:
            return list(self._log)
