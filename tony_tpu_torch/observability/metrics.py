"""Timeseries ring buffers + the process-local health-metric registry.

The port's copy of `tony_tpu/observability/metrics.py`: the same
summary geometry and Prometheus families, so the AM's and the serving
frontend's `/metrics` read exactly as the JAX package's.

``TimeSeries`` is the MetricsStore extension: each merged gauge appends
into one of these, turning last-write gauges into trajectories
(step-time, tokens/sec, HBM, TTFT over the run) at bounded memory —
when the buffer fills it compacts by dropping every other point and
doubling its stride, so a week-long run still covers its whole lifetime
at progressively coarser resolution instead of only remembering the
last N minutes.

``MetricsRegistry`` is the orchestrator-observes-itself surface: RPC
client/server call latency and retry/failure counters, heartbeat lag,
liveliness sweep/detection latency, prefetch stall seconds, metrics-push
drop counts. One module-level ``REGISTRY`` per process; the AM exposes
its own over ``/metrics``, the serving frontend over ``/v1/metrics``.
Mutation cost is a dict hit + a locked float add — safe for per-batch
call sites (the prefetch stall counter), and nothing here ever blocks
on I/O.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Union

Number = Union[int, float]


class TimeSeries:
    """Bounded (ts_ms, value) series with stride-doubling downsample."""

    def __init__(self, max_points: int = 512):
        # floor of 4 keeps compaction meaningful (2 would thrash) and
        # guarantees the ">= 2 points per gauge" portal contract
        self.max_points = max(4, int(max_points))
        self.stride = 1          # keep every stride-th offered sample
        self._offered = 0
        self._latest: Optional[tuple[int, float]] = None
        self._points: list[tuple[int, float]] = []
        self._lock = threading.Lock()

    def append(self, ts_ms: int, value: float) -> None:
        v = float(value)
        if math.isnan(v) or math.isinf(v):
            return                      # a trajectory of NaNs plots nothing
        with self._lock:
            self._latest = (int(ts_ms), v)
            if self._offered % self.stride == 0:
                self._points.append((int(ts_ms), v))
                if len(self._points) >= self.max_points:
                    # halve resolution, double the decimation: the series
                    # keeps covering the whole run at bounded memory
                    self._points = self._points[::2]
                    self.stride *= 2
            self._offered += 1

    def to_list(self) -> list[list[Number]]:
        with self._lock:
            out = [[ts, v] for ts, v in self._points]
            # the tail is always current even mid-decimation: a scrape
            # between kept samples still sees the newest value
            if self._latest is not None and (
                    not out or list(self._latest) != out[-1]):
                out.append(list(self._latest))
        return out

    def __len__(self) -> int:
        return len(self.to_list())


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    __slots__ = ("name", "labels", "_lock")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = {str(k): str(v) for k, v in labels.items()}
        self._lock = threading.Lock()


class Counter(_Metric):
    __slots__ = ("value",)

    def __init__(self, name: str, labels: dict):
        super().__init__(name, labels)
        self.value = 0.0

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self.value += n


class Gauge(_Metric):
    __slots__ = ("value",)

    def __init__(self, name: str, labels: dict):
        super().__init__(name, labels)
        self.value = 0.0

    def set(self, v: Number) -> None:
        with self._lock:
            self.value = float(v)


class Summary(_Metric):
    """count/sum/max plus bounded p50/p95/p99 via a fixed-width
    log-bucketed sketch (observability/skew.QuantileSketch — 34 counter
    cells per summary, never a sample list). Exposed as
    _count/_sum/_max samples and quantile-labeled gauges; observe() cost
    is one lock + a handful of float ops, safe on the per-RPC paths."""

    __slots__ = ("count", "sum", "max", "sketch")

    # latencies arrive in seconds; the shared ms-domain sketch geometry
    # would round microsecond RPCs into its underflow cell, so summaries
    # get their own domain (1 µs .. ~28 h, 32 buckets -> ~±20%/bucket)
    SKETCH_BUCKETS = 32
    SKETCH_LO = 1e-6
    SKETCH_HI = 1e5

    def __init__(self, name: str, labels: dict):
        super().__init__(name, labels)
        from tony_tpu_torch.observability.skew import QuantileSketch
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self.sketch = QuantileSketch(buckets=self.SKETCH_BUCKETS,
                                     lo=self.SKETCH_LO, hi=self.SKETCH_HI)

    def observe(self, v: Number) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v > self.max:
                self.max = v
            self.sketch.add(v)

    def quantile(self, q: float) -> float:
        with self._lock:
            return self.sketch.quantile(q)


class MetricsRegistry:
    """Create-on-first-use registry of counters/gauges/summaries keyed by
    (name, labels). Rendered to Prometheus families or a JSON snapshot."""

    def __init__(self):
        self._metrics: dict[tuple, _Metric] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict):
        key = (name, _label_key(labels))
        # lock-free fast path: after first creation every caller hits this
        # read; dict get on an existing key is safe under the GIL and the
        # slow path below re-checks under the lock
        # tony: disable=guarded-by -- double-checked create-on-first-use
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, labels)
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def summary(self, name: str, **labels) -> Summary:
        return self._get(Summary, name, labels)

    def clear(self) -> None:
        """Test isolation only."""
        with self._lock:
            self._metrics.clear()

    def families(self) -> list[dict]:
        """Prometheus families (see observability.prometheus.render):
        summaries expand into _count/_sum/_max samples."""
        with self._lock:
            metrics = list(self._metrics.values())
        by_name: dict[str, dict] = {}

        def fam(name: str, ftype: str) -> dict:
            return by_name.setdefault(
                name, {"name": name, "type": ftype, "help": "", "samples": []})

        for m in sorted(metrics, key=lambda x: (x.name,
                                                sorted(x.labels.items()))):
            if isinstance(m, Counter):
                fam(m.name, "counter")["samples"].append((m.labels, m.value))
            elif isinstance(m, Gauge):
                fam(m.name, "gauge")["samples"].append((m.labels, m.value))
            elif isinstance(m, Summary):
                fam(m.name + "_count", "counter")["samples"].append(
                    (m.labels, float(m.count)))
                fam(m.name + "_sum", "counter")["samples"].append(
                    (m.labels, m.sum))
                fam(m.name + "_max", "gauge")["samples"].append(
                    (m.labels, m.max))
                if m.count:
                    # Prometheus summary convention: the base family
                    # carries quantile-labeled samples
                    for q in (0.5, 0.95, 0.99):
                        fam(m.name, "gauge")["samples"].append(
                            ({**m.labels, "quantile": str(q)},
                             m.quantile(q)))
        return [by_name[k] for k in sorted(by_name)]

    def snapshot(self) -> dict:
        """Flat JSON view (diagnostics + tests): name{labels} -> value."""
        out: dict[str, float] = {}
        for f in self.families():
            for labels, value in f["samples"]:
                suffix = ("{" + ",".join(f"{k}={v}" for k, v in
                                         sorted(labels.items())) + "}"
                          if labels else "")
                out[f["name"] + suffix] = value
        return out


# the per-process registry every subsystem registers into
REGISTRY = MetricsRegistry()
