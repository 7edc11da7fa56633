"""The process-local health registry (`REGISTRY`).

The port's copy of `MetricsRegistry` from `tony_tpu/observability/
metrics.py`: create-on-first-use counters, gauges and summaries keyed by
(name, labels), rendered as Prometheus families by the same rules (a
summary expands into _count/_sum/_max and quantile-labelled samples), so
the serving frontend's `/metrics` reads exactly as the JAX replica's. The
RPC client's per-call latency is a summary on the slice's path, so
`QuantileSketch` (from `tony_tpu/observability/skew.py`) comes along for
its quantiles.
"""

from __future__ import annotations

import math
import threading
from typing import Union

Number = Union[int, float]


class QuantileSketch:
    """Log-bucketed streaming quantiles at fixed memory: ``buckets``
    log-spaced cells over [lo, hi) plus an underflow and an overflow
    cell; `quantile` interpolates geometrically inside the hit bucket."""

    __slots__ = ("buckets", "lo", "hi", "_log_lo", "_scale", "_counts",
                 "count", "total", "vmin", "vmax")

    def __init__(self, buckets: int, lo: float, hi: float):
        self.buckets = max(8, int(buckets))
        self.lo = float(lo)
        self.hi = float(hi)
        self._log_lo = math.log(self.lo)
        self._scale = self.buckets / (math.log(self.hi) - self._log_lo)
        self._counts = [0] * (self.buckets + 2)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _index(self, value: float) -> int:
        if value < self.lo:
            return 0
        if value >= self.hi:
            return self.buckets + 1
        return 1 + int((math.log(value) - self._log_lo) * self._scale)

    def add(self, value: float) -> None:
        v = float(value)
        if math.isnan(v) or math.isinf(v):
            return
        v = max(0.0, v)
        self._counts[self._index(v)] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def quantile(self, q: float) -> float:
        """Approximate q-quantile; 0.0 on an empty sketch. The under- and
        overflow cells answer with the observed min and max."""
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
                a = math.exp(self._log_lo + (i - 1) / self._scale)
                b = math.exp(self._log_lo + i / self._scale)
                frac = (target - seen) / c
                est = a * (b / a) ** max(0.0, min(1.0, frac))
                return max(self.vmin, min(self.vmax, est))
            seen += c
        return self.vmax


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
    """count/sum/max plus p50/p95/p99 from a 32-bucket sketch over 1 µs
    .. 1e5 s (the JAX summary's geometry)."""

    __slots__ = ("count", "sum", "max", "sketch")

    SKETCH_BUCKETS = 32
    SKETCH_LO = 1e-6
    SKETCH_HI = 1e5

    def __init__(self, name: str, labels: dict):
        super().__init__(name, labels)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self.sketch = QuantileSketch(self.SKETCH_BUCKETS, self.SKETCH_LO,
                                     self.SKETCH_HI)

    def observe(self, v: Number) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.max = max(self.max, v)
            self.sketch.add(v)

    def quantile(self, q: float) -> float:
        with self._lock:
            return self.sketch.quantile(q)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Create-on-first-use registry of counters, gauges and summaries."""

    def __init__(self):
        self._metrics: dict[tuple, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)      # lock-free once created
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
        """Prometheus families (observability/prometheus.py `render`)."""
        with self._lock:
            metrics = list(self._metrics.values())
        by_name: dict[str, dict] = {}

        def fam(name: str, ftype: str) -> dict:
            return by_name.setdefault(
                name, {"name": name, "type": ftype, "help": "",
                       "samples": []})

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
                    for q in (0.5, 0.95, 0.99):
                        fam(m.name, "gauge")["samples"].append(
                            ({**m.labels, "quantile": str(q)},
                             m.quantile(q)))
        return [by_name[k] for k in sorted(by_name)]


# the per-process registry every subsystem registers into
REGISTRY = MetricsRegistry()
