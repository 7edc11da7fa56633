"""Metrics a port trainer or server pushes to the AM from inside the task.

The port's copy of `tony_tpu/train/metrics.py`, under its names so a
reader finds each counterpart:
- `TpuMetricsReporter`: lazily connected, non-blocking pusher of gauges,
  spans and profile completions over the AM's metrics RPC; a daemon
  worker drains a shallow drop-newest queue, so the train loop never
  waits on the network. A no-op when the task environment is absent.
- `ServingMetricsReporter`: a sampler thread that pushes the engine's
  gauges (with sampled request traces and spans) every
  ``tony.task.metrics-interval-ms``.
- `tpu_memory_metrics`: the device memory gauges. On the card they are
  the card's bytes (`torch.cuda`), under the JAX package's gauge names
  ``TPU_HBM_BYTES_IN_USE``/``_LIMIT``, which the AM, the portal and the
  Prometheus exposition read; on the CPU there are none, as JAX reports
  none off the TPU.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Optional

from tony_tpu_torch import constants as C

LOG = logging.getLogger(__name__)

_CLOSE = object()


def tpu_memory_metrics() -> list[dict]:
    """The card's memory in use (bytes held by live tensors, summed over
    the cards this process has touched) and its capacity, under the
    JAX package's gauge names; [] when this process runs no CUDA work."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    used = limit = 0
    for i in range(torch.cuda.device_count()):
        used += int(torch.cuda.memory_allocated(i))
        limit += int(torch.cuda.get_device_properties(i).total_memory)
    return [{"name": "TPU_HBM_BYTES_IN_USE", "value": float(used)},
            {"name": "TPU_HBM_BYTES_LIMIT", "value": float(limit)}]


class TpuMetricsReporter:
    """Lazily-connected pusher; no-op when the task env is absent (direct
    script runs outside the orchestrator).

    Non-blocking: `report()` samples device memory here (a cheap
    host call) and hands the RPC to a daemon worker thread — the train
    loop never waits on the network. The push queue is shallow and
    drop-newest: metrics are a periodic gauge, so when the AM is slow a
    stale sample is simply skipped in favor of the next interval's."""

    def __init__(self, env: Optional[dict] = None):
        e = env if env is not None else os.environ
        self._host = e.get(C.AM_HOST)
        port = e.get(C.METRICS_RPC_PORT) or e.get(C.AM_PORT)
        self._port = int(port) if port else 0
        from tony_tpu_torch.security.tokens import TOKEN_ENV
        self._task_type = e.get(C.JOB_NAME, "")
        self._index = int(e.get(C.TASK_INDEX, "0"))
        self._attempt = int(e.get(C.TASK_ATTEMPT, "-1") or -1)
        self._token = e.get(TOKEN_ENV) or None
        self._client = None
        self._enabled = bool(self._host and self._port and self._task_type)
        self._queue: queue.Queue = queue.Queue(maxsize=2)
        self._worker: Optional[threading.Thread] = None
        # self-health: samples dropped because the push queue was full
        # (a slow/unreachable AM) — visible in the process registry as
        # tony_metrics_push_dropped_total instead of a debug log no one
        # reads
        self.dropped = 0

    def report(self, extra: Optional[list[dict]] = None) -> None:
        """Enqueue one device-memory sample (+ caller-supplied gauges — the
        trainer's goodput ledger / MFU metrics ride along) for the
        background pusher. Never blocks the caller: a full queue drops
        the sample (the next interval's fresher one supersedes it)."""
        if not self._enabled:
            return
        metrics = tpu_memory_metrics() + list(extra or [])
        if not metrics:
            return
        self._enqueue({"metrics": metrics})

    def report_profile_done(self, profile_done: dict) -> None:
        """Enqueue a profiler-capture completion (observability/perf.py
        ProfileCapture publish): {request_id, path, num_steps,
        duration_ms} rides the metrics RPC's `profile_done` field for
        the AM to link the artifact into history."""
        if not self._enabled or not profile_done:
            return
        self._enqueue({"metrics": [], "profile_done": profile_done})

    def report_spans(self, spans: list[dict]) -> None:
        """Enqueue finished lifecycle spans (observability/trace.py) for
        the same non-blocking pusher — trainer phase boundaries ride the
        metrics channel exactly like the executor's."""
        if not self._enabled or not spans:
            return
        self._enqueue({"metrics": [], "spans": spans})

    def _enqueue(self, payload: dict) -> None:
        """Hand one push payload ({"metrics": [...], "spans": [...]}) to
        the background pusher (shared by the trainer's reporter and the serving
        reporter); never blocks."""
        if self._worker is None:
            # a FRESH queue per worker: after a timed-out close() the old
            # queue may still hold a stale _CLOSE (its wedged worker owns
            # it and exits when it unwedges) — a successor must not
            # consume that sentinel and die on arrival
            self._queue = queue.Queue(maxsize=2)
            self._worker = threading.Thread(
                target=self._drain, args=(self._queue,),
                name="tony-metrics-push", daemon=True)
            self._worker.start()
        try:
            self._queue.put_nowait(payload)
        except queue.Full:
            self.dropped += 1
            from tony_tpu_torch.observability.metrics import REGISTRY
            REGISTRY.counter("tony_metrics_push_dropped_total").inc()
            LOG.debug("metrics push queue full; dropping stale sample "
                      "(%d dropped so far)", self.dropped)

    def _drain(self, q: queue.Queue) -> None:
        from tony_tpu_torch.observability.profiler import register_beacon
        # queue-driven: idle() before the blocking get() so an empty
        # queue is not a stall; an ACTIVE beacon means _push is wedged
        beacon = register_beacon("metrics-push", 10.0)
        while True:
            beacon.idle()
            item = q.get()
            beacon.beat()
            if item is _CLOSE:
                beacon.idle()
                return
            self._push(item)

    def _push(self, payload: dict) -> None:
        try:
            if self._client is None:
                from tony_tpu_torch.rpc.client import MetricsServiceClient
                # env token is the per-task derived token (see
                # tokens.derive_task_token); identify the task for re-derive
                task_auth = (f"{self._task_type}:{self._index}"
                             if self._token else None)
                self._client = MetricsServiceClient(
                    self._host, self._port, auth_token=self._token,
                    task_auth_id=task_auth)
            req = {"task_type": self._task_type, "index": self._index,
                   "metrics": payload.get("metrics", [])}
            if payload.get("spans"):
                req["spans"] = payload["spans"]
            if payload.get("serving_traces"):
                req["serving_traces"] = payload["serving_traces"]
            if payload.get("profile_done"):
                req["profile_done"] = payload["profile_done"]
            if self._attempt >= 0:
                req["attempt"] = self._attempt
            self._client.call("update_metrics", req, retries=1,
                              timeout_sec=5.0, wait_for_ready=False)
        except Exception:  # noqa: BLE001 — metrics never break training
            LOG.debug("metrics push failed", exc_info=True)

    def close(self, timeout: float = 2.0) -> None:
        """Flush-and-stop the background pusher (idempotent). Queued
        samples ahead of the close marker are still delivered. A wedged
        worker (full queue: it is stuck mid-RPC) still gets a BOUNDED
        join — the close sentinel can't be enqueued, but the caller must
        not return while the wedged daemon may still be mid-push with
        the process about to exit underneath it."""
        worker, self._worker = self._worker, None
        if worker is None or not worker.is_alive():
            return
        try:
            self._queue.put(_CLOSE, timeout=timeout)
        except queue.Full:
            # worker wedged on a slow RPC: give it the same bounded grace
            # the clean path gets, then abandon it (daemon thread)
            worker.join(timeout)
            return
        worker.join(timeout)


class ServingMetricsReporter(TpuMetricsReporter):
    """Periodic pusher for the serving subsystem (serve/engine.py): one
    daemon sampler thread calls `sample_fn()` (the engine's `metrics()` —
    TTFT, inter-token latency, queue depth, slot occupancy, tokens/sec)
    every `interval_sec` and hands the result to the SAME non-blocking
    queue/worker machinery the trainer's reporter uses — one metrics
    path from both halves of the lifecycle to the AM's MetricsStore, and
    from there to history events and the portal job page.

    Interval defaults to the task metrics cadence the executor renders
    (tony.task.metrics-interval-ms). No-op outside the orchestrator, like
    the parent class."""

    def __init__(self, sample_fn, env: Optional[dict] = None,
                 interval_sec: Optional[float] = None,
                 span_source=None, trace_source=None):
        super().__init__(env=env)
        self._sample_fn = sample_fn
        # optional span drain (a SpanRecorder's .drain): finished
        # per-request serving spans ride the same periodic push
        self._span_source = span_source
        # optional request-trace drain (a ReqTraceCollector's .drain):
        # tail-sampled distributed request traces piggyback the same
        # push — zero new channels, zero per-request RPCs
        self._trace_source = trace_source
        if interval_sec is None:
            e = env if env is not None else os.environ
            interval_sec = float(e.get("TONY_METRICS_INTERVAL_SEC", "5"))
        self._interval = interval_sec
        self._sampler_stop = threading.Event()
        self._sampler: Optional[threading.Thread] = None

    def start(self) -> None:
        if not self._enabled or self._sampler is not None:
            return
        self._sampler = threading.Thread(target=self._sample_loop,
                                         name="serving-metrics",
                                         daemon=True)
        self._sampler.start()

    def _sample_loop(self) -> None:
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon("serving-metrics", self._interval)
        while not self._sampler_stop.wait(self._interval):
            beacon.beat()
            self.report_now()
        beacon.idle()

    def report_now(self) -> None:
        """Sample and enqueue once (the sampler's tick; also callable
        directly, e.g. right before shutdown)."""
        if not self._enabled:
            return
        try:
            metrics = self._sample_fn()
        except Exception:  # noqa: BLE001 — metrics never break serving
            LOG.debug("serving metrics sample failed", exc_info=True)
            return
        spans: list[dict] = []
        if self._span_source is not None:
            try:
                spans = self._span_source() or []
            except Exception:  # noqa: BLE001
                LOG.debug("serving span drain failed", exc_info=True)
        traces: list[dict] = []
        if self._trace_source is not None:
            try:
                traces = self._trace_source() or []
            except Exception:  # noqa: BLE001
                LOG.debug("serving trace drain failed", exc_info=True)
        if not metrics and not spans and not traces:
            return
        payload: dict = {"metrics": metrics or []}
        if spans:
            payload["spans"] = spans
        if traces:
            payload["serving_traces"] = traces
        self._enqueue(payload)

    def close(self, timeout: float = 2.0) -> None:
        self._sampler_stop.set()
        if self._sampler is not None:
            self._sampler.join(timeout)
            self._sampler = None
        # final flush so a short-lived server still lands one sample
        self.report_now()
        super().close(timeout)
