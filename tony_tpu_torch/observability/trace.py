"""Lifecycle spans of a task: the port's copy of `SpanRecorder` from
`tony_tpu/observability/trace.py`.

A *trace* is one application run (trace_id = app_id); a *span* is one
phase of it (trainer setup, first step, checkpoint save/restore, a served
request) with a parent link, so the portal renders the job as one
waterfall. The executor renders ``TONY_TRACE_ID`` and ``TONY_PARENT_SPAN``
(its ``user_process`` span) into the task's environment; the trainer and
server parent their spans under it, and the finished spans ride the
metrics RPC (``update_metrics``'s ``spans``) to the AM. The span dict has
the JAX package's keys. A recorder past ``max_spans`` counts drops in the
health registry instead of growing. The executor's recorder also renders
the context into its user process's env (`SpanRecorder.env`). The AM
records its own spans straight into a `SpanStore` (the recorder's
``sink``), which gathers every principal's spans for one app.

`device_range` is the one mechanism for host ranges on the profiler's
clock: a `torch.profiler.record_function` range while the profiler is on,
so the range lands in the same event stream as the card's kernels, and a
flag check otherwise. The serving engine's step phases, the train step
and its optimizer use it.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

from tony_tpu_torch.observability.metrics import REGISTRY

LOG = logging.getLogger(__name__)

# env contract (rendered by the AM / executor, read by children)
TRACE_ID_ENV = "TONY_TRACE_ID"
PARENT_SPAN_ENV = "TONY_PARENT_SPAN"

STATUS_OK = "OK"
STATUS_ERROR = "ERROR"
STATUS_OPEN = "OPEN"


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    name: str
    span_id: str = field(default_factory=new_span_id)
    trace_id: str = ""
    parent_id: str = ""
    task_id: str = ""          # "worker:0"; "" for client/AM scope
    attempt: int = 0
    start_ms: int = 0
    end_ms: int = 0            # 0 = still open
    status: str = STATUS_OPEN
    attrs: dict = field(default_factory=dict)

    @property
    def duration_ms(self) -> int:
        return max(0, self.end_ms - self.start_ms) if self.end_ms else 0

    def to_dict(self) -> dict:
        return {
            "name": self.name, "span_id": self.span_id,
            "trace_id": self.trace_id, "parent_id": self.parent_id,
            "task_id": self.task_id, "attempt": self.attempt,
            "start_ms": self.start_ms, "end_ms": self.end_ms,
            "status": self.status, "attrs": dict(self.attrs),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(
            name=str(d.get("name", "")),
            span_id=str(d.get("span_id", "")) or new_span_id(),
            trace_id=str(d.get("trace_id", "")),
            parent_id=str(d.get("parent_id", "")),
            task_id=str(d.get("task_id", "")),
            attempt=int(d.get("attempt", 0)),
            start_ms=int(d.get("start_ms", 0)),
            end_ms=int(d.get("end_ms", 0)),
            status=str(d.get("status", STATUS_OPEN)),
            attrs=dict(d.get("attrs") or {}),
        )


class SpanRecorder:
    """Process-local span source for one principal (client, AM, one
    executor, one trainer). ``sink`` (the AM wires its SpanStore here)
    receives each span as it ends; sink-less recorders accumulate
    finished spans for ``drain()`` + an RPC push."""

    def __init__(self, trace_id: str = "", task_id: str = "",
                 attempt: int = 0, parent_id: str = "",
                 max_spans: int = 512,
                 sink: Optional[Callable[[list[dict]], None]] = None):
        self.trace_id = trace_id
        self.task_id = task_id
        self.attempt = attempt
        self.parent_id = parent_id          # ambient parent from the env
        self._max = max(1, max_spans)
        self._sink = sink
        self._finished: list[dict] = []
        self._recorded = 0
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env, task_id: str = "", attempt: int = 0,
                 max_spans: int = 512) -> "SpanRecorder":
        """Recorder seeded with the trace context a parent process
        rendered (no context → spans still record, with an empty trace
        id, so direct script runs keep working)."""
        return cls(trace_id=str(env.get(TRACE_ID_ENV, "") or ""),
                   task_id=task_id, attempt=attempt,
                   parent_id=str(env.get(PARENT_SPAN_ENV, "") or ""),
                   max_spans=max_spans)

    @property
    def enabled(self) -> bool:
        """Context-bearing recorders push upstream; a bare one (direct
        script run outside the orchestrator) records only locally."""
        return bool(self.trace_id)

    def start(self, name: str,
              parent: Union[Span, str, None] = None,
              attrs: Optional[dict] = None,
              task_id: Optional[str] = None,
              attempt: Optional[int] = None) -> Span:
        parent_id = (parent.span_id if isinstance(parent, Span)
                     else (parent if parent is not None
                           else self.parent_id))
        return Span(
            name=name, trace_id=self.trace_id, parent_id=parent_id,
            task_id=self.task_id if task_id is None else task_id,
            attempt=self.attempt if attempt is None else attempt,
            start_ms=int(time.time() * 1000), status=STATUS_OPEN,
            attrs=dict(attrs or {}))

    def end(self, span: Span, status: str = STATUS_OK,
            attrs: Optional[dict] = None) -> Span:
        if span.end_ms:                     # idempotent
            return span
        span.end_ms = int(time.time() * 1000)
        span.status = status
        if attrs:
            span.attrs.update(attrs)
        self._record(span.to_dict())
        return span

    @contextmanager
    def span(self, name: str, parent: Union[Span, str, None] = None,
             attrs: Optional[dict] = None):
        s = self.start(name, parent=parent, attrs=attrs)
        try:
            yield s
        except BaseException:
            self.end(s, STATUS_ERROR)
            raise
        self.end(s)

    def _record(self, d: dict) -> None:
        sink = self._sink
        if sink is not None:
            try:
                sink([d])
            except Exception:  # noqa: BLE001 — tracing never fails the host
                LOG.debug("span sink failed", exc_info=True)
            return
        with self._lock:
            if len(self._finished) >= self._max:
                REGISTRY.counter("tony_spans_dropped_total").inc()
                return
            self._finished.append(d)
            self._recorded += 1

    def drain(self) -> list[dict]:
        """Finished spans accumulated since the last drain (cleared) —
        the payload the executor/trainer piggybacks on the metrics RPC."""
        with self._lock:
            out, self._finished = self._finished, []
        return out

    def record_complete(self, name: str, start_ms: int, end_ms: int,
                        status: str = STATUS_OK,
                        attrs: Optional[dict] = None) -> Span:
        """Record an already-finished span with caller-supplied
        timestamps — for events measured on another clock (the serving
        engine's monotonic request stamps) that are converted to epoch
        ms after the fact."""
        span = Span(name=name, trace_id=self.trace_id,
                    parent_id=self.parent_id, task_id=self.task_id,
                    attempt=self.attempt, start_ms=int(start_ms),
                    end_ms=int(end_ms), status=status,
                    attrs=dict(attrs or {}))
        self._record(span.to_dict())
        return span

    def env(self, span: Optional[Span] = None) -> dict[str, str]:
        """Trace-context env block for a child process: the trace id and
        the span the child should parent under (default: the ambient
        parent this recorder was seeded with)."""
        if not self.trace_id:
            return {}
        parent = span.span_id if span is not None else self.parent_id
        out = {TRACE_ID_ENV: self.trace_id}
        if parent:
            out[PARENT_SPAN_ENV] = parent
        return out


class SpanStore:
    """AM-side accumulation of every principal's spans for one app.
    Bounded (``tony.trace.max-spans``); overflow counts drops rather
    than growing — the history flush then says so."""

    def __init__(self, max_spans: int = 2048):
        self._max = max(1, max_spans)
        self._spans: list[dict] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, spans: list[dict]) -> None:
        with self._lock:
            for d in spans or []:
                if not isinstance(d, dict) or not d.get("name"):
                    continue
                if len(self._spans) >= self._max:
                    self.dropped += 1
                    REGISTRY.counter("tony_spans_dropped_total").inc()
                    continue
                self._spans.append(d)

    def add_span(self, span: Span) -> None:
        self.add([span.to_dict()])

    def to_list(self) -> list[dict]:
        """All spans, waterfall order (by start, then name)."""
        with self._lock:
            out = list(self._spans)
        out.sort(key=lambda d: (int(d.get("start_ms", 0)),
                                str(d.get("name", ""))))
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


_NO_RANGE = nullcontext()


def device_range(name: str, args: Optional[str] = None):
    """A `record_function(name, args)` range when the profiler is on for
    this thread, else a shared null context: with the profiler off a range
    costs a call and a flag check, not a `record_function` enter and exit.
    torch is imported here: the control plane imports this module and never
    torch."""
    import torch

    if not torch.autograd._profiler_enabled():
        return _NO_RANGE
    return torch.profiler.record_function(name, args)
