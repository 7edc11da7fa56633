"""Request-scoped distributed tracing for the disaggregated serving fleet.

The port's copy of `tony_tpu/observability/reqtrace.py`, whole: the same
header, hop names, sampler, export shape and TTFT attribution, so a
request relayed between a port replica and a JAX one keeps one trace.

A served request may cross processes (router → prefill replica →
/v1/migrate → decode replica). One trace context per REQUEST is minted
at the router's ingress (or adopted from the client via
the ``X-Tony-Trace`` header) and propagated on every replica-to-replica
HTTP call, so the decode replica continues the *same* trace the router
started.

Design constraints, in order:

- **Zero added per-request RPCs.** Hops accumulate in-process on the
  request handle; at completion a tail-based sampler decides keep/drop.
  Dropped traces are a garbage-collected list — the fast path never
  touches a lock beyond the final sampling decision. Kept traces sit in
  a bounded per-process buffer exported PULL-only (``GET /v1/traces``)
  and piggybacked on the periodic metrics RPC into history
  (serving_traces.json) — the same no-new-channel discipline the
  training spans use.
- **Tail-based sampling**: a trace is kept only when it matters —
  request errors, 429 spills, migrated requests (always interesting:
  they cross processes), and the slowest-k per window above
  ``tony.serving.trace.slow-threshold-ms``. Sampling is decided
  independently per process; migrated requests are kept on both sides,
  so cross-process stitching is eventually consistent rather than
  coordinated (coordination would be a per-request RPC).
- **Cross-process alignment without clock sync**: hop timestamps are
  wall-clock ms (anchored off each process's monotonic stamps), good
  enough for a waterfall; the TTFT-attribution components are
  single-process monotonic differences, which ARE exact. The router's
  own overhead rides the header as an explicit ``route_ms`` field so
  the replica's attribution rollup can include it without comparing
  clocks across hosts.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Iterable, Optional

# the one propagation header: "trace_id:parent_span_id[:route_ms]".
# route_ms is the router's ingress-to-forward overhead (monotonic,
# single-process, so exact) — the replica folds it into its attribution
# rollup instead of trying to compare clocks across hosts.
HEADER = "X-Tony-Trace"

_HEX = frozenset("0123456789abcdef")

# TTFT-attribution component order — also the canonical sum order the
# bench's disclosure stamps and the docs table follow
COMPONENTS = ("route_ms", "queue_ms", "prefill_ms", "migrate_ms",
              "decode_ms")


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def _hexish(value: str, limit: int) -> bool:
    return 0 < len(value) <= limit and set(value) <= _HEX


class TraceContext:
    """One request's identity on the wire: the trace id plus the span id
    of the upstream hop (the parent of whatever this process records)."""

    __slots__ = ("trace_id", "parent_span_id", "route_ms")

    def __init__(self, trace_id: str, parent_span_id: str = "",
                 route_ms: float = 0.0):
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.route_ms = float(route_ms)

    @classmethod
    def mint(cls) -> "TraceContext":
        return cls(new_trace_id())

    def child(self, span_id: str, route_ms: float = 0.0) -> "TraceContext":
        return TraceContext(self.trace_id, span_id, route_ms)

    def header_value(self) -> str:
        if self.route_ms > 0:
            return (f"{self.trace_id}:{self.parent_span_id}"
                    f":{self.route_ms:.3f}")
        return f"{self.trace_id}:{self.parent_span_id}"


def parse_header(value: Optional[str]) -> Optional[TraceContext]:
    """A TraceContext from an ``X-Tony-Trace`` value, or None when the
    header is absent or garbage (a malformed client header must mint a
    fresh trace, never crash admission or poison the id space)."""
    if not value:
        return None
    parts = str(value).strip().split(":")
    if not parts or not _hexish(parts[0], 32):
        return None
    parent = parts[1] if len(parts) > 1 else ""
    if parent and not _hexish(parent, 16):
        return None
    route_ms = 0.0
    if len(parts) > 2:
        try:
            route_ms = max(0.0, float(parts[2]))
        except ValueError:
            route_ms = 0.0
    return TraceContext(parts[0], parent, route_ms)


def adopt_or_mint(value: Optional[str]) -> tuple[TraceContext, bool]:
    """(context, adopted): the wire header's context when it parses,
    else a freshly minted root — the router's ingress decision."""
    ctx = parse_header(value)
    if ctx is not None:
        return ctx, True
    return TraceContext.mint(), False


def mono_to_wall_ms(t_mono: float) -> int:
    """A wall-clock ms for a time.monotonic() stamp taken earlier in
    THIS process (anchored at call time — good enough for waterfall
    alignment; attribution math never crosses this conversion)."""
    return int((time.time() - (time.monotonic() - t_mono)) * 1000.0)


class RequestTrace:
    """One request's in-process hop accumulator — the unsampled fast
    path. Appends are local-list cheap; nothing is exported unless the
    collector's tail sampler keeps the completed trace."""

    __slots__ = ("ctx", "process", "request_id", "hops", "started_ms")

    def __init__(self, ctx: TraceContext, process: str = "",
                 request_id: str = ""):
        self.ctx = ctx
        self.process = process
        self.request_id = request_id
        self.hops: list[dict] = []
        self.started_ms = int(time.time() * 1000)

    def hop(self, name: str, start_ms: int, end_ms: int,
            attrs: Optional[dict] = None, status: str = "OK",
            parent_id: Optional[str] = None,
            span_id: Optional[str] = None) -> str:
        """Record one completed hop; returns its span id (the parent for
        downstream hops — the migrate POST forwards it in the header).
        Pass an explicit span_id when the id had to go on the wire
        BEFORE the hop completed (the router forwards its route span's
        id, then records the hop once the relay finishes)."""
        span_id = span_id or new_span_id()
        self.hops.append({
            "trace_id": self.ctx.trace_id,
            "span_id": span_id,
            "parent_id": (self.ctx.parent_span_id if parent_id is None
                          else parent_id),
            "name": name,
            "process": self.process,
            "start_ms": int(start_ms),
            "end_ms": int(end_ms),
            "status": status,
            "attrs": dict(attrs or {}),
        })
        return span_id


class TailSampler:
    """Keep a completed trace only when it matters: errors, 429 spills,
    migrated requests, and the slowest-k per rolling window above the
    slow threshold. Thread-safe; the slow path holds a small lock over
    a bounded window list."""

    def __init__(self, slow_threshold_ms: float = 1000.0,
                 slowest_k: int = 8, window_ms: float = 60_000.0,
                 clock: Callable[[], float] = time.monotonic):
        self.slow_threshold_ms = float(slow_threshold_ms)
        self.slowest_k = max(1, int(slowest_k))
        self.window_ms = max(1.0, float(window_ms))
        self._clock = clock
        self._lock = threading.Lock()
        # (monotonic_ms, duration_ms) of slow traces KEPT this window
        self._kept: list[tuple[float, float]] = []

    def keep(self, duration_ms: float, error: bool = False,
             spilled: bool = False, migrated: bool = False
             ) -> Optional[str]:
        """The keep reason, or None to drop. Unconditional keeps never
        consume the slowest-k budget — an error burst must not shadow a
        concurrent latency regression."""
        if error:
            return "error"
        if spilled:
            return "spill"
        if migrated:
            return "migrated"
        if duration_ms < self.slow_threshold_ms:
            return None
        now = self._clock() * 1000.0
        with self._lock:
            cutoff = now - self.window_ms
            self._kept = [(ts, d) for ts, d in self._kept if ts >= cutoff]
            if len(self._kept) < self.slowest_k:
                self._kept.append((now, duration_ms))
                return "slow"
            floor = min(d for _, d in self._kept)
            if duration_ms > floor:
                # displace the window's fastest kept slot — the window
                # converges on the true slowest-k, not first-k
                self._kept.remove(next(
                    (ts, d) for ts, d in self._kept if d == floor))
                self._kept.append((now, duration_ms))
                return "slow"
        return None


class ReqTraceCollector:
    """Per-process sampled-trace buffer: bounded, pull-exported
    (/v1/traces), drained into the periodic metrics RPC for the history
    flush. Disabled collectors make every call a cheap no-op so the
    serve path needs no conditional wiring."""

    def __init__(self, process: str,
                 sampler: Optional[TailSampler] = None,
                 max_traces: int = 256, enabled: bool = True):
        self.process = process
        self.sampler = sampler or TailSampler()
        self.max_traces = max(1, int(max_traces))
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._sampled: list[dict] = []
        self.attribution = TtftAttribution()

    def trace(self, ctx: TraceContext,
              request_id: str = "") -> Optional[RequestTrace]:
        if not self.enabled:
            return None
        return RequestTrace(ctx, process=self.process,
                            request_id=request_id)

    def finish(self, trace: Optional[RequestTrace], duration_ms: float,
               error: bool = False, spilled: bool = False,
               migrated: bool = False) -> Optional[str]:
        """The tail decision: sample-or-drop one completed request. A
        dropped trace is simply garbage — the unsampled fast path's only
        cost was the in-process hop appends."""
        if trace is None or not self.enabled:
            return None
        reason = self.sampler.keep(duration_ms, error=error,
                                   spilled=spilled, migrated=migrated)
        if reason is None:
            return None
        record = {
            "trace_id": trace.ctx.trace_id,
            "request_id": trace.request_id,
            "process": trace.process,
            "kept_reason": reason,
            "duration_ms": round(float(duration_ms), 3),
            "hops": list(trace.hops),
        }
        with self._lock:
            if len(self._sampled) >= self.max_traces:
                # bounded buffer: drop the OLDEST sampled trace (the
                # newest is the one an operator is chasing) and count it
                self._sampled.pop(0)
                from tony_tpu_torch.observability.metrics import REGISTRY
                REGISTRY.counter("tony_reqtrace_dropped_total").inc()
            self._sampled.append(record)
        return reason

    def export(self) -> list[dict]:
        """Non-destructive redacted snapshot — the /v1/traces pull."""
        with self._lock:
            return redact_traces(list(self._sampled))

    def drain(self) -> list[dict]:
        """Destructive redacted drain — the metrics-RPC piggyback into
        the AM's history store."""
        with self._lock:
            out, self._sampled = self._sampled, []
        return redact_traces(out)


def redact_traces(traces: Iterable[dict]) -> list[dict]:
    """Redact every string attribute on every hop (observability/logs
    redaction) — applied at EVERY export surface (/v1/traces, the
    history flush, the portal API); prompts are never stored as attrs,
    this is the defense-in-depth the redact-on-egress lint rule pins."""
    from tony_tpu_torch.observability.logs import redact
    out = []
    for t in traces:
        t = dict(t)
        hops = []
        for hop in t.get("hops") or []:
            hop = dict(hop)
            hop["attrs"] = {k: (redact(v) if isinstance(v, str) else v)
                            for k, v in (hop.get("attrs") or {}).items()}
            hops.append(hop)
        t["hops"] = hops
        out.append(t)
    return out


def stitch(trace_lists: Iterable[Iterable[dict]]) -> list[dict]:
    """Merge per-process sampled traces into cross-process ones: same
    trace_id → one trace, hops concatenated (de-duplicated by span_id,
    time-ordered), duration = the max any process observed, kept_reason
    = the most specific. The router's /v1/traces and both offline
    renderers (portal, `cli trace`) share this."""
    reason_rank = {"error": 0, "spill": 1, "migrated": 2, "slow": 3}
    by_id: dict[str, dict] = {}
    for traces in trace_lists:
        for t in traces or []:
            tid = str(t.get("trace_id", ""))
            if not tid:
                continue
            cur = by_id.get(tid)
            if cur is None:
                cur = by_id[tid] = {
                    "trace_id": tid,
                    "request_id": t.get("request_id", ""),
                    "kept_reason": t.get("kept_reason", ""),
                    "duration_ms": float(t.get("duration_ms", 0) or 0),
                    "processes": [],
                    "hops": [],
                }
            cur["duration_ms"] = max(
                cur["duration_ms"], float(t.get("duration_ms", 0) or 0))
            if reason_rank.get(t.get("kept_reason"), 9) \
                    < reason_rank.get(cur["kept_reason"], 9):
                cur["kept_reason"] = t.get("kept_reason", "")
            if not cur["request_id"]:
                cur["request_id"] = t.get("request_id", "")
            seen = {h.get("span_id") for h in cur["hops"]}
            for hop in t.get("hops") or []:
                if hop.get("span_id") in seen:
                    continue
                seen.add(hop.get("span_id"))
                cur["hops"].append(hop)
            for hop in t.get("hops") or []:
                proc = str(hop.get("process", ""))
                if proc and proc not in cur["processes"]:
                    cur["processes"].append(proc)
    out = list(by_id.values())
    for t in out:
        t["hops"].sort(key=lambda h: (int(h.get("start_ms", 0)),
                                      str(h.get("name", ""))))
    out.sort(key=lambda t: -t["duration_ms"])
    return out


def slowest_table(stitched: list[dict], k: int = 10) -> list[dict]:
    """The slowest-requests table: per stitched trace — duration, keep
    reason, and the DOMINANT hop (longest single hop) with the process
    that ran it, so a slow request names its guilty replica."""
    rows = []
    for t in stitched[:max(0, int(k))]:
        dominant = max(t.get("hops") or [{}],
                       key=lambda h: (int(h.get("end_ms", 0) or 0)
                                      - int(h.get("start_ms", 0) or 0)))
        dom_ms = (int(dominant.get("end_ms", 0) or 0)
                  - int(dominant.get("start_ms", 0) or 0))
        rows.append({
            "trace_id": t.get("trace_id", ""),
            "request_id": t.get("request_id", ""),
            "duration_ms": t.get("duration_ms", 0),
            "kept_reason": t.get("kept_reason", ""),
            "processes": list(t.get("processes") or []),
            "dominant_hop": str(dominant.get("name", "")),
            "dominant_process": str(dominant.get("process", "")),
            "dominant_ms": dom_ms,
            "hop_count": len(t.get("hops") or []),
        })
    return rows


def record_engine_phases(trace: Optional[RequestTrace], handle) -> None:
    """Engine-phase hops off a finished RequestHandle's stamps:
    queue_wait, then kv_match + prefill_suffix (or migrate.install for a
    migrated-in request), then decode. Duck-typed on the handle so the
    sampler unit tests need no engine."""
    if trace is None:
        return
    submitted = getattr(handle, "submitted_at", None)
    if submitted is None:
        return
    base_ms = mono_to_wall_ms(submitted)

    def at(t_mono: Optional[float]) -> int:
        if t_mono is None:
            return base_ms
        return base_ms + int(round((t_mono - submitted) * 1000.0))

    queue_s = getattr(handle, "queue_wait_s", None) or 0.0
    prefill_s = getattr(handle, "prefill_s", None) or 0.0
    t_dequeue = submitted + queue_s
    trace.hop("queue_wait", base_ms, at(t_dequeue))
    if getattr(handle, "migrated_in", False):
        trace.hop("migrate.install", at(t_dequeue),
                  at(t_dequeue + prefill_s),
                  attrs={"pos": len(getattr(handle, "prompt", []) or [])})
    else:
        kv_s = getattr(handle, "kv_match_s", None) or 0.0
        matched = int(getattr(handle, "kv_matched_tokens", 0) or 0)
        trace.hop("kv_match", at(t_dequeue), at(t_dequeue + kv_s),
                  attrs={"matched_tokens": matched})
        trace.hop("prefill_suffix", at(t_dequeue + kv_s),
                  at(t_dequeue + prefill_s),
                  attrs={"prompt_tokens": len(
                      getattr(handle, "prompt", []) or []),
                      "suffix_tokens": len(
                          getattr(handle, "prompt", []) or []) - matched})
    first = getattr(handle, "first_token_at", None)
    finished = getattr(handle, "finished_at", None)
    if first is not None and finished is not None and finished > first:
        tokens = len(getattr(handle, "tokens", []) or [])
        itl_ms = (1000.0 * (finished - first) / max(1, tokens - 1)
                  if tokens > 1 else 0.0)
        trace.hop("decode", at(first), at(finished),
                  attrs={"tokens": tokens,
                         "itl_ms": round(itl_ms, 3),
                         "finish_reason": str(
                             getattr(handle, "finish_reason", ""))})


def attribution_from_handle(handle, route_ms: float = 0.0,
                            migrate_ms: float = 0.0) -> dict:
    """TTFT-attribution components (ms) for one finished request —
    single-process monotonic differences, exact by construction. decode
    is the first-token remainder after queue+prefill (≈0 when the first
    token comes straight out of admission, the honest number)."""
    queue_ms = 1000.0 * (getattr(handle, "queue_wait_s", None) or 0.0)
    prefill_ms = 1000.0 * (getattr(handle, "prefill_s", None) or 0.0)
    ttft_s = getattr(handle, "ttft_s", None)
    decode_ms = 0.0
    if ttft_s is not None:
        decode_ms = max(0.0, 1000.0 * ttft_s - queue_ms - prefill_ms)
    return {"route_ms": max(0.0, float(route_ms)),
            "queue_ms": queue_ms,
            "prefill_ms": prefill_ms,
            "migrate_ms": max(0.0, float(migrate_ms)),
            "decode_ms": decode_ms}


def _percentile(samples: list, q: float) -> Optional[float]:
    if not samples:
        return None
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


class TtftAttribution:
    """Bounded rolling window of per-request TTFT components; rolls up
    to p50/p95 gauges per component — the SERVING_TTFT_ATTR_* families
    on /v1/metrics (and the router's route-side equivalent)."""

    def __init__(self, maxlen: int = 512):
        self.maxlen = max(1, int(maxlen))
        self._lock = threading.Lock()
        self._samples: dict[str, list[float]] = {
            name: [] for name in COMPONENTS}

    def record(self, components: dict) -> None:
        with self._lock:
            for name in COMPONENTS:
                value = components.get(name)
                if value is None:
                    continue
                bucket = self._samples[name]
                bucket.append(float(value))
                if len(bucket) > self.maxlen:
                    del bucket[:len(bucket) - self.maxlen]

    def gauges(self) -> dict[str, float]:
        """{"ttft_attr_queue_ms_p50": ..., ...} for every component
        with samples (empty components stay absent — idle replicas emit
        no misleading zeros)."""
        out: dict[str, float] = {}
        with self._lock:
            for name in COMPONENTS:
                samples = self._samples[name]
                if not samples:
                    continue
                base = name[:-3]    # strip "_ms"
                for tag, q in (("p50", 0.50), ("p95", 0.95)):
                    value = _percentile(samples, q)
                    if value is not None:
                        out[f"ttft_attr_{base}_ms_{tag}"] = round(value, 3)
        return out
