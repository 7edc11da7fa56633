"""HTTP frontend for the continuous-batching engine.

Counterpart of `tony_tpu/serve/frontend.py`: a stdlib ThreadingHTTPServer
whose handler threads only enqueue and wait on token streams; the compute
plane lives in the engine's single stepper thread.

Routes:
- ``POST /v1/generate`` — body ``{"prompt": [ids...], "max_new_tokens": N,
  "stream": bool}``. Blocking mode returns one JSON object with the
  generated tokens; ``stream=true`` returns chunked JSON lines, one token
  object per line, ending with a ``{"done": true, ...}`` record.
- ``GET /healthz`` — liveness.
- ``GET /v1/metrics`` — the engine's JSON gauge snapshot by default;
  Prometheus text exposition for ``?format=prometheus`` or an ``Accept``
  of ``text/plain``/OpenMetrics. ``GET /metrics`` is always exposition:
  the engine gauges (labelled ``{app_id, task_type, index, attempt}``
  under the orchestrator), the TTFT attribution and this process's
  health registry.
- ``GET /v1/load`` — the lock-free load probe a fleet router reads.
- ``GET /v1/traces`` — the tail-sampled request traces (redacted) and this
  process's per-path request counts.
- ``POST /v1/drain`` — begin connection draining (in-flight requests
  finish, new ones answer 503); with a task token in the environment it
  demands ``Authorization: Bearer <token>`` and answers 403 without it.

Backpressure: the engine's bounded queue and queued-token budget answer
HTTP 429 with ``Retry-After``; a request that can never fit the per-slot
token budget is a 400.

Disaggregation (serve/kvcache.py wire format): a ``role="decode"``
replica accepts ``POST /v1/migrate``, a packed prefill handoff, and
streams the decoded tokens back as chunked JSON lines. A
``role="prefill"`` frontend (built with ``migrate_targets``) admits
``/v1/generate`` work with ``migrate_out=True``, posts the payload to a
decode replica (round robin, skipping refusals) and relays the decode
stream to the client behind the first token it already holds; if every
decode replica refuses, it installs the payload in its own engine and
finishes there.

Request tracing (observability/reqtrace.py): every ``/v1/generate`` and
``/v1/migrate`` adopts the ``X-Tony-Trace`` context (or mints one); the
prefill side records ``migrate.pack`` and ``migrate.transfer`` hops and
forwards the context, parented under its pack hop, to the decode
replica, so a relayed request keeps one trace id across both.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Optional
from urllib.parse import parse_qs, urlparse

from tony_tpu_torch.observability import reqtrace
from tony_tpu_torch.serve import kvcache as kvc
from tony_tpu_torch.serve.engine import (
    BudgetExceededError, ContinuousBatchingEngine, DrainingError,
    QueueFullError,
)

LOG = logging.getLogger(__name__)


def engine_prometheus_text(engine: ContinuousBatchingEngine,
                           collector=None) -> str:
    """The engine's snapshot, the collector's TTFT attribution and this
    process's health registry as Prometheus text exposition, as the JAX
    frontend renders it. Under the orchestrator every engine gauge is
    labelled {app_id, task_type, index, attempt}; a gauge with no value
    yet (TTFT, ITL before traffic) is NaN, not absent."""
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.observability.metrics import REGISTRY
    from tony_tpu_torch.observability.prometheus import (
        render, task_metric_name,
    )

    labels = {}
    for key, env_name in (("app_id", C.APP_ID), ("task_type", C.JOB_NAME),
                          ("index", C.TASK_INDEX),
                          ("attempt", C.TASK_ATTEMPT)):
        value = os.environ.get(env_name)
        if value:
            labels[key] = value
    snap = engine.snapshot()
    families = []
    for key in sorted(snap):
        value = snap[key]
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        families.append({"name": task_metric_name(f"serving_{key}"),
                         "type": "gauge", "help": "",
                         "samples": [(labels, float(value))]})
    for key in sorted(k for k, v in snap.items() if v is None):
        families.append({"name": task_metric_name(f"serving_{key}"),
                         "type": "gauge", "help": "",
                         "samples": [(labels, float("nan"))]})
    if collector is not None:
        for key, value in sorted(collector.attribution.gauges().items()):
            families.append({
                "name": task_metric_name(f"serving_{key}"),
                "type": "gauge", "help": "",
                "samples": [(labels, float(value))]})
    return render(families + REGISTRY.families())


MAX_BODY_BYTES = 8 * 1024 * 1024
# migration payloads carry real K/V bytes (L*Hkv*pos*hd per leaf), far
# past the JSON request bound
MAX_MIGRATE_BYTES = 1024 * 1024 * 1024
# streaming stall guard: an engine wedged mid-request must not pin the
# handler thread forever
STREAM_TOKEN_TIMEOUT_SEC = 300.0


class _Handler(BaseHTTPRequestHandler):
    engine: ContinuousBatchingEngine      # injected by ServeFrontend
    migrate_targets: tuple = ()           # decode-replica base URLs
    migrate_rr = itertools.count()        # round-robin start, per frontend
    on_migrated = None                    # hook(target_url) per handoff
    collector = None                      # ReqTraceCollector (optional)
    # per-path request counts, exported on /v1/traces: tracing itself
    # must add no request
    path_counts: dict = {}
    path_counts_lock = threading.Lock()
    protocol_version = "HTTP/1.1"         # keep-alive + chunked streaming

    def log_message(self, fmt, *args):    # route through logging
        LOG.debug("serve: " + fmt, *args)

    def _count(self, path: str) -> None:
        with self.path_counts_lock:
            self.path_counts[path] = self.path_counts.get(path, 0) + 1

    # -- plumbing -------------------------------------------------------
    def _json(self, obj, code: int = 200,
              extra_headers: Optional[dict] = None) -> None:
        data = (json.dumps(obj) + "\n").encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error(self, code: int, message: str,
               extra_headers: Optional[dict] = None) -> None:
        self._json({"error": message}, code, extra_headers)

    # -- routes ---------------------------------------------------------
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        parsed = urlparse(self.path)
        path = parsed.path.rstrip("/")
        self._count(path)
        if path == "/healthz":
            return self._json({"ok": True})
        if path == "/v1/traces":
            # pull-only: a non-destructive redacted snapshot
            coll = self.collector
            with self.path_counts_lock:
                counts = dict(self.path_counts)
            return self._json({
                "process": coll.process if coll is not None else "",
                "traces": coll.export() if coll is not None else [],
                "http_requests": counts})
        if path == "/v1/load":
            return self._json({"ok": True, **self.engine.load()})
        if path in ("/v1/metrics", "/metrics"):
            if path == "/metrics" or self._wants_prometheus(parsed.query):
                from tony_tpu_torch.observability.prometheus import (
                    CONTENT_TYPE,
                )
                data = engine_prometheus_text(
                    self.engine, self.collector).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return None
            snap = dict(self.engine.snapshot())
            if self.collector is not None:
                snap.update(self.collector.attribution.gauges())
            return self._json(snap)
        self._error(404, "not found")

    def _wants_prometheus(self, query: str) -> bool:
        """/v1/metrics negotiation: JSON by default; ?format=prometheus,
        or an Accept of text/plain or OpenMetrics (what a Prometheus
        scraper sends), asks for exposition."""
        fmt = (parse_qs(query).get("format") or [""])[0].lower()
        if fmt == "prometheus":
            return True
        if fmt == "json":
            return False
        accept = self.headers.get("Accept", "")
        return ("text/plain" in accept
                or "application/openmetrics-text" in accept)

    def do_POST(self):  # noqa: N802
        path = urlparse(self.path).path.rstrip("/")
        self._count(path)
        if path == "/v1/drain":
            # irreversible (it precedes a stop): on a secured cluster it
            # takes the task token, so anonymous traffic cannot take the
            # replica out of rotation
            self._drain_body()
            from tony_tpu_torch.security.tokens import TOKEN_ENV
            token = os.environ.get(TOKEN_ENV)
            if token and self.headers.get(
                    "Authorization", "") != f"Bearer {token}":
                return self._error(403, "drain requires the task token")
            self.engine.begin_drain()
            return self._json({"ok": True, **self.engine.load()})
        if path == "/v1/migrate":
            return self._handle_migrate()
        if path != "/v1/generate":
            # consume the body before answering: HTTP/1.1 keep-alive
            # would otherwise parse the unread bytes as the next request
            self._drain_body()
            return self._error(404, "not found")
        try:
            req = self._read_body()
        except ValueError as e:
            return self._error(400, str(e))
        try:
            prompt = [int(t) for t in req["prompt"]]
            max_new = int(req.get("max_new_tokens", 16))
            temperature = (float(req["temperature"])
                           if "temperature" in req else None)
        except (KeyError, TypeError, ValueError):
            return self._error(
                400, "body must be {'prompt': [token ids...], "
                     "'max_new_tokens': int, 'stream': bool}")
        # sampling is an ENGINE property: a mismatched ask is a contract
        # error, not something to silently coerce
        if temperature is not None and \
                temperature != self.engine.temperature:
            return self._error(
                400, f"engine is configured with temperature="
                     f"{self.engine.temperature}; per-request sampling "
                     f"overrides are not supported")
        migrate = bool(self.engine.role == "prefill"
                       and self.migrate_targets)
        handle = self._submit(self.engine.submit, prompt, max_new,
                              migrate_out=migrate)
        if handle is None:
            return None
        if migrate:
            return self._generate_migrating(handle, req)
        if req.get("stream"):
            return self._stream(handle)
        try:
            tokens = handle.result(timeout=STREAM_TOKEN_TIMEOUT_SEC)
        except TimeoutError as e:
            # nobody is waiting anymore: free the slot/queue budget
            handle.cancel()
            return self._error(504, str(e))
        if handle.finish_reason == "shutdown":
            return self._error(503, "engine shut down mid-request")
        self._json({"tokens": tokens,
                    "finish_reason": handle.finish_reason,
                    "ttft_s": handle.ttft_s})

    def _submit(self, submit, *args, **kwargs):
        """The handle `submit(*args)` returns, carrying the request's
        trace (adopted from X-Tony-Trace, else minted), or None after
        answering its refusal: 400 (can never fit), 429 (backpressure),
        503 (draining or stopped). A refusal's trace is sampled."""
        ctx, _ = reqtrace.adopt_or_mint(self.headers.get(reqtrace.HEADER))
        t_ingress = time.monotonic()
        trace = (self.collector.trace(ctx)
                 if self.collector is not None else None)
        try:
            handle = submit(*args, **kwargs)
        except BudgetExceededError as e:
            self._finish_rejected(trace, t_ingress, 400)
            self._error(400, str(e))
        except QueueFullError as e:
            self._finish_rejected(trace, t_ingress, 429, spilled=True)
            self._error(429, str(e), {"Retry-After": "1"})
        except DrainingError as e:
            self._finish_rejected(trace, t_ingress, 503)
            self._error(503, str(e), {"X-Tony-Draining": "1"})
        except RuntimeError as e:           # engine stopped
            self._finish_rejected(trace, t_ingress, 503)
            self._error(503, str(e))
        else:
            if trace is not None:
                trace.request_id = str(handle.request_id)
            handle.trace = trace
            handle.trace_ctx = ctx
            return handle
        return None

    def _finish_rejected(self, trace, t_ingress: float, status: int,
                         spilled: bool = False) -> None:
        """Sample a request that never got a slot: 429 spills and hard
        errors are kept unconditionally."""
        if trace is None or self.collector is None:
            return
        now = time.monotonic()
        trace.hop("frontend.reject",
                  reqtrace.mono_to_wall_ms(t_ingress),
                  reqtrace.mono_to_wall_ms(now),
                  attrs={"http_status": status}, status="ERROR")
        self.collector.finish(trace, (now - t_ingress) * 1000.0,
                              error=not spilled, spilled=spilled)

    def _drain_body(self) -> None:
        """Read and discard the request body (bounded); an oversized one
        closes the connection instead."""
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length <= 0:
            return
        if length > MAX_BODY_BYTES:
            self.close_connection = True
            return
        self.rfile.read(length)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length <= 0:
            raise ValueError("missing request body")
        if length > MAX_BODY_BYTES:
            # unread body: this connection cannot carry another request
            self.close_connection = True
            raise ValueError("request body too large")
        try:
            body = json.loads(self.rfile.read(length).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise ValueError("request body is not valid JSON") from None
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        return body

    def _stream(self, handle) -> None:
        """Chunked token stream: one JSON line per token, then the done
        record. A broken client connection cancels the request."""
        chunk = self._start_chunks()
        try:
            for token in handle.iter_tokens(
                    timeout=STREAM_TOKEN_TIMEOUT_SEC):
                chunk({"token": token})
            chunk({"done": True, "finish_reason": handle.finish_reason,
                   "n_tokens": len(handle.tokens),
                   "ttft_s": handle.ttft_s})
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            LOG.debug("stream aborted (request %d)", handle.request_id)
            handle.cancel()
            self.close_connection = True

    def _start_chunks(self):
        """Send the headers of a chunked JSON-lines answer; returns the
        function that writes one line as one chunk."""
        self.send_response(200)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj) -> None:
            data = (json.dumps(obj) + "\n").encode("utf-8")
            self.wfile.write(f"{len(data):x}\r\n".encode("ascii")
                             + data + b"\r\n")
        return chunk

    # -- disaggregation: decode side ------------------------------------
    def _handle_migrate(self) -> None:
        """POST /v1/migrate: adopt a prefill replica's handoff (packed K/V
        and sampler state) and stream the decoded tokens back."""
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length <= 0:
            return self._error(400, "missing migration body")
        if length > MAX_MIGRATE_BYTES:
            self.close_connection = True
            return self._error(413, "migration payload too large")
        body = self.rfile.read(length)
        try:
            meta, leaves = kvc.unpack_migration(body)
        except (ValueError, KeyError, TypeError) as e:
            return self._error(400, f"bad migration payload: {e}")
        handle = self._submit(self.engine.submit_migration, meta, leaves)
        if handle is not None:
            self._stream(handle)

    # -- disaggregation: prefill side -----------------------------------
    def _generate_migrating(self, handle, req: dict) -> None:
        """Finish a migrate_out admission: wait for the prefill, post the
        handoff to a decode replica and relay its stream to the client
        behind the first token computed here. If every decode replica
        refuses, finish it in this engine."""
        try:
            handle.result(timeout=STREAM_TOKEN_TIMEOUT_SEC)
        except TimeoutError as e:
            handle.cancel()
            return self._error(504, str(e))
        if handle.finish_reason == "shutdown":
            return self._error(503, "engine shut down mid-request")
        if handle.finish_reason != "migrated" or handle.migration is None:
            # finished at admission (eos, or max_new_tokens 1)
            if req.get("stream"):
                return self._stream(handle)
            return self._json({"tokens": list(handle.tokens),
                               "finish_reason": handle.finish_reason,
                               "ttft_s": handle.ttft_s})
        meta = handle.migration["meta"]
        leaves = handle.migration["leaves"]
        trace = handle.trace
        t_pack = time.monotonic()
        payload = kvc.pack_migration(meta, leaves)
        t_send = time.monotonic()
        pack_span = None
        if trace is not None:
            pack_span = trace.hop(
                "migrate.pack", reqtrace.mono_to_wall_ms(t_pack),
                reqtrace.mono_to_wall_ms(t_send),
                attrs={"bytes": len(payload)})
        resp, target = self._post_migration(
            payload, trace=handle.trace_ctx, parent_span=pack_span)
        if resp is not None:
            if trace is not None:
                # POST issued -> the decode replica's headers back (it
                # admitted the handoff); its decode is its own hop
                trace.hop("migrate.transfer",
                          reqtrace.mono_to_wall_ms(t_send),
                          reqtrace.mono_to_wall_ms(time.monotonic()),
                          attrs={"bytes": len(payload),
                                 "target": str(target)},
                          parent_id=pack_span)
            lines = self._lines_from(resp)
        else:
            LOG.warning("request %d: no decode replica accepted the "
                        "migration; finishing locally", handle.request_id)
            try:
                local = self.engine.submit_migration(meta, leaves)
            except (BudgetExceededError, QueueFullError, DrainingError,
                    RuntimeError) as e:
                return self._error(
                    503, f"migration failed and local fallback refused: "
                         f"{e}")
            lines = self._lines_from_handle(local)
        self._finish_migrated(handle, lines, bool(req.get("stream")))
        self._finish_out_trace(handle)

    def _finish_out_trace(self, handle) -> None:
        """Sample a migrated-out request after the relay: its duration is
        what the client saw."""
        if self.collector is None or handle.trace is None:
            return
        duration_ms = 1000.0 * (time.monotonic() - handle.submitted_at)
        self.collector.finish(handle.trace, duration_ms, migrated=True)

    def _post_migration(self, payload: bytes, trace=None,
                        parent_span: Optional[str] = None):
        """Round robin over the decode replicas; an HTTP refusal or a
        transport error tries the next one. Returns (the open streaming
        response, its target), or (None, None) when every target refused.
        The trace context rides X-Tony-Trace, parented under the pack
        hop, so the decode replica continues the same trace."""
        targets = [t.rstrip("/") for t in self.migrate_targets if t]
        if not targets:
            return None, None
        headers = {"Content-Type": "application/octet-stream"}
        if trace is not None:
            fwd = (trace.child(parent_span, trace.route_ms)
                   if parent_span else trace)
            headers[reqtrace.HEADER] = fwd.header_value()
        first = next(self.migrate_rr) % len(targets)
        for i in range(len(targets)):
            base = targets[(first + i) % len(targets)]
            rq = urllib.request.Request(base + "/v1/migrate", data=payload,
                                        headers=headers)
            try:
                resp = urllib.request.urlopen(
                    rq, timeout=STREAM_TOKEN_TIMEOUT_SEC)
            except urllib.error.HTTPError as e:
                LOG.debug("migrate to %s refused: HTTP %s", base, e.code)
                e.close()
                continue
            except OSError as e:
                LOG.debug("migrate to %s failed: %s", base, e)
                continue
            hook = self.on_migrated
            if hook is not None:
                try:
                    hook(base)
                except Exception:  # noqa: BLE001 — observability only
                    LOG.debug("on_migrated hook failed", exc_info=True)
            return resp, base
        return None, None

    @staticmethod
    def _lines_from(resp):
        """JSON objects from a decode replica's chunked line stream."""
        with resp:
            for raw in resp:
                raw = raw.strip()
                if raw:
                    yield json.loads(raw)

    @staticmethod
    def _lines_from_handle(local):
        """The local fallback's equivalent of the decode line stream."""
        for token in local.iter_tokens(timeout=STREAM_TOKEN_TIMEOUT_SEC):
            yield {"token": token}
        yield {"done": True, "finish_reason": local.finish_reason}

    def _finish_migrated(self, handle, lines, stream: bool) -> None:
        """Relay the decode side's token lines to the client behind the
        prefill token. n_tokens and tokens include it; ttft_s is this
        replica's (the client had its first token before the handoff)."""
        tok0 = handle.tokens[0]
        tokens = [tok0]
        finish = "length"
        chunk = self._start_chunks() if stream else None
        try:
            if chunk is not None:
                chunk({"token": tok0})
            try:
                for obj in lines:
                    if obj.get("done"):
                        finish = str(obj.get("finish_reason") or finish)
                        break
                    token = int(obj["token"])
                    tokens.append(token)
                    if chunk is not None:
                        chunk({"token": token})
            except (OSError, ValueError, KeyError, TimeoutError):
                finish = "migrate_error"
            if chunk is None:
                return self._json({"tokens": tokens,
                                   "finish_reason": finish,
                                   "ttft_s": handle.ttft_s,
                                   "migrated": True})
            chunk({"done": True, "finish_reason": finish,
                   "n_tokens": len(tokens), "ttft_s": handle.ttft_s,
                   "migrated": True})
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            LOG.debug("migrated stream aborted (request %d)",
                      handle.request_id)
            self.close_connection = True


def install_engine_tracing(engine: ContinuousBatchingEngine,
                           collector) -> None:
    """Compose request tracing onto engine.on_request_finished: the
    engine-phase hops off the handle's stamps, the tail-sampling finish
    and the TTFT attribution. A migrated-out handle is finished by the
    frontend after the relay instead. Chains the hook already installed
    (the serve_request span)."""
    prev = engine.on_request_finished

    def _on_finished(handle) -> None:
        trace = handle.trace
        if trace is not None:
            reqtrace.record_engine_phases(trace, handle)
            if handle.finish_reason != "migrated":
                ctx = handle.trace_ctx
                route_ms = ctx.route_ms if ctx is not None else 0.0
                duration_ms = (1000.0 * (handle.finished_at
                                         - handle.submitted_at)
                               if handle.finished_at else 0.0)
                collector.finish(
                    trace, duration_ms,
                    error=handle.finish_reason in ("error", "shutdown"),
                    migrated=handle.migrated_in)
                collector.attribution.record(
                    reqtrace.attribution_from_handle(
                        handle, route_ms=route_ms))
        if prev is not None:
            prev(handle)

    engine.on_request_finished = _on_finished


class ServeFrontend:
    """Owns the HTTP server; the engine's lifecycle belongs to the caller
    (serve/__main__ starts the engine loop, tests may drive it manually)."""

    def __init__(self, engine: ContinuousBatchingEngine, port: int = 0,
                 host: str = "0.0.0.0", migrate_targets=(),
                 on_migrated=None, collector=None):
        self.engine = engine
        self.collector = collector
        from tony_tpu_torch.serve.router import BurstBacklogHTTPServer
        handler = type("BoundHandler", (_Handler,), {
            "engine": engine,
            "migrate_targets": tuple(migrate_targets or ()),
            "migrate_rr": itertools.count(),
            "on_migrated": (staticmethod(on_migrated)
                            if on_migrated is not None else None),
            "collector": collector,
            "path_counts": {},
            "path_counts_lock": threading.Lock()})
        self._httpd = BurstBacklogHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serve-http", daemon=True)

    def start(self) -> None:
        self._thread.start()
        LOG.info("serving /v1/generate on port %d (%d slots, budget %d, "
                 "queue %d)", self.port, self.engine.n_slots,
                 self.engine.token_budget, self.engine.queue_depth)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10.0)
