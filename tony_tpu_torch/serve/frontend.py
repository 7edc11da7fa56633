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
- ``GET /v1/metrics`` — the engine's JSON gauge snapshot.
- ``GET /v1/load`` — the lock-free load probe a fleet router reads.

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

Not in this slice: ``/v1/drain`` with its token check, ``/v1/traces``,
Prometheus exposition and request tracing (the trace hops of the
migration relay included).
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

from tony_tpu_torch.serve import kvcache as kvc
from tony_tpu_torch.serve.engine import (
    BudgetExceededError, ContinuousBatchingEngine, DrainingError,
    QueueFullError,
)

LOG = logging.getLogger(__name__)

MAX_BODY_BYTES = 8 * 1024 * 1024
# migration payloads carry real K/V bytes (L*Hkv*pos*hd per leaf), far
# past the JSON request bound
MAX_MIGRATE_BYTES = 1024 * 1024 * 1024
# streaming stall guard: an engine wedged mid-request must not pin the
# handler thread forever
STREAM_TOKEN_TIMEOUT_SEC = 300.0


class BurstBacklogHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for bursts: the
    stdlib default of 5 overflows under a few dozen concurrent opens and
    the spilled SYNs come back 1 s or 3 s later (kernel retransmit), which
    reads as a made-up TTFT tail."""
    request_queue_size = 128
    daemon_threads = True


class _Handler(BaseHTTPRequestHandler):
    engine: ContinuousBatchingEngine      # injected by ServeFrontend
    migrate_targets: tuple = ()           # decode-replica base URLs
    migrate_rr = itertools.count()        # round-robin start, per frontend
    protocol_version = "HTTP/1.1"         # keep-alive + chunked streaming

    def log_message(self, fmt, *args):    # route through logging
        LOG.debug("serve: " + fmt, *args)

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
        path = urlparse(self.path).path.rstrip("/")
        if path == "/healthz":
            return self._json({"ok": True})
        if path == "/v1/load":
            return self._json({"ok": True, **self.engine.load()})
        if path == "/v1/metrics":
            return self._json(self.engine.snapshot())
        self._error(404, "not found")

    def do_POST(self):  # noqa: N802
        path = urlparse(self.path).path.rstrip("/")
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
        """The handle `submit(*args)` returns, or None after answering
        its refusal: 400 (can never fit), 429 (backpressure), 503
        (draining or stopped)."""
        try:
            return submit(*args, **kwargs)
        except BudgetExceededError as e:
            self._error(400, str(e))
        except QueueFullError as e:
            self._error(429, str(e), {"Retry-After": "1"})
        except DrainingError as e:
            self._error(503, str(e), {"X-Tony-Draining": "1"})
        except RuntimeError as e:           # engine stopped
            self._error(503, str(e))
        return None

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
        resp = self._post_migration(kvc.pack_migration(meta, leaves))
        if resp is not None:
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

    def _post_migration(self, payload: bytes):
        """Round robin over the decode replicas; an HTTP refusal or a
        transport error tries the next one. Returns the open streaming
        response, or None when every target refused."""
        targets = [t.rstrip("/") for t in self.migrate_targets if t]
        if not targets:
            return None
        first = next(self.migrate_rr) % len(targets)
        for i in range(len(targets)):
            base = targets[(first + i) % len(targets)]
            rq = urllib.request.Request(
                base + "/v1/migrate", data=payload,
                headers={"Content-Type": "application/octet-stream"})
            try:
                return urllib.request.urlopen(
                    rq, timeout=STREAM_TOKEN_TIMEOUT_SEC)
            except urllib.error.HTTPError as e:
                LOG.debug("migrate to %s refused: HTTP %s", base, e.code)
                e.close()
            except OSError as e:
                LOG.debug("migrate to %s failed: %s", base, e)
        return None

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


class ServeFrontend:
    """Owns the HTTP server; the engine's lifecycle belongs to the caller
    (serve/__main__ starts the engine loop, tests may drive it manually)."""

    def __init__(self, engine: ContinuousBatchingEngine, port: int = 0,
                 host: str = "0.0.0.0", migrate_targets=()):
        self.engine = engine
        handler = type("BoundHandler", (_Handler,), {
            "engine": engine,
            "migrate_targets": tuple(migrate_targets or ()),
            "migrate_rr": itertools.count()})
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
