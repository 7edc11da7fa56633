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

Not in this slice: ``/v1/migrate``, ``/v1/drain`` with its token check,
``/v1/traces``, Prometheus exposition and request tracing.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

from tony_tpu_torch.serve.engine import (
    BudgetExceededError, ContinuousBatchingEngine, DrainingError,
    QueueFullError,
)

LOG = logging.getLogger(__name__)

MAX_BODY_BYTES = 8 * 1024 * 1024
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
        try:
            handle = self.engine.submit(prompt, max_new)
        except BudgetExceededError as e:
            return self._error(400, str(e))
        except QueueFullError as e:
            return self._error(429, str(e), {"Retry-After": "1"})
        except DrainingError as e:
            return self._error(503, str(e), {"X-Tony-Draining": "1"})
        except RuntimeError as e:           # engine stopped
            return self._error(503, str(e))
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
        self.send_response(200)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj) -> None:
            data = (json.dumps(obj) + "\n").encode("utf-8")
            self.wfile.write(f"{len(data):x}\r\n".encode("ascii")
                             + data + b"\r\n")

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


class ServeFrontend:
    """Owns the HTTP server; the engine's lifecycle belongs to the caller
    (serve/__main__ starts the engine loop, tests may drive it manually)."""

    def __init__(self, engine: ContinuousBatchingEngine, port: int = 0,
                 host: str = "0.0.0.0"):
        self.engine = engine
        handler = type("BoundHandler", (_Handler,), {"engine": engine})
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
