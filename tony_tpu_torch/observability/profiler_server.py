"""The page behind a chief task's TensorBoard URL: on-demand profiles.

For the chief, the executor reserves ``TB_PORT`` and registers
``http://host:port`` with the AM as the task's TensorBoard URL; the portal
links to it. The JAX Trainer serves `jax.profiler.start_server` there.
torch has no profiler service, so the port's Trainer serves this small
HTTP server in front of its on-demand capture (`ProfileCapture`, whose
torch.profiler run writes a Chrome trace):

- ``GET /``: JSON status: the task, the capture in progress (or null) and
  the finished captures' ids.
- ``POST /v1/profile`` with ``{"num_steps": N}``: writes the executor's own
  request file (``profile_request.json`` in the task's cwd, atomically) and
  returns ``{"request_id": id}``. The Trainer picks it up at its next log
  boundary, as it does the executor's, so this server never syncs the
  device or touches the training loop. 409 while a capture is in progress
  or a request file waits.
- ``GET /v1/profile/<id>``: 202 while that capture waits or runs, then 200
  with its ``trace.json`` (loads in Perfetto or ``chrome://tracing``); 500
  if it failed, 404 for an id it never issued.

The server runs on daemon threads; the Trainer stops it when `run()`
ends.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from tony_tpu_torch.observability.perf import ProfileCapture

LOG = logging.getLogger(__name__)


class _Server(ThreadingHTTPServer):
    daemon_threads = True


class ProfilerServer:
    """Serves `capture()` (the Trainer's current `ProfileCapture`: a
    re-setup builds a new one) on `port` of every interface (0 picks a
    free one)."""

    def __init__(self, port: int, capture: Callable[[], ProfileCapture],
                 task: str = ""):
        self.task = task
        self._capture = capture
        self._issued: set[str] = set()
        self._lock = threading.Lock()
        handler = type("Handler", (_Handler,), {"owner": self})
        self._httpd = _Server(("", port), handler)
        # a short poll: stop() waits for the loop to see it, at the end of
        # the Trainer's run
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="profiler-server", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)

    # -- what the handler asks ------------------------------------------
    def status(self) -> dict:
        cap = self._capture()
        return {"task": self.task, "active": cap.active_request,
                "captures": sorted(cap.finished)}

    def request(self, num_steps: int) -> Optional[str]:
        """Write a request file for a new capture; None while one is in
        progress or a request file waits."""
        cap = self._capture()
        with self._lock:
            path = cap.request_path
            if cap.active or os.path.exists(path):
                return None
            rid = uuid.uuid4().hex
            tmp = f"{path}.{rid}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"request_id": rid, "num_steps": num_steps}, f)
            os.replace(tmp, path)
            self._issued.add(rid)
        LOG.info("profile request %s (%d steps) written to %s", rid,
                 num_steps, path)
        return rid

    def capture_state(self, rid: str) -> tuple[str, Optional[str]]:
        """("done", trace path) | ("failed", None) | ("waiting", None) |
        ("unknown", None)."""
        cap = self._capture()
        if rid in cap.finished:
            return "done", os.path.join(cap.finished[rid], "trace.json")
        if rid in cap.failed:
            return "failed", None
        with self._lock:
            issued = rid in self._issued
        return ("waiting" if issued else "unknown"), None


class _Handler(BaseHTTPRequestHandler):
    owner: ProfilerServer                 # bound per server

    def log_message(self, fmt, *args):    # route through logging
        LOG.debug("profiler server: " + fmt, *args)

    def _json(self, obj, code: int = 200) -> None:
        data = (json.dumps(obj) + "\n").encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "":
            return self._json(self.owner.status())
        prefix = "/v1/profile/"
        if not path.startswith(prefix):
            return self._json({"error": "not found"}, 404)
        rid = path[len(prefix):]
        state, trace = self.owner.capture_state(rid)
        if state == "waiting":
            return self._json({"request_id": rid, "state": state}, 202)
        if state == "unknown":
            return self._json({"error": f"no capture {rid}"}, 404)
        if state == "failed":
            return self._json({"request_id": rid,
                               "error": "the capture failed"}, 500)
        try:
            with open(trace, "rb") as f:
                data = f.read()
        except OSError as e:
            return self._json({"request_id": rid, "error": str(e)}, 500)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)
        return None

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path.split("?", 1)[0].rstrip("/") != "/v1/profile":
            return self._json({"error": "not found"}, 404)
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            steps = body.get("num_steps", 1)
            if isinstance(steps, bool) or not isinstance(steps, int) \
                    or steps < 1:
                raise ValueError(f"num_steps {steps!r}")
        except (ValueError, AttributeError) as e:
            return self._json({"error": f"bad request: {e}"}, 400)
        rid = self.owner.request(steps)
        if rid is None:
            return self._json({"error": "a capture is in progress"}, 409)
        return self._json({"request_id": rid, "num_steps": steps})
