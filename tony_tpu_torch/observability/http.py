"""Minimal ``/metrics`` scrape endpoint (the AM's).

The port's copy of `tony_tpu/observability/http.py`.

Same stdlib ThreadingHTTPServer idiom as portal/server.py and
serve/frontend.py — scraping is read-only observability, off every hot
path. The render callable is invoked per request so the scrape always
sees current state; a render failure answers 500 and never propagates
into the host process.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import urlparse

from tony_tpu_torch.observability.prometheus import CONTENT_TYPE

LOG = logging.getLogger(__name__)


class _Handler(BaseHTTPRequestHandler):
    render: Callable[[], str]   # injected by MetricsHTTPServer

    def log_message(self, fmt, *args):  # route through logging, not stderr
        LOG.debug("metrics-http: " + fmt, *args)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        path = urlparse(self.path).path.rstrip("/") or "/"
        if path not in ("/", "/metrics"):
            self._send(404, "not found\n", "text/plain; charset=utf-8")
            return
        try:
            body = type(self).render()
        except Exception:  # noqa: BLE001 — scrape must not crash the host
            LOG.exception("metrics render failed")
            self._send(500, "metrics render failed\n",
                       "text/plain; charset=utf-8")
            return
        self._send(200, body, CONTENT_TYPE)

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class MetricsHTTPServer:
    def __init__(self, render: Callable[[], str], port: int = 0,
                 host: str = "0.0.0.0"):
        handler = type("BoundHandler", (_Handler,),
                       {"render": staticmethod(render)})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-http", daemon=True)

    def start(self) -> None:
        self._thread.start()
        LOG.info("/metrics scrape endpoint on port %d", self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
