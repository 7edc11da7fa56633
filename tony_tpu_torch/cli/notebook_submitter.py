"""NotebookSubmitter: interactive single-node app behind a local proxy.

Equivalent of cli/NotebookSubmitter.java:46-146: submit a single-node app
(the AM runs the user command itself as a "preprocessing job",
ApplicationMaster.java:531-545,713-765), wait for the notebook task URL to
appear in TaskInfos, then start a local TCP proxy so the user can reach the
in-cluster notebook from the gateway host.
"""

from __future__ import annotations

import logging
import threading
import time

from tony_tpu_torch.client.tony_client import TonyClient
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.proxy import ProxyServer
from tony_tpu_torch.utils.native import launch_native_proxy

LOG = logging.getLogger(__name__)

DEFAULT_TIMEOUT = "24h"  # reference appended a 24h timeout (:89-93)


class _Proxy:
    """Prefer the native epoll relay; fall back to the Python one.
    With security on, the app token guards every proxy connection."""

    def __init__(self, host: str, port: int, token: str | None = None):
        self._proc = None
        self._pyproxy = None
        launched = launch_native_proxy(host, port, token=token or "")
        if launched is not None:
            self._proc, self.local_port = launched
        else:
            self._pyproxy = ProxyServer(host, port, token=token)
            self._pyproxy.start()
            self.local_port = self._pyproxy.local_port

    def stop(self) -> None:
        if self._proc is not None:
            self._proc.kill()
            self._proc.wait()
        if self._pyproxy is not None:
            self._pyproxy.stop()


def submit(argv: list[str]) -> int:
    client = TonyClient()
    client.init(argv)
    client.conf.set(K.APPLICATION_SINGLE_NODE, True, "notebook")
    if not client.conf.get_time_ms(K.APPLICATION_TIMEOUT, 0):
        client.conf.set(K.APPLICATION_TIMEOUT, DEFAULT_TIMEOUT, "notebook")

    result = {"ok": False}

    def _run():
        result["ok"] = client.run()

    runner = threading.Thread(target=_run, name="notebook-client", daemon=True)
    runner.start()

    proxy = None
    try:
        # poll TaskInfos until a registered URL appears, then proxy to it
        # (NotebookSubmitter.java:107-130)
        while runner.is_alive() and proxy is None:
            for info in client.get_task_infos():
                if info.url.startswith("http://"):
                    hostport = info.url[len("http://"):].split("/", 1)[0]
                    host, _, port = hostport.rpartition(":")
                    if host and port.isdigit():
                        # with security on, a PROXY-SCOPED derived token
                        # guards connections — never the app secret or a
                        # task token: this token lands in browser
                        # history/referers, so it must carry transport
                        # access only (distinct HMAC namespace)
                        token = None
                        if client.auth_token:
                            from tony_tpu_torch.security.tokens import (
                                derive_proxy_token,
                            )
                            token = derive_proxy_token(client.auth_token,
                                                       "notebook")
                        proxy = _Proxy(host, int(port), token=token)
                        # tony-proxy-token, NOT token: the plain name is
                        # the proxied notebook's own login param
                        suffix = (f"/?tony-proxy-token={token}"
                                  if token else "")
                        print(f"notebook available at "
                              f"http://127.0.0.1:{proxy.local_port}{suffix}")
                        break
            time.sleep(1)
        runner.join()
    except KeyboardInterrupt:
        LOG.info("interrupted — killing notebook app")
        client.kill()
    finally:
        if proxy is not None:
            proxy.stop()
    return 0 if result["ok"] else -1
