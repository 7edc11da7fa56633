"""On-demand build + launch of the port's native host helpers.

The port's copy of `tony_tpu/utils/native.py`. The C++ helpers (epoll
TCP proxy, SO_REUSEPORT port reservation) live in the package itself
(`tony_tpu_torch/native/`, so a lone copy of the package carries them),
are compiled lazily with the system toolchain and cached in
`tony_tpu_torch/_build/native/`. Every caller has a pure-Python fallback,
so a missing compiler degrades gracefully instead of failing the job.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import threading
from typing import Optional

LOG = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build", "native")

_build_lock = threading.Lock()
_build_failed = False


def native_binary(name: str) -> Optional[str]:
    """Absolute path of a built native helper, building all helpers on
    first use; None if the toolchain is unavailable or the build fails."""
    global _build_failed
    path = os.path.join(BUILD_DIR, name)
    if os.path.isfile(path) and os.access(path, os.X_OK):
        return path
    with _build_lock:
        if _build_failed:
            return None
        if os.path.isfile(path):  # built while we waited for the lock
            return path
        if shutil.which("make") is None or shutil.which("g++") is None:
            LOG.info("no native toolchain; using pure-Python fallbacks")
            _build_failed = True
            return None
        try:
            # serializing the one-time native build IS this lock's
            # purpose; no control-plane path shares it
            # tony: disable=no-blocking-under-lock -- build lock, not control plane
            subprocess.run(["make", "-s", f"BUILD={BUILD_DIR}"],
                           cwd=NATIVE_DIR, check=True,
                           capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
            out = getattr(e, "stderr", b"") or b""
            LOG.warning("native build failed, using Python fallbacks: %s",
                        out.decode(errors="replace")[-500:])
            _build_failed = True
            return None
    return path if os.path.isfile(path) else None


def launch_native_proxy(remote_host: str, remote_port: int,
                        local_port: int = 0, token: str = ""):
    """Start the native proxy; returns (Popen, bound_local_port) or None if
    native is unavailable. Caller owns the process. `token` (passed via
    env, never argv) makes the relay require connection auth — see
    tony_tpu_torch/proxy.py module docstring for the protocol."""
    binary = native_binary("tony_proxy")
    if binary is None:
        return None
    argv = [binary, remote_host, str(remote_port)]
    if local_port:
        argv.append(str(local_port))
    env = dict(os.environ)
    if token:
        env["TONY_PROXY_TOKEN"] = token
    else:
        env.pop("TONY_PROXY_TOKEN", None)
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True, env=env)
    line = proc.stdout.readline()  # "proxying 127.0.0.1:<port> -> ..."
    try:
        bound = int(line.split("->")[0].strip().rsplit(":", 1)[1])
    except (IndexError, ValueError):
        proc.kill()
        LOG.warning("unexpected native proxy banner %r; falling back", line)
        return None
    return proc, bound


def launch_port_reservation(sentinel: str, n_ports: int = 1):
    """Hold n ports with SO_REUSEPORT from the native helper process
    (reference: ReusablePort.java:149-235 spawning its python helper).
    Returns (Popen, [ports]) or None if native is unavailable."""
    binary = native_binary("tony_portres")
    if binary is None:
        return None
    proc = subprocess.Popen([binary, sentinel, str(n_ports)],
                            stdout=subprocess.PIPE, text=True)
    ports = []
    for _ in range(n_ports):
        line = proc.stdout.readline().strip()
        if not line.isdigit():
            proc.kill()
            LOG.warning("unexpected portres output %r; falling back", line)
            return None
        ports.append(int(line))
    # wait for the readiness sentinel (bounded)
    import time
    deadline = time.monotonic() + 10
    while not os.path.exists(sentinel):
        if time.monotonic() > deadline or proc.poll() is not None:
            proc.kill()
            return None
        time.sleep(0.01)
    return proc, ports
