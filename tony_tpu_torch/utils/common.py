"""Polling, env parsing, host, port, path and backoff helpers of the
client, the AM, the executor and the RPC clients.

The port's copy of `tony_tpu/utils/common.py`.
"""

from __future__ import annotations

import random
import socket
import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


def equal_jitter_backoff_sec(base_sec: float, max_sec: float, exponent: int,
                             rng: "random.Random") -> float:
    """Capped equal-jitter exponential backoff: uniform in [cap/2, cap] with
    cap = min(max_sec, base_sec * 2^exponent) (max_sec <= 0 means no cap);
    0 when base_sec <= 0 or exponent < 0. The lower bound spares a booting
    peer; the jitter keeps simultaneous retriers apart."""
    if base_sec <= 0 or exponent < 0:
        return 0.0
    cap = base_sec * (2 ** min(exponent, 30))
    if max_sec > 0:
        cap = min(max_sec, cap)
    return rng.uniform(cap / 2.0, cap)


def poll(func: Callable[[], bool], interval_sec: float, timeout_sec: float) -> bool:
    """Call `func` every `interval_sec` until it returns True or timeout.
    Returns whether it ever returned True (Utils.poll, util/Utils.java:89-109)."""
    deadline = time.monotonic() + timeout_sec
    while True:
        if func():
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(interval_sec)


def poll_till_non_null(func: Callable[[], Optional[T]], interval_sec: float,
                       timeout_sec: float) -> Optional[T]:
    """Call `func` until it returns non-None or timeout; returns the value or
    None (Utils.pollTillNonNull, util/Utils.java:111-143)."""
    deadline = time.monotonic() + timeout_sec
    while True:
        result = func()
        if result is not None:
            return result
        if time.monotonic() >= deadline:
            return None
        time.sleep(interval_sec)


def parse_env_list(entries: list[str]) -> dict[str, str]:
    """Parse ['A=1', 'B=x=y'] → {'A': '1', 'B': 'x=y'}
    (Utils.parseKeyValue, util/Utils.java:243-263)."""
    out: dict[str, str] = {}
    for entry in entries:
        if not entry:
            continue
        k, sep, v = entry.partition("=")
        out[k.strip()] = v if sep else ""
    return out


def framework_pythonpath() -> str:
    """The PYTHONPATH that makes `tony_tpu_torch` importable in a child
    process whatever its cwd: the package's parent directory, put in
    front of the inherited value unless it is there already."""
    import os
    import tony_tpu_torch
    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.abspath(tony_tpu_torch.__file__)))
    existing = os.environ.get("PYTHONPATH", "")
    if existing and pkg_parent not in existing.split(os.pathsep):
        return pkg_parent + os.pathsep + existing
    return existing if pkg_parent in existing.split(os.pathsep) else pkg_parent


def current_host() -> str:
    """Best-effort resolvable hostname for rendezvous registration."""
    host = socket.gethostname()
    try:
        socket.gethostbyname(host)
        return host
    except OSError:
        return "127.0.0.1"


def pick_free_port(host: str = "") -> int:
    """Bind an ephemeral port and return it, to announce to peers before
    the process that will serve it binds it."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]
