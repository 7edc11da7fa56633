"""The port's proxy relays against the JAX package's.

The JAX package's `tests/test_proxy.py` cases (the pure-Python relay:
plain relaying, the token preamble and HTTP auth, the grace window and
what may and may not extend it, a late upstream, named tokens) and
`tests/test_native.py` cases (the C++ relay and port reservation, built
on first use) run on both packages. The port builds its own copy of the
helpers' sources, kept inside the package, into `_build/native/`. The
notebook submitter's relay setup (native, else Python) is the JAX one.
"""

from __future__ import annotations

import os
import shutil
import socket
import threading
import time
from types import SimpleNamespace

import pytest

from conftest import recv_all as _recv_all  # shared relay-test helpers
from tony_tpu import proxy as jproxy
from tony_tpu.utils import native as jnative
from tony_tpu_torch import proxy as pproxy
from tony_tpu_torch.utils import native as pnative

PKGS = {"jax": SimpleNamespace(proxy=jproxy, native=jnative),
        "port": SimpleNamespace(proxy=pproxy, native=pnative)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def toolchain():
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("no native toolchain (g++ and make)")


def _conn(port):
    return socket.create_connection(("127.0.0.1", port), timeout=5)


# ---------------------------------------------------------------------------
# the pure-Python relay
# ---------------------------------------------------------------------------

def test_python_proxy_relays_without_token(pkg, echo_server):
    proxy = pkg.proxy.ProxyServer("127.0.0.1", echo_server)
    proxy.start()
    try:
        with _conn(proxy.local_port) as s:
            s.sendall(b"hello relay")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b"HELLO RELAY"
    finally:
        proxy.stop()


def test_python_proxy_token_auth(pkg, echo_server):
    """Unauthenticated connections forward nothing; preamble/HTTP auth
    both work; one success unlocks the source for the grace window."""
    proxy = pkg.proxy.ProxyServer("127.0.0.1", echo_server, token="tok123")
    preamble = pkg.proxy.auth_preamble
    proxy.start()
    try:
        for payload in (
                b"no auth\n",
                b"GET / HTTP/1.1\r\nHost: x\r\n"
                b"Authorization: Bearer wrong\r\n\r\n",
                b"TONY-PROXY-AUTH \xe9\xff\n",
                b"GET /?tony-proxy-token=\xe9 HTTP/1.1\r\nHost: x\r\n\r\n",
                # plain ?token= belongs to the proxied app, never to us
                b"GET /?token=tok123 HTTP/1.1\r\nHost: x\r\n\r\n"):
            with _conn(proxy.local_port) as s:
                s.sendall(payload)
                s.shutdown(socket.SHUT_WR)
                assert _recv_all(s) == b"", payload
        with _conn(proxy.local_port) as s:
            s.sendall(preamble("tok123") + b"hello")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b"HELLO"
        # grace window: same source now relays without credentials
        with _conn(proxy.local_port) as s:
            s.sendall(b"bare after unlock")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b"BARE AFTER UNLOCK"
        # a preamble during the grace window is still consumed/verified
        with _conn(proxy.local_port) as s:
            s.sendall(preamble("tok123") + b"again")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b"AGAIN"
        with _conn(proxy.local_port) as s:
            s.sendall(b"TONY-PROXY-AUTH wrong\npayload")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b""
    finally:
        proxy.stop()


def test_python_proxy_http_auth_modes(pkg, echo_server):
    for req in (
            b"GET / HTTP/1.1\r\nHost: x\r\n"
            b"Authorization: Bearer tok123\r\n\r\n",
            b"GET /tree?a=b&tony-proxy-token=tok123 HTTP/1.1\r\n"
            b"Host: x\r\n\r\n"):
        proxy = pkg.proxy.ProxyServer("127.0.0.1", echo_server,
                                      token="tok123")
        proxy.start()
        try:
            with _conn(proxy.local_port) as s:
                s.sendall(req)
                s.shutdown(socket.SHUT_WR)
                assert _recv_all(s) == req.upper()   # forwarded unmodified
        finally:
            proxy.stop()


def test_python_proxy_grace_not_extended_by_bare_conns(pkg, echo_server,
                                                       monkeypatch):
    """Only authenticated connections slide the unlock window."""
    monkeypatch.setattr(pkg.proxy, "_GRACE_SEC", 3.0)
    proxy = pkg.proxy.ProxyServer("127.0.0.1", echo_server, token="tok123")
    proxy.start()
    try:
        t0 = time.monotonic()
        with _conn(proxy.local_port) as s:
            s.sendall(pkg.proxy.auth_preamble("tok123") + b"a")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b"A"
        for target in (1.0, 2.0):
            time.sleep(max(0.0, t0 + target - time.monotonic()))
            with _conn(proxy.local_port) as s:
                s.sendall(b"bare")
                s.shutdown(socket.SHUT_WR)
                assert _recv_all(s) == b"BARE"
        time.sleep(max(0.0, t0 + 3.6 - time.monotonic()))   # expired
        with _conn(proxy.local_port) as s:
            s.sendall(b"bare late\n")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b""
    finally:
        proxy.stop()


def test_python_proxy_waits_for_late_upstream(pkg):
    placeholder = socket.socket()
    placeholder.bind(("127.0.0.1", 0))
    port = placeholder.getsockname()[1]
    placeholder.close()

    proxy = pkg.proxy.ProxyServer("127.0.0.1", port, connect_wait_sec=8.0)
    proxy.start()

    def bind_late():
        time.sleep(1.0)
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(1)
        conn, _ = srv.accept()
        conn.sendall(_recv_all(conn).upper())
        conn.shutdown(socket.SHUT_WR)
        conn.close()
        srv.close()

    t = threading.Thread(target=bind_late, daemon=True)
    t.start()
    try:
        with _conn(proxy.local_port) as s:
            s.sendall(b"late bind")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b"LATE BIND"
    finally:
        proxy.stop()
        t.join(timeout=10)
    assert not t.is_alive()


def test_python_proxy_accepts_any_named_token(pkg, echo_server):
    proxy = pkg.proxy.ProxyServer("127.0.0.1", echo_server,
                                  token=["tok-alice", "tok-bob"])
    proxy.start()
    try:
        for tok in ("tok-alice", "tok-bob"):
            with _conn(proxy.local_port) as s:
                s.sendall(pkg.proxy.auth_preamble(tok) + b"hi")
                s.shutdown(socket.SHUT_WR)
                assert _recv_all(s) == b"HI"
        with _conn(proxy.local_port) as s:
            s.sendall(pkg.proxy.auth_preamble("tok-mallory") + b"hi")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b""
    finally:
        proxy.stop()


def test_the_auth_preamble_is_the_jax_relays():
    for tok in ("tok123", "x" * 64):
        assert pproxy.auth_preamble(tok) == jproxy.auth_preamble(tok)
    assert pproxy._GRACE_SEC == jproxy._GRACE_SEC


# ---------------------------------------------------------------------------
# the native relay and port reservation
# ---------------------------------------------------------------------------

def test_native_binaries_build(pkg, toolchain):
    proxy, portres = (pkg.native.native_binary("tony_proxy"),
                      pkg.native.native_binary("tony_portres"))
    assert proxy is not None and portres is not None
    if pkg is PKGS["port"]:
        assert os.path.dirname(proxy) == pnative.BUILD_DIR
        assert pnative.BUILD_DIR.endswith(os.path.join(
            "tony_tpu_torch", "_build", "native"))


def test_the_native_sources_are_the_jax_packages():
    for name in ("tony_proxy.cc", "tony_portres.cc"):
        with open(os.path.join(jnative.NATIVE_DIR, name)) as f:
            jax_src = f.read()
        with open(os.path.join(pnative.NATIVE_DIR, name)) as f:
            port_src = f.read()
        def code(src):
            return [ln for ln in src.splitlines()
                    if not ln.lstrip().startswith("//")]
        assert code(port_src) == code(jax_src)


def _native_proxy(pkg, echo_server, token=""):
    launched = pkg.native.launch_native_proxy("127.0.0.1", echo_server,
                                              token=token)
    assert launched is not None
    return launched


def test_native_proxy_relays_both_directions(pkg, toolchain, echo_server):
    proc, port = _native_proxy(pkg, echo_server)
    try:
        payload = b"hello tpu proxy " * 1000   # multi-buffer payload
        with _conn(port) as s:
            s.sendall(payload)
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == payload.upper()
    finally:
        proc.kill()
        proc.wait()


def test_native_proxy_concurrent_connections(pkg, toolchain, echo_server):
    proc, port = _native_proxy(pkg, echo_server)
    try:
        socks = [_conn(port) for _ in range(8)]
        for i, s in enumerate(socks):
            s.sendall(f"conn{i}".encode())
        for i, s in enumerate(socks):
            assert s.recv(100) == f"CONN{i}".upper().encode()
        for s in socks:
            s.close()
    finally:
        proc.kill()
        proc.wait()


def test_native_proxy_token_auth(pkg, toolchain, echo_server):
    proc, port = _native_proxy(pkg, echo_server, token="tok123")
    try:
        for payload in (
                b"sneaky payload\n",
                b"TONY-PROXY-AUTH wrong\npayload",
                b"GET /?tony-proxy-token=no HTTP/1.1\r\nHost: x\r\n\r\n",
                b"GET /?token=tok123 HTTP/1.1\r\nHost: x\r\n\r\n",
                b"GET / HTTP/1.1\r\nAuthorization: Bearer no\r\n\r\n"):
            with _conn(port) as s:
                s.sendall(payload)
                s.shutdown(socket.SHUT_WR)
                assert _recv_all(s) == b"", payload
        with _conn(port) as s:
            s.sendall(b"TONY-PROXY-AUTH tok123\nhello")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b"HELLO"
        with _conn(port) as s:
            s.sendall(b"bare after unlock")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b"BARE AFTER UNLOCK"
        with _conn(port) as s:
            s.sendall(b"TONY-PROXY-AUTH tok123\nagain")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b"AGAIN"
        with _conn(port) as s:
            s.sendall(b"TONY-PROXY-AUTH wrong\npayload")
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == b""
    finally:
        proc.kill()
        proc.wait()


def test_native_proxy_http_auth_modes(pkg, toolchain, echo_server):
    for req in (
            b"GET / HTTP/1.1\r\nHost: x\r\n"
            b"Authorization: Bearer tok123\r\n\r\n",
            b"GET /tree?a=b&tony-proxy-token=tok123 HTTP/1.1\r\n"
            b"Host: x\r\n\r\n"):
        proc, port = _native_proxy(pkg, echo_server, token="tok123")
        try:
            with _conn(port) as s:
                s.sendall(req)
                s.shutdown(socket.SHUT_WR)
                assert _recv_all(s) == req.upper()
        finally:
            proc.kill()
            proc.wait()


def test_native_proxy_auth_payload_larger_than_first_read(pkg, toolchain,
                                                          echo_server):
    proc, port = _native_proxy(pkg, echo_server, token="tok123")
    try:
        payload = b"x" * (20 * 1024)
        with _conn(port) as s:
            s.sendall(b"TONY-PROXY-AUTH tok123\n" + payload)
            s.shutdown(socket.SHUT_WR)
            assert _recv_all(s) == payload.upper()
    finally:
        proc.kill()
        proc.wait()


def test_port_reservation_holds_and_reuseport_binds(pkg, toolchain,
                                                    tmp_path):
    sentinel = str(tmp_path / "ready")
    launched = pkg.native.launch_port_reservation(sentinel, n_ports=2)
    assert launched is not None
    proc, ports = launched
    try:
        assert len(ports) == 2 and os.path.exists(sentinel)
        plain = socket.socket()
        plain.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        with pytest.raises(OSError):
            plain.bind(("", ports[0]))
        plain.close()
        reuser = socket.socket()
        reuser.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        reuser.bind(("", ports[0]))
        reuser.close()
    finally:
        proc.terminate()
        assert proc.wait(timeout=5) == 0


def test_the_notebook_submitter_is_the_jax_ones():
    """The submitter the port's `cli notebook` runs: the JAX module with
    only its imports swapped."""
    from tony_tpu.cli import notebook_submitter as jnb
    from tony_tpu_torch.cli import notebook_submitter as pnb
    with open(jnb.__file__) as f:
        jax_src = f.read()
    with open(pnb.__file__) as f:
        port_src = f.read()
    assert port_src == jax_src.replace("tony_tpu.", "tony_tpu_torch.")
