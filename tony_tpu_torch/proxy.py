"""TCP proxy: local port → cluster host relay.

The port's copy of `tony_tpu/proxy.py`. Equivalent of the reference's tony-proxy module
(tony-proxy/src/main/java/com/linkedin/tony/ProxyServer.java:21-91): a
blocking relay with two pump threads per connection, used by the notebook
path to expose an in-cluster notebook/TensorBoard port on the gateway host.

A native C++ implementation (tony_tpu_torch/native/tony_proxy.cc) provides the
production relay; this module is the pure-Python equivalent and the
launcher/fallback. Both speak plain TCP — nothing protocol-specific.

Connection auth (the reference relayed blindly): with a
`token` configured, a new connection must authenticate before any byte is
relayed, via one of
  - a raw preamble line ``TONY-PROXY-AUTH <token>\\n`` (stripped before
    relaying; for programmatic clients), or
  - an HTTP request whose first line carries ``?token=<token>`` or whose
    headers carry ``Authorization: Bearer <token>`` (forwarded unmodified;
    for browsers/notebooks — each new TCP connection re-authenticates).
Unauthenticated connections are closed without contacting the upstream
byte stream. Both implementations read the token from the
``TONY_PROXY_TOKEN`` env var when launched standalone (never argv — argv is
world-readable via /proc).

Browsers open extra parallel connections (assets, websockets) that carry
neither header nor query token, so one successful auth unlocks the source
for a sliding grace window (``_GRACE_SEC``). On a loopback listener the
source IP cannot distinguish local users, so the grace key is the peer
socket's owning UID (looked up in ``/proc/net/tcp``) — user A's auth never
unlocks user B; if the UID lookup fails, every connection must carry the
token. Non-loopback sources key by IP (the ssh port-forward trust model).
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time

LOG = logging.getLogger(__name__)

_BUF = 64 * 1024
_AUTH_PREAMBLE = b"TONY-PROXY-AUTH "
_AUTH_MAX = 8 * 1024          # auth must fit the first 8 KB
_AUTH_TIMEOUT_SEC = 10.0
_GRACE_SEC = 600.0            # sliding source-address unlock window
TOKEN_ENV = "TONY_PROXY_TOKEN"


def _set_keepalive(sock: socket.socket) -> None:
    """Dead-peer reaper: a client that vanishes without FIN/RST (laptop
    sleep, NAT drop) would otherwise block both pump threads in recv()
    forever — keepalive bounds that at ~2 min without killing live-but-
    idle websockets (an idle timeout would)."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPIDLE, 60)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPINTVL, 20)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPCNT, 3)
    except (OSError, AttributeError):   # non-Linux: best effort
        pass


def _peer_uid(ip: str, port: int) -> int | None:
    """UID owning the loopback peer socket, from /proc/net/tcp (the
    kernel's socket table records the owning uid per local endpoint)."""
    try:
        addr = struct.unpack("<I", socket.inet_aton(ip))[0]
    except OSError:
        return None
    want = f"{addr:08X}:{port:04X}"
    try:
        with open("/proc/net/tcp", "r", encoding="ascii") as f:
            next(f)   # header
            for line in f:
                parts = line.split()
                if len(parts) > 7 and parts[1] == want:
                    return int(parts[7])
    except (OSError, ValueError, StopIteration):
        pass
    return None


def _grace_key(peer: tuple[str, int]) -> str | None:
    """Key for the unlock map, or None when no grace may apply."""
    ip, port = peer
    if ip.startswith("127.") or ip == "::1":
        uid = _peer_uid(ip, port)
        return None if uid is None else f"uid:{uid}"
    return f"ip:{ip}"


def _pump(src: socket.socket, dst: socket.socket) -> None:
    """One relay direction. On EOF propagate ONLY a half-close (source's
    read side, sink's write side): tearing the whole pair down here races
    the opposite direction's in-flight response — a client that sends,
    half-closes, and reads (request/response over SHUT_WR) would lose the
    reply. The native relay's Pump has the same discipline."""
    try:
        while True:
            data = src.recv(_BUF)
            if not data:
                break
            dst.sendall(data)
    except OSError:
        pass
    finally:
        try:
            dst.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        try:
            src.shutdown(socket.SHUT_RD)
        except OSError:
            pass


def _token_match(supplied: bytes, tokens: tuple[str, ...]) -> bool:
    """Constant-time compare against EVERY accepted token (named per-user
    credentials + the shared one) — no early exit, so timing doesn't
    reveal which entry matched."""
    import hmac
    ok = False
    for tok in tokens:
        if hmac.compare_digest(supplied, tok.encode()):
            ok = True
    return ok


def _check_http_auth(buf: bytes, tokens: tuple[str, ...]) -> bool:
    """First-block HTTP auth: ?token= in the request line or an
    Authorization: Bearer header. All comparisons on BYTES —
    hmac.compare_digest raises TypeError for non-ASCII str operands, so a
    garbage token from a scanner must never reach a str compare."""
    head = buf.split(b"\r\n\r\n", 1)[0]
    lines = head.split(b"\r\n")
    request_line = lines[0]
    if b"?" in request_line and b" " in request_line:
        query = request_line.split(b" ")[1].partition(b"?")[2]
        for pair in query.split(b"&"):
            k, _, v = pair.partition(b"=")
            # a proxy-distinct param name: plain ?token= belongs to the
            # PROXIED app (Jupyter's login token uses it) — claiming it
            # would both collide with and shadow the app's own auth
            if k == b"tony-proxy-token" and _token_match(v, tokens):
                return True
    for ln in lines[1:]:
        if ln.lower().startswith(b"authorization:"):
            value = ln.split(b":", 1)[1].strip()
            if value.startswith(b"Bearer ") and _token_match(
                    value[len(b"Bearer "):].strip(), tokens):
                return True
    return False


def _authenticate(conn: socket.socket, tokens: tuple[str, ...],
                  grace: bool = False) -> tuple[bytes, bool] | None:
    """Read until an auth decision. Returns (bytes_to_forward,
    credentials_verified) or None to reject.

    With `grace` (source already unlocked), credentials are OPTIONAL — but
    a preamble line, if present, is still consumed and verified rather
    than relayed upstream as payload (it contains the token!); verifying
    it is what slides the unlock window."""

    def _bare(buf: bytes):
        # never bare-relay a (partial) preamble: it carries token bytes
        if buf and (buf.startswith(_AUTH_PREAMBLE)
                    or _AUTH_PREAMBLE.startswith(buf)):
            return None
        return (buf, False)

    conn.settimeout(_AUTH_TIMEOUT_SEC)
    buf = b""
    try:
        while len(buf) < _AUTH_MAX:
            try:
                chunk = conn.recv(_BUF)
            except TimeoutError:
                # a grace client that paused mid-stream is a bare relay;
                # a locked client that never authenticated is rejected
                return _bare(buf) if grace else None
            if not chunk:
                return _bare(buf) if grace and buf else None
            buf += chunk
            if len(buf) < len(_AUTH_PREAMBLE) and \
                    _AUTH_PREAMBLE.startswith(buf):
                continue   # could still become a preamble — keep reading
            if buf.startswith(_AUTH_PREAMBLE):
                if b"\n" not in buf:
                    continue
                line, _, rest = buf.partition(b"\n")
                supplied = line[len(_AUTH_PREAMBLE):].strip(b"\r")
                return (rest, True) if _token_match(supplied, tokens) \
                    else None
            if grace:
                return (buf, False)   # bare relay, no credentials needed
            if b"\n" in buf and (b"\r\n\r\n" in buf
                                 or len(buf) >= _AUTH_MAX):
                # HTTP mode: full header block (or cap) reached
                return (buf, True) if _check_http_auth(buf, tokens) \
                    else None
        return None
    except OSError:
        return None
    finally:
        try:
            conn.settimeout(None)
        except OSError:
            pass


class ProxyServer:
    """Listen on (local_host, local_port) and relay every connection to
    (remote_host, remote_port). With `token`, connections must authenticate
    first (see module docstring)."""

    def __init__(self, remote_host: str, remote_port: int,
                 local_port: int = 0, local_host: str = "127.0.0.1",
                 token: "str | list[str] | tuple[str, ...] | None" = None,
                 connect_wait_sec: float = 10.0):
        self._remote = (remote_host, remote_port)
        # one shared secret or a set of named per-user tokens — any
        # accepted entry authenticates (TonyPolicyProvider.java:23
        # multi-principal parity; the portal scopes visibility, the proxy
        # only gates the byte stream)
        self._token: tuple[str, ...] | None = (
            (token,) if isinstance(token, str) else
            tuple(token) if token else None)
        self._connect_wait = connect_wait_sec
        self._unlocked: dict[str, float] = {}   # grace key -> expiry
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((local_host, local_port))
        self._listener.listen(16)
        self.local_port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, name="proxy",
                                        daemon=True)
        # shared upstream-liveness probe: when the upstream is down, ONE
        # handler polls and the rest wait on this event, so a connection
        # burst (or a port scanner) does not accumulate a 0.25s poll loop
        # per client thread for up to connect_wait_sec each
        self._up_lock = threading.Lock()
        self._up_event = threading.Event()

    def _dial_upstream(self, deadline: float) -> socket.socket | None:
        """Dial the upstream with a bounded wait. Every handler gets one
        immediate attempt; while the upstream is down only ONE elected
        handler runs the 0.25s retry loop (no separate probe connection —
        its successful dial IS its relay socket, so single-accept
        upstreams are not disturbed) and the rest park on _up_event."""
        try:
            s = socket.create_connection(self._remote, timeout=10)
            # the timeout bounds the CONNECT only; left in place it would
            # tear the relay down on any 10s-idle gap (recv timeout in
            # _pump)
            s.settimeout(None)
            self._up_event.set()
            return s
        except OSError:
            pass
        while not self._stop.is_set():
            if deadline - time.monotonic() <= 0:
                return None
            if self._up_lock.acquire(blocking=False):
                try:  # elected prober: the only thread that poll-loops
                    self._up_event.clear()
                    while (not self._stop.is_set()
                           and deadline - time.monotonic() > 0):
                        try:
                            s = socket.create_connection(self._remote,
                                                         timeout=10)
                            s.settimeout(None)
                            self._up_event.set()
                            return s
                        except OSError:
                            time.sleep(0.25)
                    return None
                finally:
                    self._up_lock.release()
            remaining = min(deadline - time.monotonic(), 0.5)
            if remaining > 0 and self._up_event.wait(timeout=remaining):
                try:  # prober saw the upstream come up — dial for myself
                    s = socket.create_connection(self._remote, timeout=10)
                    s.settimeout(None)
                    return s
                except OSError:
                    continue  # raced a fresh outage; re-elect
        return None

    def start(self) -> None:
        LOG.info("proxy 127.0.0.1:%d -> %s:%d%s", self.local_port,
                 self._remote[0], self._remote[1],
                 " (token auth)" if self._token else "")
        self._thread.start()

    def _handle(self, conn: socket.socket,
                peer: tuple[str, int] = ("", 0)) -> None:
        initial = b""
        now = time.monotonic()
        if self._token is not None:
            key = _grace_key(peer)
            unlocked = key is not None and self._unlocked.get(key,
                                                              0.0) > now
            result = _authenticate(conn, self._token, grace=unlocked)
            if result is None:
                LOG.warning("proxy: unauthenticated connection rejected")
                conn.close()
                return
            initial, verified = result
            # the window extends ONLY when credentials were verified:
            # bare connections riding the unlock must not keep it open
            # forever (an unauthenticated poller would never expire)
            if verified and key is not None:
                self._unlocked[key] = now + _GRACE_SEC
        # Bounded connect retry: a notebook/TB URL is registered when its
        # port is RESERVED, which can precede the server actually listening
        # (the reference's NotebookSubmitter proxies as soon as the URL
        # appears in TaskInfos and has the same bring-up gap). Refused
        # connections retry until the wait budget runs out.
        upstream = self._dial_upstream(
            time.monotonic() + self._connect_wait)
        if upstream is None:
            LOG.warning("cannot reach %s:%d", *self._remote)
            conn.close()
            return
        _set_keepalive(conn)
        _set_keepalive(upstream)
        if initial:
            try:
                upstream.sendall(initial)
            except OSError:
                conn.close()
                upstream.close()
                return
        threading.Thread(target=_pump, args=(conn, upstream),
                         daemon=True).start()
        threading.Thread(target=_pump, args=(upstream, conn),
                         daemon=True).start()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._listener.accept()
            except OSError:
                return
            # _handle blocks (auth reads; upstream connect retry while the
            # notebook server binds) — never stall the accept loop, or
            # parallel browser connections serialize behind one retry
            threading.Thread(target=self._handle, args=(conn, addr),
                             daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass


def auth_preamble(token: str) -> bytes:
    """Bytes a programmatic client sends first on a token-guarded proxy."""
    return _AUTH_PREAMBLE + token.encode() + b"\n"


def main(argv: list[str] | None = None) -> int:
    import os
    import sys
    args = argv if argv is not None else sys.argv[1:]
    if len(args) not in (2, 3):
        print("usage: python -m tony_tpu_torch.proxy <remote_host> <remote_port> "
              "[local_port]   (set TONY_PROXY_TOKEN to require auth)",
              file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO)
    proxy = ProxyServer(args[0], int(args[1]),
                        int(args[2]) if len(args) == 3 else 0,
                        token=os.environ.get(TOKEN_ENV) or None)
    proxy.start()
    print(f"proxying 127.0.0.1:{proxy.local_port} -> {args[0]}:{args[1]}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        proxy.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
