"""Port reservation that closes the register-then-rebind race: the port's
copy of `tony_tpu/utils/ports.py`.

The executor announces its task's port to the AM before the user process
binds it. It holds the port with an SO_REUSEPORT listening socket until
`release()`, which it calls just before the user process starts; a user
process that sets SO_REUSEPORT can bind it even while it is held. Where
SO_REUSEPORT is missing the port is reserved and closed at once.
"""

from __future__ import annotations

import socket
from typing import Optional


class PortReservation:
    """Holds `port` open until release()."""

    def __init__(self, sock: Optional[socket.socket], port: int):
        self._sock = sock
        self.port = port

    def release(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self) -> "PortReservation":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def reserve_port(host: str = "") -> PortReservation:
    """Bind an ephemeral port and keep holding it (SO_REUSEPORT), or
    reserve it and close it where the platform lacks SO_REUSEPORT."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            sock.bind((host, 0))
            sock.listen(1)
            return PortReservation(sock, sock.getsockname()[1])
        sock.bind((host, 0))
        port = sock.getsockname()[1]
        sock.close()
        return PortReservation(None, port)
    except OSError:
        sock.close()
        raise
