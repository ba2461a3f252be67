"""Process-level helpers: the part of parallel/compat.py of the JAX
package the port needs so far."""

from __future__ import annotations

import socket


def free_port() -> int:
    """An OS-assigned free TCP port for a server about to bind: the one
    definition shared by the supervisor (a fresh coordinator port per
    attempt, the fleet endpoint) and the tools that start servers."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
