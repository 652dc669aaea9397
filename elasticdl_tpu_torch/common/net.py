"""Small networking helpers shared by launchers and managers."""

from __future__ import annotations

import socket
from contextlib import closing
from typing import Callable, Tuple, TypeVar

T = TypeVar("T")


class PortBindError(RuntimeError):
    """A server lost the free_port() TOCTOU race: the port looked free when
    picked but was taken (EADDRINUSE) by the time the server bound it."""


def free_port() -> int:
    """Pick an ephemeral port that was free a moment ago. Inherently TOCTOU
    — another process can grab it before the caller binds. Callers that go
    on to bind a server should do so through bind_with_retry(); the cohort
    coordinator (whose binder is a child process) instead retries whole
    world formations budget-free on ExitCode.WORLD_FORM_FAILED."""
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def bind_with_retry(
    build: Callable[[int], T], attempts: int = 5
) -> Tuple[int, T]:
    """Close the free_port() TOCTOU window: pick a fresh ephemeral port and
    call `build(port)` (which must bind it, raising PortBindError when the
    bind is lost to the race), retrying with a new port up to `attempts`
    times. Returns (port, build's result)."""
    last: PortBindError
    for _ in range(max(1, attempts)):
        port = free_port()
        try:
            return port, build(port)
        except PortBindError as e:
            last = e
    raise last
