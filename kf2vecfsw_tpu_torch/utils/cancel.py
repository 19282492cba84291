"""A request's cancel flag, set by the serve daemon's watchdog.

When the watchdog abandons a request that ran past its deadline, it cancels
the request's flag before it answers ``{"ok": false, "timeout": true}``.
Every stage of a request writes its output files only inside
``writing(flag, what)``, which raises ``Cancelled`` once the flag is set.
The cancel and the guarded writes hold one lock, and a guarded write flushes
its bytes before it lets go, so an abandoned handler writes nothing to its
output directory after the timeout reply. Outside the daemon a stage gets no
flag, and ``writing(None, what)`` guards nothing.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext


class Cancelled(RuntimeError):
    """The request was abandoned by the watchdog; nothing more is written."""


class CancelFlag:
    def __init__(self):
        self._lock = threading.Lock()
        self._set = threading.Event()

    def cancel(self) -> None:
        """Set the flag, after any guarded write in progress has ended."""
        with self._lock:
            self._set.set()

    def is_set(self) -> bool:
        return self._set.is_set()

    @contextmanager
    def writing(self, what: str):
        with self._lock:
            if self._set.is_set():
                raise Cancelled(f"request abandoned by the watchdog: not writing {what}")
            yield


def writing(flag: CancelFlag | None, what: str):
    """Guard one write of ``what`` (see the module docstring)."""
    return nullcontext() if flag is None else flag.writing(what)
