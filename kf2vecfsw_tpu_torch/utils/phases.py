"""Serving phase accounting: per-phase wall time + dispatch counts (the
port's copy of the JAX package's ``utils/phases.py``).

classify/query wrap their model load / parse / host->device transfer /
forward dispatch / device fetch / text-format sections in `phase(...)` and
count forward dispatches, and the serve daemon reports the breakdown with
each placement. Zero overhead when no collector is active (module-level
None check). Thread-safe: the prefetch thread parses blocks while the main
thread formats.

Generation safety: a phase() CAPTURES the collector active at its entry and
writes to that object at exit, and collect() only clears the global if it is
still its own dict. A handler thread abandoned by the serve watchdog mid-
phase can therefore finish arbitrarily late without (a) writing its timings
into the NEXT request's collector, (b) nulling that collector, or (c)
mutating a dict another thread is iterating — the late write lands on the
stale request's own dict, which nobody reads.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_lock = threading.Lock()
_active: dict[str, float] | None = None


@contextmanager
def collect():
    """Activate collection; yields the dict of phase -> seconds (and
    'dispatches' -> count). Nested collects are not supported (serving
    entry points don't nest)."""
    global _active
    stats: dict[str, float] = {}
    with _lock:
        _active = stats
    try:
        yield stats
    finally:
        with _lock:
            if _active is stats:  # an abandoned thread must not null a
                _active = None  # NEWER request's collector


@contextmanager
def phase(name: str):
    sink = _active  # capture THIS phase's collector (generation safety)
    if sink is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            sink[name] = sink.get(name, 0.0) + dt


def count(name: str, n: int = 1) -> None:
    sink = _active
    if sink is None:
        return
    with _lock:
        sink[name] = sink.get(name, 0.0) + n

