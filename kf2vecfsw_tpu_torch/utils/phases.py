"""The port's spans: per-phase wall time + dispatch counts for serving (the
port's copy of the JAX package's ``utils/phases.py``), and the same spans
marked on the profiler's clock whenever ``torch.profiler`` records.

classify/query wrap their model load / parse / host->device transfer /
forward dispatch / device fetch / text-format sections in `phase(...)` and
count forward dispatches, and the serve daemon reports the breakdown with
each placement. The trainers wrap a batch step and its parts
(``train.*``) and the lazy FSW refresh and its stages (``fsw.refresh*``).

Two sinks, each used only when it is on:
- a collector (`collect()`): host seconds per phase name into its dict.
  Thread-safe: the prefetch thread parses blocks while the main thread
  formats.
- a recording profiler (``torch.autograd._profiler_enabled()``): the phase
  enters ``torch.profiler.record_function("kf2vec." + name)``, a user
  annotation on the clock of the trace's device events, so that a trace
  (``utils/profiling.py``, a benchmark's window) can put the device's ops
  and idle gaps down to the phase that launched or left them.
With neither, `phase()` returns one shared null context: no generator, no
lock, no ``record_function`` (which costs microseconds a call even with no
profiler).

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
from contextlib import contextmanager, nullcontext

import torch

PREFIX = "kf2vec."  # the profiler's name of a phase: PREFIX + name

_lock = threading.Lock()
_active: dict[str, float] | None = None
_profiling = torch.autograd._profiler_enabled


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


_NULL = nullcontext()


class _Phase:
    __slots__ = ("name", "sink", "mark", "t0")

    def __init__(self, name: str, sink: dict | None, args: str | None):
        self.name, self.sink = name, sink
        self.mark = (torch.profiler.record_function(PREFIX + name, args) if _profiling()
                     else None)

    def __enter__(self):
        if self.mark is not None:
            self.mark.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.sink is not None:
            dt = time.perf_counter() - self.t0
            with _lock:
                self.sink[self.name] = self.sink.get(self.name, 0.0) + dt
        if self.mark is not None:
            self.mark.__exit__(*exc)
        return False


def phase(name: str, args: str | None = None):
    """A context timing ``name`` into the active collector and marking it in
    a recording profiler (``args``: the annotation's argument string)."""
    sink = _active  # capture THIS phase's collector (generation safety)
    if sink is None and not _profiling():
        return _NULL
    return _Phase(name, sink, args)


def count(name: str, n: int = 1) -> None:
    sink = _active
    if sink is None:
        return
    with _lock:
        sink[name] = sink.get(name, 0.0) + n
