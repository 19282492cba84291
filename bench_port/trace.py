"""Spans of the benchmark's own and the device trace of a window.

A ``Tracer`` times named spans on the host clock in every run. In a traced
run (``--trace 1``) it also runs ``torch.profiler`` (CPU and CUDA activity)
over the window and marks each span in the trace, so that the reduction
can say what the host was doing while the device idled. The profiler
records the CPU side of the thread that started it only, so every driver
runs its window on the main thread.

The reduction reads the raw events: the device's kernels, copies and fills
(the CUDA events that are not user annotations; a CPU op's device time
would count its kernels twice), clipped to the window span. Busy time is
the length of their union; the idle gaps are attributed to the innermost
benchmark span open at the gap's middle.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

PREFIX = "bench."
TOP = 10  # entries of each breakdown list
NAME_CHARS = 120  # a kernel's name in the breakdown, cut to this


class Tracer:
    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self.host_s: dict[str, float] = defaultdict(float)  # span name -> host seconds
        self.records: dict[str, list] = defaultdict(list)  # shapes recorded by wrappers
        self._prof = None
        self.reduced = None

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        ctx = (torch.profiler.record_function(PREFIX + name) if self._prof is not None
               else contextlib.nullcontext())
        try:
            with ctx:
                yield
        finally:
            self.host_s[name] += time.perf_counter() - t0

    @contextlib.contextmanager
    def window(self):
        """The measured window: profiled in a traced run, ended by a
        synchronise."""
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU]
                                 + ([ProfilerActivity.CUDA] if self.cuda else []))
            self._prof.__enter__()
        try:
            with self.span("window"):
                yield
                self.sync()
        finally:
            if self._prof is not None:
                self._prof.__exit__(None, None, None)
                self.reduced = reduce_events(self._prof.profiler.kineto_results.events())
                self._prof = None

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def wrap(self, module, attr: str, span: str | None = None, record=None) -> None:
        """Replace ``module.attr`` by a wrapper that times it as ``span`` and
        passes its arguments to ``record(args, kwargs)``, if given."""
        fn = getattr(module, attr)

        def wrapped(*args, **kwargs):
            if record is not None:
                self.records[attr].append(record(args, kwargs))
            if span is None:
                return fn(*args, **kwargs)
            with self.span(span):
                return fn(*args, **kwargs)

        setattr(module, attr, wrapped)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Reduced:
    """A window's device trace: busy and window seconds, time by kernel, and
    idle time by what the host was doing."""

    def __init__(self, device: list[tuple[int, int, str]], spans: list[tuple[int, int, str]],
                 window: tuple[int, int]):
        w0, w1 = window
        self.window_s = (w1 - w0) / 1e9
        self.device = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
        busy = _union([(s, e) for s, e, _ in self.device])
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        by_name: dict[str, float] = defaultdict(float)
        for s, e, n in self.device:
            by_name[n] += (e - s) / 1e9
        self.by_name = dict(by_name)
        gaps, at = [], w0
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if w1 > at:
            gaps.append((at, w1))
        idle: dict[str, float] = defaultdict(float)
        spans = sorted(spans)
        active: list[tuple[int, int, str]] = []
        nxt = 0
        for g0, g1 in gaps:  # in order: sweep the spans open at each gap's middle
            mid = (g0 + g1) // 2
            while nxt < len(spans) and spans[nxt][0] <= mid:
                active.append(spans[nxt])
                nxt += 1
            active = [sp for sp in active if sp[1] > mid]
            name = min(active, key=lambda sp: sp[1] - sp[0])[2] if active else "outside the spans"
            idle[name] += (g1 - g0) / 1e9
        self.idle_by_span = dict(idle)

    def kernel_s(self, names: tuple[str, ...]) -> float:
        """Device seconds of the kernels whose name holds one of ``names``."""
        return sum(t for n, t in self.by_name.items() if any(k in n for k in names))

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], t] for n, t in top],
                "idle_gaps": [[n, t] for n, t in gaps]}


def reduce_events(events) -> Reduced:
    from torch.autograd import DeviceType

    device, spans, window = [], [], None
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((start, end, e.name()))
        elif e.is_user_annotation() and e.name().startswith(PREFIX):
            name = e.name()[len(PREFIX):]
            if name == "window":
                window = (start, end)
            else:
                spans.append((start, end, name))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return Reduced(device, spans, window)
