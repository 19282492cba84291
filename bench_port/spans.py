#!/usr/bin/env python3
"""The program's spans in a traced window, and what the device did inside
them.

The port marks its own spans (``kf2vecfsw_tpu_torch/utils/phases.py``) as
user annotations named ``kf2vec.<span>`` whenever a profiler records:
``train.step`` and its parts in the trainers, ``fsw.refresh`` and its
stages in the lazy FSW refresh. ``reduce_events`` reads them from the same
raw kineto events as ``trace.reduce_events`` and gives a ``SpanReduced``:
every reading of ``trace.Reduced`` from the same events and the same code,
except that an idle gap goes to the innermost span of either kind (the
benchmark's or the program's) open at its middle; and besides, per program
span name, its count and host seconds, and the device ops launched inside
it. An op's launch is the host event of the CUDA runtime or driver call
(``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``,
``cudaMemcpyAsync``, ``cudaMemsetAsync``, ...) that carries the op's
correlation id (a host op, ``aten::*``, has an id of another count); an op
with no such event is counted under ``UNLINKED``, never dropped.

The harness does not call it: ``trace.Tracer`` reduces with
``trace.reduce_events``. Run from the repo root, this file runs one traced
cell through ``run.py`` with its reduction in that place, prints the result
line, then one JSON line of the program's readings (``readings``):

    python3 bench_port/spans.py --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import sys
from collections import defaultdict
from pathlib import Path

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import trace  # noqa: E402

PROGRAM_PREFIX = "kf2vec."  # utils/phases.py's PREFIX
LAUNCH_PREFIX = "cu"  # the host's CUDA runtime (cuda*) and driver (cu*) calls
UNLINKED = "unlinked"  # device ops whose launch the trace does not hold
OUTSIDE = "outside the spans"


def _sweep(spans: list[tuple[int, int, str]], times: list[int]):
    """For each of the ascending ``times``, the spans open at it (start <= t
    < end), innermost (shortest) first."""
    spans = sorted(spans)
    active: list[tuple[int, int, str]] = []
    nxt = 0
    for t in times:
        while nxt < len(spans) and spans[nxt][0] <= t:
            active.append(spans[nxt])
            nxt += 1
        active = [sp for sp in active if sp[1] > t]
        yield sorted(active, key=lambda sp: sp[1] - sp[0])


class SpanReduced(trace.Reduced):
    """``trace.Reduced`` of the device ops, the benchmark's spans and the
    program's spans (``program``), with each op's launch on the host clock
    (``launched``, None where unlinked). Per program span name: ``span_count``
    and ``span_host_s`` (its spans' number and host seconds in the window),
    ``span_ops`` and ``span_device_s`` (the ops launched inside it, nested
    spans included, and their device seconds); ``op_span_ops`` and
    ``op_span_s``: the ops and device seconds by the innermost program span
    open at their launch, with ``OUTSIDE`` and ``UNLINKED``; ``op_span``:
    that span of each op of ``device``."""

    def __init__(self, device: list[tuple[int, int, str]], spans: list[tuple[int, int, str]],
                 window: tuple[int, int], program: list[tuple[int, int, str]] = (),
                 launched: list[int | None] | None = None):
        w0, w1 = window
        program = [sp for sp in program if sp[1] > w0 and sp[0] < w1]
        super().__init__(device, list(spans) + program, window)  # idle gaps: either kind
        if launched is None:
            launched = [None] * len(device)
        # aligned with self.device, which keeps the ops that overlap the window, in order
        at = [t for (s, e, _), t in zip(device, launched) if e > w0 and s < w1]
        count: dict[str, int] = defaultdict(int)
        host: dict[str, float] = defaultdict(float)
        for s, e, n in program:
            count[n] += 1
            host[n] += (min(e, w1) - max(s, w0)) / 1e9
        ops: dict[str, int] = defaultdict(int)
        dev: dict[str, float] = defaultdict(float)
        self.op_span = [UNLINKED] * len(at)
        linked = sorted((t, i) for i, t in enumerate(at) if t is not None)
        for (_, i), open_ in zip(linked, _sweep(program, [t for t, _ in linked])):
            s, e, _ = self.device[i]
            for n in {sp[2] for sp in open_}:
                ops[n] += 1
                dev[n] += (e - s) / 1e9
            self.op_span[i] = open_[0][2] if open_ else OUTSIDE
        self_ops: dict[str, int] = defaultdict(int)
        self_s: dict[str, float] = defaultdict(float)
        for (s, e, _), n in zip(self.device, self.op_span):
            self_ops[n] += 1
            self_s[n] += (e - s) / 1e9
        self.span_count, self.span_host_s = dict(count), dict(host)
        self.span_ops, self.span_device_s = dict(ops), dict(dev)
        self.op_span_ops, self.op_span_s = dict(self_ops), dict(self_s)


def reduce_events(events) -> SpanReduced:
    """``trace.reduce_events`` with the program's spans and the ops' launches."""
    from torch.autograd import DeviceType

    device, spans, program, window = [], [], [], None
    corr: list[int] = []  # each device op's correlation id
    launch_at: dict[int, int] = {}  # correlation id -> the launching call's start
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((start, end, e.name()))
                corr.append(e.correlation_id())
        elif e.is_user_annotation():
            name = e.name()
            if name.startswith(trace.PREFIX):
                if name == trace.PREFIX + "window":
                    window = (start, end)
                else:
                    spans.append((start, end, name[len(trace.PREFIX):]))
            elif name.startswith(PROGRAM_PREFIX):
                program.append((start, end, name[len(PROGRAM_PREFIX):]))
        elif e.name().startswith(LAUNCH_PREFIX) and e.correlation_id():
            launch_at.setdefault(e.correlation_id(), start)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return SpanReduced(device, spans, window, program,
                       [launch_at.get(c) if c else None for c in corr])


# -- readings of the program's spans (None where they find nothing to read) -----------


def step_host_ms(r: SpanReduced) -> float | None:
    """Mean host milliseconds of a ``train.step``."""
    n = r.span_count.get("train.step", 0)
    return 1e3 * r.span_host_s["train.step"] / n if n else None


def step_launches(r: SpanReduced) -> float | None:
    """Device ops launched inside ``train.step``, per ``train.step``."""
    n = r.span_count.get("train.step", 0)
    return r.span_ops.get("train.step", 0) / n if n and r.device else None


def refresh_device_share(r: SpanReduced) -> float | None:
    """Device seconds launched inside ``fsw.refresh``, % of the window."""
    s = r.span_device_s.get("fsw.refresh", 0.0)
    return 100.0 * s / r.window_s if s > 0 and r.window_s > 0 else None


def refresh_jvp_share(r: SpanReduced) -> float | None:
    """Device seconds launched inside ``fsw.refresh.jvp``, % of those
    launched inside ``fsw.refresh``."""
    s = r.span_device_s.get("fsw.refresh", 0.0)
    return 100.0 * r.span_device_s.get("fsw.refresh.jvp", 0.0) / s if s > 0 else None


def kernel_spans(r: SpanReduced, names: tuple[str, ...]) -> dict[str, float]:
    """Device seconds of the kernels whose name holds one of ``names``, by
    the innermost program span open at their launch."""
    out: dict[str, float] = defaultdict(float)
    for (s, e, n), span in zip(r.device, r.op_span):
        if any(k in n for k in names):
            out[span] += (e - s) / 1e9
    return dict(out)


READINGS = {"step_host_ms.train": step_host_ms, "step_launches.train": step_launches,
            "refresh_device_share.train": refresh_device_share,
            "refresh_jvp_share.train": refresh_jvp_share}


def readings(r: SpanReduced) -> dict:
    """The four readings, the spans, the ops by innermost span, and the idle
    gaps by innermost span of either kind."""
    return {
        **{name: fn(r) for name, fn in READINGS.items()},
        "spans": {n: {"count": r.span_count[n], "host_s": r.span_host_s[n],
                      "ops": r.span_ops.get(n, 0), "device_s": r.span_device_s.get(n, 0.0)}
                  for n in sorted(r.span_count)},
        "ops_by_innermost": {n: [r.op_span_ops[n], r.op_span_s[n]]
                             for n in sorted(r.op_span_s, key=lambda n: -r.op_span_s[n])},
        "sort_rows_by_span": kernel_spans(r, ("sort_rows",)),
        "unlinked_share": r.op_span_s.get(UNLINKED, 0.0) / r.busy_s if r.busy_s > 0 else None,
        "idle_by_span": dict(sorted(r.idle_by_span.items(), key=lambda kv: -kv[1])),
        "busy_s": r.busy_s, "window_s": r.window_s}


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from bench_port import run

    kept: list[SpanReduced] = []

    def reduce(events):
        kept.append(reduce_events(events))
        return kept[-1]

    trace.reduce_events = reduce  # Tracer.window's reduction, for this run
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc or not kept:
        return rc or 1
    print(json.dumps({"program_spans": readings(kept[-1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
