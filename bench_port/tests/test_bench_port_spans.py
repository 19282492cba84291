"""``spans.py``, the program's spans in a traced window: on a synthetic event
list, each device op linked to its launch by correlation id (an op without
one counted under ``unlinked``, a CPU op's id never taken for a launch),
ops and idle gaps put down to the innermost span, every reading of
``trace.Reduced`` and the four readers of ``metrics/`` the same as from
``trace.reduce_events``; then the CPU cell traced with the reduction in
``trace``'s place."""

import pytest
import torch
from torch.autograd import DeviceType

from bench_port import harness, spans, spec, trace
from bench_port.tests.tiny import CELLS, overrides

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


class Event:
    """The part of ``torch._C._autograd._KinetoEvent`` the reductions read
    (its ``activity_type`` is not in every torch: the reductions read names)."""

    def __init__(self, name, start, end, device=CPU, activity="cpu_op", corr=0):
        self._name, self._start, self._end = name, start, end
        self._device, self._activity, self._corr = device, activity, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._activity in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self._corr


def ann(name, start, end):
    return Event(name, start, end, activity="user_annotation")


def launch(name, at, corr, activity="cuda_runtime"):
    return Event(name, at, at + 5, activity=activity, corr=corr)


def op(name, start, end, corr, activity="kernel"):
    return Event(name, start, end, device=CUDA, activity=activity, corr=corr)


def events():
    """A window of 1,000 ns: an epoch with one step (forward, backward) and
    one refresh (its jvp)."""
    return [
        ann("bench.window", 0, 1000), ann("bench.epoch", 0, 1000),
        ann("kf2vec.train.step", 100, 400), ann("kf2vec.train.forward", 120, 200),
        ann("kf2vec.train.backward", 250, 350), ann("kf2vec.fsw.refresh", 500, 900),
        ann("kf2vec.fsw.refresh.jvp", 600, 700),
        Event("aten::mm", 50, 60, corr=3),  # a CPU op: its id is not a launch's
        launch("cudaLaunchKernel", 130, 1), launch("cudaLaunchKernel", 260, 2),
        launch("cudaLaunchKernelExC", 610, 3), launch("cuLaunchKernel", 450, 4, "cuda_driver"),
        launch("cudaMemcpyAsync", 520, 5),
        op("fwd_kernel", 140, 180, 1), op("bwd_kernel", 300, 330, 2),
        op("sort_rows_cluster_kernel", 620, 690, 3), op("between_kernel", 460, 470, 4),
        op("Memcpy DtoD", 530, 540, 5, "gpu_memcpy"), op("lost_kernel", 950, 960, 99),
        op("early_kernel", -20, -10, 6),  # before the window: left out as in trace.py
        Event("kf2vec.train.step", 140, 180, device=CUDA, activity="gpu_user_annotation"),
    ]


def test_ops_linked_and_put_down_to_the_innermost_span():
    r = spans.reduce_events(events())
    assert r.op_span_ops == {"train.forward": 1, "train.backward": 1, "fsw.refresh.jvp": 1,
                             "fsw.refresh": 1, spans.OUTSIDE: 1, spans.UNLINKED: 1}
    assert r.op_span_s[spans.UNLINKED] == pytest.approx(10e-9)
    assert r.op_span_s["fsw.refresh.jvp"] == pytest.approx(70e-9)
    # launched inside: nested spans included
    assert r.span_ops == {"train.step": 2, "train.forward": 1, "train.backward": 1,
                          "fsw.refresh": 2, "fsw.refresh.jvp": 1}
    assert r.span_device_s["train.step"] == pytest.approx(70e-9)
    assert r.span_device_s["fsw.refresh"] == pytest.approx(80e-9)
    assert r.span_count == {"train.step": 1, "train.forward": 1, "train.backward": 1,
                            "fsw.refresh": 1, "fsw.refresh.jvp": 1}
    assert r.span_host_s["fsw.refresh"] == pytest.approx(400e-9)
    assert spans.kernel_spans(r, ("sort_rows",)) == {"fsw.refresh.jvp": pytest.approx(70e-9)}
    assert r.op_span[-1] == spans.UNLINKED  # lost_kernel, the last op in the window


def test_idle_gaps_go_to_the_innermost_span_of_either_kind():
    r = spans.reduce_events(events())
    # gaps (mid): 0-140 (70) epoch, 180-300 (240) step, 330-460 (395) step,
    # 470-530 (500) refresh, 540-620 (580) refresh, 690-950 (820) refresh, 960-1000 epoch
    assert r.idle_by_span == pytest.approx({"epoch": 180e-9, "train.step": 250e-9,
                                            "fsw.refresh": 400e-9})


def test_the_benchmark_readings_unchanged():
    old, new = trace.reduce_events(events()), spans.reduce_events(events())
    assert (new.busy_s, new.window_s, new.by_name, new.device) == (
        old.busy_s, old.window_s, old.by_name, old.device)
    assert new.kernel_s(("sort_rows",)) == old.kernel_s(("sort_rows",)) == pytest.approx(70e-9)
    assert new.breakdown()["device_ops"] == old.breakdown()["device_ops"]
    no_program = [e for e in events() if not e.name().startswith("kf2vec.")]
    assert spans.reduce_events(no_program).idle_by_span == trace.reduce_events(
        no_program).idle_by_span


class _Run:
    records = {"refreshes": 1}

    @staticmethod
    def flops():
        return 1e6


class _Tracer:
    host_s = {"refresh": 0.5e-6}
    records = {"sort_rows": [(512, 8192, 1)]}


@pytest.mark.parametrize("metric", [m["name"] for m in spec.benchmark()["per_layer"]])
def test_the_accepted_readers_read_the_same(metric):
    read = spec.metric_reader(metric)

    def readings(reduced):
        tracer = _Tracer()
        tracer.reduced = reduced
        return harness.Readings(_Run(), tracer)

    assert read(readings(spans.reduce_events(events()))) == read(
        readings(trace.reduce_events(events())))


def test_readings_none_without_spans_or_device_ops():
    bare = [e for e in events() if not e.name().startswith("kf2vec.")]
    r = spans.reduce_events(bare)
    assert all(fn(r) is None for fn in spans.READINGS.values())
    r = spans.reduce_events(events())
    assert spans.step_host_ms(r) == pytest.approx(300e-6)
    assert spans.step_launches(r) == 2
    assert spans.refresh_device_share(r) == pytest.approx(8.0)
    assert spans.refresh_jvp_share(r) == pytest.approx(87.5)
    host_only = [e for e in events() if e.device_type() == CPU]
    r = spans.reduce_events(host_only)
    assert spans.step_host_ms(r) == pytest.approx(300e-6)
    assert [fn(r) for n, fn in spans.READINGS.items() if n != "step_host_ms.train"] == [None] * 3


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_on_cpu_with_the_program_spans(cell, monkeypatch):
    kept = []

    def reduce(evs):
        kept.append(spans.reduce_events(evs))
        return kept[-1]

    monkeypatch.setattr(trace, "reduce_events", reduce)
    res = harness.run_cell(cell, 2**31 + 99, 1.0, True, "cpu", **overrides(cell))
    assert res["correct"], res["checks"]
    r = kept[-1]
    got = spans.readings(r)
    assert got["step_host_ms.train"] > 0  # the host side of the steps is read on the CPU
    for name in ("step_launches.train", "refresh_device_share.train", "refresh_jvp_share.train"):
        assert got[name] is None, name  # no device ops on the CPU
    assert r.span_count["train.step"] == res["attempted"]
    assert r.span_count["fsw.refresh"] >= 1
    assert r.span_count["fsw.refresh.jvp"] >= r.span_count["fsw.refresh"]
    assert {n for n, _ in res["breakdown"]["idle_gaps"]} <= set(r.idle_by_span)


def test_the_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would be real")
    assert spans.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
