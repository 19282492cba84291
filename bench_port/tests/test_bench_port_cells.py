"""A run of each cell at small sizes on the CPU: the drivers, the
comparison with the reference (the port against the reference's models
and counts), the result line and the per-layer readers."""

import json

import pytest

from bench_port import harness, spec
from bench_port.tests.tiny import CELLS, overrides


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_cpu(cell):
    res = harness.run_cell(cell, 2**31 + 12345, 1.0, False, "cpu", **overrides(cell))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec.metrics_of(cell, "end_to_end")}
    assert list(res)[-1] == "checks"
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_on_cpu(cell):
    res = harness.run_cell(cell, 77, 1.0, True, "cpu", **overrides(cell))
    assert res["correct"], res["checks"]
    declared = {m["name"] for m in spec.metrics_of(cell, "per_layer")}
    assert set(res["metrics"]) <= declared
    # no device on the CPU: the readers of device time find nothing to read
    assert not any("roofline" in m for m in res["metrics"])
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def dense_run(seed: int):
    """The training driver on the dense configuration (``configs/dense_k7.json``,
    not declared in BENCHMARK.json: PERF.md, Open questions) at its CPU sizes."""
    import torch

    from bench_port.trace import Tracer

    cfg = {**spec.config("dense_k7"), **spec.config("dense_k7")["cpu_test"]}
    mix = {**spec.traffic("train_window"), **spec.traffic("train_window")["cpu_test"]}
    dev = torch.device("cpu")
    return spec.driver("train_window").Run(cfg, mix, seed, dev, Tracer(False, dev))


def dense_verdict(seed: int, fault=None) -> tuple[bool, dict]:
    import contextlib

    from bench_port import compare, faults

    run = dense_run(seed)
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        run.setup()
        run.window(0.5)
    run.release()
    return compare.verdict(run.numbers(), spec.limits("dense_k7.train"))


@pytest.mark.parametrize("fault", [None, "stale_step", "half_batch"])
def test_dense_route_on_cpu(fault):
    """The driver's dense route: correct as it stands, not correct with each
    fault planted."""
    ok, checks = dense_verdict(2**31 + 7, fault)
    assert ok == (fault is None), checks
