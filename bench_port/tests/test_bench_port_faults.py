"""A run with its timed path broken underneath comes out not correct, once
for each fault a cell can have (one chip: no exchange between chips)."""

import pytest

from bench_port import faults, harness
from bench_port.tests.tiny import CELLS, overrides

CASES = [(cell, fault) for cell in CELLS for fault in faults.FAULTS]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    with faults.FAULTS[fault]():
        res = harness.run_cell(cell, 4242, 1.0, False, "cpu", **overrides(cell))
    assert not res["correct"], res["checks"]


def test_wrong_learning_rate_is_caught(monkeypatch):
    from kf2vecfsw_tpu_torch.train import schedule

    step_lr = schedule.step_lr
    monkeypatch.setattr(schedule, "step_lr", lambda e, *a, **k: step_lr(e, *a, **k) * (1 + 1e-9))
    res = harness.run_cell(CELLS[0], 4243, 0.5, False, "cpu", **overrides(CELLS[0]))
    assert not res["correct"] and res["checks"]["lr_gap"]["value"] > 0, res["checks"]
