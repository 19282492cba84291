"""``fsw_k9.train_exact`` (k = 9, V = 131,072, the shared route) at its CPU
sizes: the driver ``train_exact_counted`` and the program's coefficient
counters, the reader ``exact_coefficients_roofline.train`` on synthetic
readings, and ``counts_coefficients`` by hand at k = 7 and k = 9.
``test_bench_port_cells.py`` and ``test_bench_port_faults.py`` run the cell
through ``tiny.CELLS``, traced and untraced and with each fault planted."""

import types

import pytest
import torch

from bench_port import counts_coefficients, harness, spec
from bench_port.drivers import train_exact, train_exact_counted
from bench_port.tests.tiny import overrides
from bench_port.trace import Tracer

CELL = "fsw_k9.train_exact"
READ = spec.metric_reader("exact_coefficients_roofline.train")
FORWARD, BACKWARD = "fsw.exact.coefficients.forward", "fsw.exact.coefficients.backward"


def small_run(seed: int, cfg_over: dict | None = None):
    o = overrides(CELL)
    w = spec.cell(CELL)
    cfg = {**spec.config(w["config"]), **o["cfg_over"], **(cfg_over or {})}
    mix = {**spec.traffic(w["traffic"]), **o["mix_over"]}
    dev = torch.device("cpu")
    return train_exact_counted.Run(cfg, mix, seed, dev, Tracer(False, dev))


@pytest.mark.parametrize("hbm,chunks", [(None, 1), ("1000000000", 2)])
def test_the_cell_counts_its_coefficients(monkeypatch, hbm, chunks):
    """k = 9's vocabulary at the CPU widths (16 slices, batch 4) on the
    shared exact route: a step counts B x C x V coefficients forward and as
    many backward, and C x V slots; where the card's memory is faked small
    enough that the training chunk is 8 of the 16 slices, the recompute
    doubles the forward's coefficients and the slots, not the backward's."""
    if hbm:
        monkeypatch.setenv("KF2VEC_HBM_BYTES", hbm)
    run = small_run(2**31 + 91)
    assert type(run) is train_exact_counted.SharedExactCounted
    assert isinstance(run, train_exact.SharedExact) and run.cfg["fsw_lazy_refresh"] == 0
    run.setup()
    assert run.planes is None and run.vocab == 131_072
    run.window(0.3)
    r, cfg = run.records, run.cfg
    assert r["refreshes"] == 0 and r["last_batch"] == 0 and r["steps"] > 0
    c, b = cfg["fsw_out_dim"], cfg["batch_size"]
    step = b * c * run.vocab
    assert r["counters"] == {"fsw.exact.slots": r["steps"] * chunks * c * run.vocab,
                             FORWARD: r["steps"] * chunks * step, BACKWARD: r["steps"] * step}


def test_the_cell_is_correct_and_read_on_the_cpu():
    """The traced cell at its CPU sizes: correct, the slots read, and no
    roofline (no card, no kernel time)."""
    res = harness.run_cell(CELL, 2**31 + 92, 0.5, True, "cpu", **overrides(CELL))
    assert res["correct"], res["checks"]
    assert res["metrics"]["exact_sort_slots.train"]["value"] == 16 * 131_072 / 1e6
    assert "exact_coefficients_roofline.train" not in res["metrics"]
    assert "mfu.train" in res["metrics"]


def test_the_driver_refuses_a_clade_the_gate_sends_per_genome():
    with pytest.raises(NotImplementedError):
        small_run(2**31 + 93, {"k": 10})


def test_the_reference_items_are_made_on_demand():
    """``PresentKmers`` gives ``SharedExact.items``' pairs, one at a time."""
    run = small_run(2**31 + 94)
    run.setup()
    lazy = run.items()
    eager = train_exact.SharedExact.items(run)
    assert len(lazy) == len(eager) == run.cfg["subtree_size"]
    for i in (0, 7, len(eager) - 1):
        assert all(torch.equal(a, b) for a, b in zip(lazy[i], eager[i]))
    run.release()


def readings(counters: dict | None, kernel_s: float | None):
    """Readings of a traced run with these counters and this much device
    time of the kernels the reader names (None: an untraced run)."""
    records = {} if counters is None else {"counters": counters}
    trace = None if kernel_s is None else types.SimpleNamespace(
        kernel_s=lambda names: kernel_s if names == ("exact_shared_kernel",) else 0.0)
    return types.SimpleNamespace(run=types.SimpleNamespace(records=records), trace=trace)


def test_the_roofline_by_hand():
    """A full fsw_k9.train_exact step: 4 chunks of 16 x 128 x 131,072
    coefficients forward, each again in the recompute (2,147,483,648), and
    once backward (1,073,741,824): (60 x 2,147,483,648 + 120 x
    1,073,741,824) / 3.35e13 = 7.69247874e-3 s; over 15.38495748e-3 s of
    kernel time, 50%."""
    full = {FORWARD: 2_147_483_648, BACKWARD: 1_073_741_824, "fsw.exact.slots": 134_217_728}
    assert READ(readings(full, 15.38495748e-3)) == pytest.approx(50.0, rel=1e-8)
    assert READ(readings(full, 7.69247874e-3)) == pytest.approx(100.0, rel=1e-8)


def test_the_roofline_reads_nothing_without_counters_or_kernel_time():
    """A program that counts no coefficients (the parent of the counters),
    an untraced run and a trace without the kernel (the CPU) read None."""
    full = {FORWARD: 10, BACKWARD: 5}
    for r in (readings(None, 1.0), readings({"fsw.exact.slots": 8}, 1.0),
              readings({FORWARD: 10}, 1.0), readings(full, None), readings(full, 0.0)):
        assert READ(r) is None


def test_counts_coefficients_by_hand():
    """fsw_k7.train_exact's step (16 x 512 x 8,192 = 67,108,864 coefficients
    each way, unchunked) and fsw_k9.train_exact's (above); per genome 12 B a
    position each way at 3.35 TB/s."""
    k7 = 16 * 512 * 8192
    assert k7 == 67_108_864
    assert counts_coefficients.shared_least_s(k7, 0) == pytest.approx(1.20194980e-4, rel=1e-8)
    assert counts_coefficients.shared_least_s(k7, k7) == pytest.approx(3.60584941e-4, rel=1e-8)
    k9 = 16 * 512 * 131_072
    assert counts_coefficients.shared_least_s(2 * k9, k9) == pytest.approx(7.69247874e-3,
                                                                           rel=1e-8)
    # fsw_k10.train_exact's chunk: 16 x 32 rows of 646,000, forward and backward
    rows = 16 * 32 * 646_000
    assert counts_coefficients.pergenome_least_s(rows, rows) == pytest.approx(
        2 * 12 * 330_752_000 / 3.35e12, rel=1e-12)
    assert counts_coefficients.pergenome_least_s(rows, 0) == pytest.approx(1.18478328e-3,
                                                                            rel=1e-8)
