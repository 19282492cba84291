"""The exact-route cells (``fsw_k7.train_exact``, ``fsw_k10.train_exact``) at
their CPU sizes: the route each takes, its counter and its reader, and
the operation counts by hand. ``test_bench_port_cells.py`` and
``test_bench_port_faults.py`` run both cells through ``tiny.CELLS``,
traced and untraced and with each fault planted."""

import types

import pytest
import torch

from bench_port import counts, counts_exact, harness, spec
from bench_port.drivers import train_exact
from bench_port.tests.tiny import overrides
from bench_port.trace import Tracer
from kf2vecfsw_tpu_torch.train.distance import pad_point_sets

CELLS = ("fsw_k7.train_exact", "fsw_k10.train_exact")
READ = spec.metric_reader("exact_sort_slots.train")


def small_run(cell: str, seed: int, traced: bool = False):
    o = overrides(cell)
    w = spec.cell(cell)
    cfg = {**spec.config(w["config"]), **o["cfg_over"]}
    mix = {**spec.traffic(w["traffic"]), **o["mix_over"]}
    dev = torch.device("cpu")
    return train_exact.Run(cfg, mix, seed, dev, Tracer(traced, dev))


@pytest.mark.parametrize("cell,route", [(CELLS[0], train_exact.SharedExact),
                                        (CELLS[1], train_exact.PerGenomeExact)])
def test_each_cell_takes_the_trainers_route(cell, route):
    """k = 3 (``fsw_k7``'s CPU size) takes the shared route, k = 10 the per
    genome one; both with the trainer's flag 0, no planes, and each step's
    slots counted once when nothing is chunked: C x V shared, B x C x N per
    genome (the last batch's B its own)."""
    run = small_run(cell, 2**31 + 61)
    assert type(run) is route and run.cfg["fsw_lazy_refresh"] == 0
    run.setup()
    assert run.planes is None
    run.window(0.3)
    r, cfg = run.records, run.cfg
    assert r["refreshes"] == 0 and r["epochs"] >= 1
    c = cfg["fsw_out_dim"]
    if route is train_exact.SharedExact:
        assert r["counters"]["fsw.exact.slots"] == r["steps"] * c * run.vocab
    else:
        n = pad_point_sets(run.mats).shape[1]
        assert r["counters"]["fsw.exact.slots"] == c * n * (
            r["full_batches"] * cfg["batch_size"] + r["epochs"] * r["last_batch"])


def test_a_chunked_cell_reads_twice_the_slots(monkeypatch):
    """With the card's memory faked small enough that the per-genome
    forward takes chunks of 8 of its 16 slices, every chunk is sorted again
    in the backward: the traced run's reader gives twice the unchunked
    run's slots a step."""
    o = overrides(CELLS[1])
    whole = harness.run_cell(CELLS[1], 2**31 + 62, 0.5, True, "cpu", **o)
    monkeypatch.setenv("KF2VEC_HBM_BYTES", str(40_000_000))
    chunked = harness.run_cell(CELLS[1], 2**31 + 62, 0.5, True, "cpu", **o)
    assert whole["correct"] and chunked["correct"], (whole["checks"], chunked["checks"])
    read = [res["metrics"]["exact_sort_slots.train"]["value"] for res in (whole, chunked)]
    assert read[1] == 2 * read[0] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_reader_reads_a_traced_cpu_run(cell):
    res = harness.run_cell(cell, 2**31 + 63, 0.5, True, "cpu", **overrides(cell))
    assert res["correct"], res["checks"]
    assert res["metrics"]["exact_sort_slots.train"]["value"] > 0
    assert "mfu.train" in res["metrics"]


def test_the_reader_without_counters_reads_nothing():
    """A program that counts nothing (the parent of the counter) leaves
    ``records["counters"]`` empty: no reading."""
    for records in ({"counters": {}, "steps": 4}, {"steps": 4},
                    {"counters": {"fsw.exact.slots": 5}, "steps": 0}):
        assert READ(types.SimpleNamespace(run=types.SimpleNamespace(records=records))) is None
    full = {"counters": {"fsw.exact.slots": 30_000_000}, "steps": 4}
    assert READ(types.SimpleNamespace(run=types.SimpleNamespace(records=full))) == 7.5


def test_exact_counts_by_hand():
    """fsw_k10's widths (k 10, base_dim 4, 512 slices, hidden 2,048,
    embedding 1,024) and fsw_k7_exact's vocabulary (8,192)."""
    cfg = spec.config("fsw_k10")
    p = 6_000_000
    layer = 2 * p * 10 * 4 * 4 + 2 * 512 * 40 * p + 2 * 512 * p
    head = 2 * 16 * 512 * 2048 + 2 * 16 * 2048 * 1024
    pair = 2 * 16 * 16 * 1024
    assert counts_exact.pergenome_points_flops(cfg, p) == 3 * layer
    assert counts_exact.pergenome_batch_flops(cfg, 16) == 3 * (head + pair)
    assert counts_exact.pergenome_step_flops(cfg, 16, p) == 3 * (layer + head + pair)
    k7 = spec.config("fsw_k7_exact")
    v = 8192
    vocab_side = 2 * v * 7 * 4 * 4 + 2 * 512 * 28 * v
    assert counts_exact.shared_step_flops(k7, v, 16) == 3 * (vocab_side + 16 * 2 * 512 * v
                                                             + head + pair)
    # one row: the layer on the vocabulary as one point set
    assert counts_exact.shared_step_flops(k7, v, 1) == 3 * (
        counts.fsw_point_set_flops(k7, v) + counts.fsw_head_flops(k7, 1)
        + counts.pairwise_flops(1, 1024))


def test_window_flops_are_whole_epochs_of_steps():
    """The per-genome window's count is its epochs' items' points once each
    and its batches' heads: the sum of its steps' counts."""
    run = small_run(CELLS[1], 2**31 + 64)
    run.setup()
    run.window(0.3)
    r, cfg, b = run.records, run.cfg, run.cfg["batch_size"]
    n = cfg["subtree_size"]
    sizes = [len(m) for m in run.mats]
    assert r["full_batches"] == r["epochs"] * (n // b) and r["last_batch"] == n % b
    assert run.flops() == r["epochs"] * (
        counts_exact.pergenome_points_flops(cfg, sum(sizes))
        + (n // b) * counts_exact.pergenome_batch_flops(cfg, b)
        + (counts_exact.pergenome_batch_flops(cfg, n % b) if n % b else 0))


def test_the_exact_reference_loads_nothing_of_the_port():
    from bench_port.tests.test_bench_port_imports import python

    out = python("import sys; import bench_port.reference.exact;"
                 "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                 "('kf2vecfsw_tpu_torch', 'kf2vecfsw_tpu', 'jax')))")
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
