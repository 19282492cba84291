"""``fsw_k10.train_lazy`` at its CPU sizes (``cpu_test`` of its configuration
and traffic mix): the per-genome route, the comparison with the per-genome
reference, a fault refused, the new readers and the point sets' layout."""

import numpy as np
import pytest
import torch

from bench_port import compare, faults, harness, inputs, points, spec
from bench_port.tests.tiny import overrides
from bench_port.trace import Tracer

CELL = "fsw_k10.train_lazy"


def small_run(seed: int, traced: bool = False):
    o = overrides(CELL)
    cfg = {**spec.config("fsw_k10"), **o["cfg_over"]}
    mix = {**spec.traffic("train_pergenome"), **o["mix_over"]}
    dev = torch.device("cpu")
    return spec.driver(mix["driver"]).Run(cfg, mix, seed, dev, Tracer(traced, dev))


def test_correct_on_the_per_genome_route():
    run = small_run(2**31 + 4321)
    run.setup()
    planes = run.planes
    assert planes.shared is False and planes.feats.dim() == 3
    assert planes.feats.shape[1] >= max(len(m) for m in run.mats)
    assert planes.step % planes.interval == 0  # the window starts on a refresh
    run.window(0.5)
    assert run.records["refreshes"] >= 1 and planes.step % planes.interval == 0
    c = run.records["counters"]
    assert c["fsw.refresh.items"] == run.records["refreshes"] * len(run.mats)
    assert c["fsw.refresh.points"] == run.records["refreshes"] * sum(len(m) for m in run.mats)
    assert c["fsw.refresh.slots"] == c["fsw.refresh.items"] * planes.feats.shape[1]
    run.release()
    ok, checks = compare.verdict(run.numbers(), spec.limits(CELL))
    assert ok, checks
    assert "plane_gap" in checks


def test_stale_step_is_refused():
    with faults.stale_step():
        res = harness.run_cell(CELL, 2**31 + 99991, 0.5, False, "cpu", **overrides(CELL))
    assert not res["correct"], res["checks"]


def test_the_new_readers_read_a_traced_cpu_run():
    res = harness.run_cell(CELL, 2**31 + 555, 0.5, True, "cpu", **overrides(CELL))
    assert res["correct"], res["checks"]
    padding = res["metrics"]["refresh_padding.train"]["value"]
    assert 0 < padding < 100
    # a share of the card's peaks: no reading on the CPU (below, what it computes)
    assert "pergenome_refresh_roofline.train" not in res["metrics"]


def test_roofline_share_of_a_traced_cpu_run():
    run = small_run(2**31 + 556, traced=True)
    run.setup()
    run.window(0.5)
    share = spec.metric_reader("pergenome_refresh_roofline.train").__globals__["share"]
    value = share(run.cfg, run.records["counters"]["fsw.refresh.points"],
                  run.tracer.host_s["refresh"])
    assert 0 < value < 100


def test_point_sets_are_get_kmers_matrices():
    from kf2vecfsw_tpu_torch.ingest.kmers import kmer_matrix
    from kf2vecfsw_tpu_torch.kmer.vocab import canonical_vocab_codes

    dev = torch.device("cpu")
    rng, gen = inputs.generators(11, dev)
    gc = np.array([0.4, 0.55])
    counts = inputs.genome_counts(gen, 5, gc, np.array([3000, 800]), dev)
    codes = canonical_vocab_codes(5)
    for c, got in zip(counts, points.point_sets(counts, 5)):
        present = (c > 0).numpy()
        want = kmer_matrix(codes[present], c.numpy()[present], 5)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_longest_genome_takes_the_root_gc(seed):
    rng = np.random.default_rng(seed)
    _, _, gc, _ = inputs.random_tree(rng, 16)
    lengths = inputs.spread_lengths(rng, 16, 1_000_000, 6_000_000)
    pinned = points.pinned_gc(gc, lengths)
    i = int(np.argmax(lengths))
    assert pinned[i] == 0.5 and np.array_equal(np.delete(pinned, i), np.delete(gc, i))


def test_refresh_counts_by_hand():
    from bench_port import counts, counts_pergenome

    cfg = spec.config("fsw_k10")  # k 10, base_dim 4, 512 slices
    p = 503_934
    assert counts_pergenome.projection_flops(cfg, p) == (2 * 10 * 4 * 4 + 2 * 512 * 40) * p
    assert counts_pergenome.refresh_flops(cfg, p) == (320 + 40_960 + 2 * 512 * 40 + 2 * 512) * p
    least = counts_pergenome.refresh_least_s(cfg, p)
    assert least == pytest.approx(41_280 * p / 67e12 + (16 * 512 + 4) * p / 3.35e12
                                  + 120 * 512 * p / 3.35e13)
    assert counts_pergenome.refresh_least_s(cfg, 2 * p) == pytest.approx(2 * least)
    assert counts.sort_rows_bound_s(512, p, 1) == pytest.approx((16 * 512 + 4) * p / 3.35e12)
