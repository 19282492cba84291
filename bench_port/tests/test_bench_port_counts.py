"""The operation and byte counts against hand counts."""

import pytest

from bench_port import counts

FSW = {"model": "fsw", "k": 7, "base_dim": 4, "fsw_out_dim": 512, "hidden_size": 2048,
       "embedding_size": 1024}
DENSE = {"model": "dense", "k": 7, "hidden_size": 2048, "embedding_size": 1024}


def test_mlp_and_pairwise():
    assert counts.mlp_flops(2, [3, 4, 5]) == 2 * 2 * 3 * 4 + 2 * 2 * 4 * 5
    assert counts.pairwise_flops(16, 1024) == 2 * 16 * 16 * 1024


def test_dense_train_step():
    fwd = 2 * 16 * 8192 * 2048 + 2 * 16 * 2048 * 1024 + 2 * 16 * 16 * 1024
    assert counts.train_step_flops(DENSE, 8192, 16) == 3 * fwd  # about 1.8 GFLOP


def test_lazy_train_step():
    fwd = (2 * 512 * 7 * 4 * 4 + 2 * 16 * 512 * 7 * 4 + 2 * 16 * (512 * 2048 + 2048 * 1024)
           + 2 * 16 * 16 * 1024)
    assert counts.train_step_flops(FSW, 8192, 16) == 3 * fwd


def test_shared_refresh():
    vocab_side = 2 * 8192 * 7 * 4 * 4 + 2 * 512 * 28 * 8192
    per_item = 2 * 512 * 8192 * (4 * 7 + 1)
    assert counts.shared_refresh_flops(FSW, 8192, 850) == vocab_side + 850 * per_item


def test_sort_bound_matches_the_port_table():
    # PERF.md section 6: the sort's training shape, 0.020042 ms; a k = 8 query block, 1.2877 ms
    assert counts.sort_rows_bound_s(512, 8192, 1) == pytest.approx(0.020042278e-3, rel=1e-6)
    assert counts.sort_rows_bound_s(8192, 32896, 16) == pytest.approx(1.287716375e-3, rel=1e-6)
