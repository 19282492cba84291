"""The generators repeat exactly for one seed and give every seed the same
set of sizes."""

import numpy as np
import pytest
import torch

from bench_port import inputs

CPU = torch.device("cpu")


def tree(seed, n=40):
    rng = np.random.default_rng(seed)
    children, length, gc, leaves = inputs.random_tree(rng, n)
    return children, length, gc, leaves, inputs.patristic(children, length, leaves)


def test_tree_repeats_and_is_a_metric():
    a, b = tree(5), tree(5)
    assert np.array_equal(a[4], b[4]) and np.array_equal(a[2], b[2])
    d = a[4]
    assert np.allclose(d, d.T) and np.all(np.diag(d) == 0) and np.all(d[~np.eye(40, dtype=bool)] > 0)
    assert not np.array_equal(d, tree(6)[4])


def test_patristic_by_hand():
    # ((l1:1, l2:2):3, l3:4) as the generator's nodes: root 0 -> (3, 2), 3 -> (1, 4)
    children = {0: [3, 2], 3: [1, 4]}
    length = {1: 1.0, 2: 4.0, 3: 3.0, 4: 2.0}
    d = inputs.patristic(children, length, [1, 2, 4])
    assert d[0, 2] == 3.0 and d[0, 1] == 8.0 and d[2, 1] == 9.0


def test_lengths_are_one_set_in_seeded_orders():
    a = inputs.spread_lengths(np.random.default_rng(1), 48, 1_000_000, 6_000_000)
    b = inputs.spread_lengths(np.random.default_rng(2), 48, 1_000_000, 6_000_000)
    assert np.array_equal(np.sort(a), np.sort(b)) and not np.array_equal(a, b)


def test_counts_repeat():
    gc, lengths = np.array([0.4, 0.6]), np.array([5000, 9000])
    a = inputs.genome_counts(torch.Generator().manual_seed(3), 3, gc, lengths, CPU)
    b = inputs.genome_counts(torch.Generator().manual_seed(3), 3, gc, lengths, CPU)
    assert torch.equal(a, b) and a.shape == (2, 32)
    p = inputs.canonical_probabilities(3, torch.tensor([0.3, 0.5]))
    assert torch.allclose(p.sum(dim=1), torch.ones(2, dtype=torch.float64))


@pytest.mark.parametrize("model", ["fsw", "dense"])
def test_weights_repeat(model):
    cfg = {"model": model, "k": 3, "base_dim": 2, "fsw_out_dim": 16, "hidden_size": 8,
           "embedding_size": 4}
    a = inputs.model_params(torch.Generator().manual_seed(4), cfg, CPU)
    b = inputs.model_params(torch.Generator().manual_seed(4), cfg, CPU)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    if model == "fsw":
        s = a["fsw/slices"][:6]
        assert torch.allclose(s @ s.T, torch.eye(6), atol=1e-5)
