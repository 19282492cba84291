"""The plain reference against hand counts and against torch's own
functions."""

import numpy as np
import torch

from bench_port.reference import kmers
from bench_port.reference import models as M


def test_round_tf32_by_hand():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -3.14159265])
    assert M.round_tf32(x).tolist() == [1.0, 1.0, 1 + 2**-9, -3.140625]
    with M.tf32_products():
        a = torch.tensor([[1 + 2**-12]])
        assert M.matmul(a, a).item() == 1.0
    assert M.matmul(a, a).item() == (a * a).item() > 1.0


def test_vocab_by_hand():
    # k = 2: 10 canonical codes; AC (0b0001) is its own pair with GT, AT (0b0011) its own reverse
    vocab = kmers.canonical_vocab(2)
    assert vocab.size == 10 and 0b0001 in vocab and 0b1011 not in vocab
    assert kmers.revcomp(np.array([0b0011]), 2).tolist() == [0b0011]
    assert kmers.gc_count(np.array([0b0110, 0b0000]), 2).tolist() == [2, 0]
    # the point sets' digits: A=0, T=1, C=2, G=3
    assert kmers.vocab_digits(2)[vocab.tolist().index(0b0001)].tolist() == [0, 2]


def test_adam_matches_torch():
    p0 = {"w": torch.tensor([0.5, -1.0, 2.0]), "b": torch.tensor([0.1])}
    grads = [{"w": torch.tensor([1e-3, -2.0, 0.0]), "b": torch.tensor([3.0])},
             {"w": torch.tensor([-1e-3, 1.0, 1e-9]), "b": torch.tensor([-1.0])}]
    ours = M.Adam(p0, 1e-2)
    params = dict(p0)
    leaves = [torch.nn.Parameter(p0["w"].clone()), torch.nn.Parameter(p0["b"].clone())]
    opt = torch.optim.Adam(leaves, lr=1e-2, betas=M.ADAM_BETAS, eps=M.ADAM_EPS)
    for g in grads:
        params = ours.step(params, g)
        leaves[0].grad, leaves[1].grad = g["w"].clone(), g["b"].clone()
        opt.step()
    assert torch.allclose(params["w"], leaves[0].detach(), atol=1e-7)
    assert torch.allclose(params["b"], leaves[1].detach(), atol=1e-7)


def test_lazy_equals_exact_at_a_refresh():
    torch.manual_seed(0)
    k, bd, c = 3, 2, 8
    digits = torch.from_numpy(kmers.vocab_digits(k))
    p = {"lookup": torch.randn(4, bd, dtype=torch.float64),
         "fsw/slices": torch.randn(c, k * bd, dtype=torch.float64),
         "fsw/freqs": torch.arange(c, dtype=torch.float64),
         "fc1/w": torch.randn(c, 5, dtype=torch.float64), "fc1/b": torch.zeros(5, dtype=torch.float64),
         "fc2/w": torch.randn(5, 4, dtype=torch.float64), "fc2/b": torch.zeros(4, dtype=torch.float64)}
    w = torch.rand(3, digits.shape[0], dtype=torch.float64)
    lazy = M.LazyFSW(digits, w)
    lazy.refresh(p)
    got = lazy.embed(p, torch.arange(3))
    exact = torch.stack([M.fsw_forward(p, digits, w[i]) for i in range(3)])
    assert torch.allclose(got, exact, rtol=1e-10, atol=1e-12)


def test_step_lr_matches_the_trainers():
    from kf2vecfsw_tpu_torch.train.schedule import step_lr

    for e in [0, 1, 2, 99, 100, 101, 200, 201, 5000]:
        assert M.step_lr(e, 1e-5, 3e-6, 2000) == step_lr(e, 1e-5, 3e-6, 2000)
    assert M.step_lr(101, 1e-5, 3e-6, 2000) == 3e-6 + 1e-5 * 0.1 ** (100 / 2000)
