"""The port's CUDA kernel on the card against its plain version and the numpy
ground truth, at the k the chip smoke test leaves out (2, the first k of
global-memory bins 8, and MAX_K 13) and at the tile seams.

The kernel has no CPU mode, so every test here needs an NVIDIA card and
nvcc, and skips without them. On the card (where JAX is not installed, so the
JAX package's conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu_torch.io.fasta import INVALID
from kf2vecfsw_tpu_torch.kernels.histogram import kmer_hist, kmer_hist_reference, tile_windows
from kf2vecfsw_tpu_torch.kmer.counter import KmerCounter, count_canonical_numpy

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _codes(rng, n, n_rate=0.01):
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.random(n) < n_rate] = INVALID
    return codes


def _batch(genomes, device):
    offsets = np.zeros(len(genomes) + 1, dtype=np.int64)
    np.cumsum([g.size for g in genomes], out=offsets[1:])
    bases = np.concatenate(genomes) if genomes else np.zeros(0, np.uint8)
    return torch.from_numpy(bases).to(device), torch.from_numpy(offsets).to(device)


@pytest.mark.parametrize("k", [2, 8, 13])
def test_kernel_equals_plain_version_at_the_seams(card, k):
    rng = np.random.default_rng(k)
    tile = tile_windows()
    genomes = [np.zeros(0, np.uint8), _codes(rng, k - 1), np.zeros(3 * tile, np.uint8)]
    genomes += [_codes(rng, tile + d + k - 1) for d in (-k, -1, 0, 1, k)]
    bases, offsets = _batch(genomes, card)
    got = kmer_hist(bases, offsets, k)
    torch.cuda.synchronize()
    assert torch.equal(got, kmer_hist_reference(bases, offsets, k))
    for row, g in zip(got.cpu().numpy(), genomes):
        np.testing.assert_array_equal(row.astype(np.int64), count_canonical_numpy(g, k))
    assert torch.equal(kmer_hist(bases, offsets, k), got)  # integer atomics: deterministic


def test_kmer_counter_launches_once_per_batch(card):
    rng = np.random.default_rng(1)
    seqs_batch = [[_codes(rng, 100_000), _codes(rng, 5)], [], [_codes(rng, 70_001)]]
    counter = KmerCounter(7, device=card)
    before = kmer_hist.launches
    counts = counter.count_batch(seqs_batch)
    assert kmer_hist.launches == before + 1
    cpu = KmerCounter(7, device="cpu").count_batch(seqs_batch)
    np.testing.assert_array_equal(counts, cpu)
    assert kmer_hist.launches == before + 1  # the CPU counter never launches


def test_wrapper_refuses_mixed_devices(card):
    bases, offsets = _batch([_codes(np.random.default_rng(2), 50)], card)
    with pytest.raises(ValueError, match="offsets on cpu"):
        kmer_hist(bases, offsets.cpu(), 5)
