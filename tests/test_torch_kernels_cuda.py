"""The port's CUDA kernels on the card against their plain versions, at the
cases chip_smoke.py leaves out.

``kmer_hist``: against the numpy ground truth at k = 2, the first k of
global-memory bins 8, and MAX_K 13, at the tile seams.
``sort_rows``: a row count that is a multiple of nothing, N = 16,385 (the
first length on the global-merge path), all-equal keys, keys at the f32
extremes; and the FSW model on the card against the CPU at d_out 512.

The kernels have no CPU mode, so every test here needs an NVIDIA card and
nvcc, and skips without them. On the card (where JAX is not installed, so the
JAX package's conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu_torch.io.fasta import INVALID
from kf2vecfsw_tpu_torch.kernels.histogram import kmer_hist, kmer_hist_reference, tile_windows
from kf2vecfsw_tpu_torch.kernels.sort import sort_rows, sort_rows_reference, tile_elems
from kf2vecfsw_tpu_torch.kmer.counter import KmerCounter, count_canonical_numpy
from kf2vecfsw_tpu_torch.models.fsw import FSWDistEmbed, init_fsw_dist_embed_

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


def _assert_sort_matches_plain(keys, payload):
    sk, sp, perm = sort_rows(keys, payload)
    torch.cuda.synchronize()
    rk, _, rperm = sort_rows_reference(keys, payload)
    r, n = keys.shape
    assert torch.equal(sk.view(torch.int32), rk.view(torch.int32))
    p64 = perm.long()
    assert bool(((p64 >= 0) & (p64 < n)).all())
    ramp = torch.arange(n, dtype=torch.int32, device=keys.device).expand(r, n)
    assert torch.equal(torch.sort(perm, dim=1).values, ramp)
    assert torch.equal(torch.gather(keys, 1, p64).view(torch.int32), sk.view(torch.int32))
    rows = torch.arange(r, device=keys.device) // (r // payload.shape[0])
    assert torch.equal(payload[rows[:, None], p64].view(torch.int32), sp.view(torch.int32))
    ints = rk.view(torch.int32)
    tie_free = (ints[:, 1:] != ints[:, :-1]).all(dim=1)
    assert torch.equal(perm[tie_free], rperm[tie_free])


@pytest.mark.parametrize("r,p", [(37, 37), (37, 1), (1031, 1)])
@pytest.mark.parametrize("n", [3, 1000, 16_383, 16_385, 40_000])
def test_sort_equals_plain_version(card, r, p, n):
    gen = torch.Generator(device=card).manual_seed(r * n + p)
    keys = torch.randn(r, n, generator=gen, device=card)
    payload = torch.rand(p, n, generator=gen, device=card)
    before = sort_rows.launches
    _assert_sort_matches_plain(keys, payload)
    assert sort_rows.launches == before + 1
    assert tile_elems() == 16_384  # 16,385 is the first length on the global-merge path


@pytest.mark.parametrize("n", [5, 8192, 16_385])
def test_sort_all_equal_keys_and_f32_extremes(card, n):
    payload = torch.rand(1, n, device=card)
    _assert_sort_matches_plain(torch.full((4, n), 0.5, device=card), payload)
    fi = torch.finfo(torch.float32)
    extremes = torch.tensor([fi.max, -fi.max, fi.tiny, -fi.tiny, float("inf"), float("-inf"),
                             0.0, -0.0, 1e-45, -1e-45], device=card)
    keys = extremes[torch.randint(0, extremes.numel(), (4, n), device=card)]
    _assert_sort_matches_plain(keys, payload)


def test_fsw_model_on_the_card_equals_cpu(card):
    """rtol 1e-3 / atol 1e-4: cos(pi xi cbar) with xi up to 511 multiplies
    the fp32 cumsum's rounding, which differs between the devices, by up to
    ~1.6e3."""
    k, base_dim, d_out, hidden, emb = 7, 4, 512, 64, 32
    model = FSWDistEmbed(k, base_dim, d_out, hidden, emb)
    init_fsw_dist_embed_(model, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    x = np.zeros((3, 2048, k + 1), np.float32)
    for i, n in enumerate((2048, 700, 5)):
        x[i, :n, :k] = rng.integers(0, 4, (n, k))
        x[i, :n, k] = rng.random(n)
    x = torch.from_numpy(x)
    with torch.no_grad():
        ref = model(x)
        before = sort_rows.launches
        got = model.to(card)(x.to(card)).cpu()
    assert sort_rows.launches > before
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-3, atol=1e-4)
