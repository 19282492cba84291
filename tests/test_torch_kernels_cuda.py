"""The port's CUDA kernels on the card against their plain versions, at the
cases chip_smoke.py leaves out.

``kmer_hist``: against the numpy ground truth at k = 2, the first k of
global-memory bins 8, and MAX_K 13, at the tile seams; against the plain
version with genome boundaries at +-k and +-1 of the tile and block-span
seams, and on 5 Mb homopolymers and dinucleotide repeats (many lanes of a
warp on one bin).
``sort_rows``: a row count that is a multiple of nothing, N around the
block sizes of the radix tile sort, the cluster path's lengths from 16,385
to 131,072 with its seams and 131,073 (the first length on the radix
path), the radix path at k = 10's lengths (262,144 to 524,800), its tile
seams and adversarial keys, with its allocations held to
``sort_transient_bytes`` and counted in ``sort_rows.radix_launches``, at
fsw_k10.train_lazy's refresh sort (512 x 646,000, a padded tail of equal
keys; two launches bit-equal), on keys whose digits fill whole tiles or most
of a row (the look-back's sums reach whole tiles and rows), and on 4,096
rows (far more tiles than the card holds at a time), ties on every other row,
all-equal keys (``perm`` the identity),
keys at the f32 extremes; ``perm`` equal to the plain (stable) version's on
every row; ``sort_rows.long_launches`` counting the cluster path's launches
alone; and
the FSW model on the card against the CPU at d_out 512; the sort under
autograd (``SortPW``, ``SortShared``) forward and backward against the CPU.
``refresh_planes`` (``csrc/lazy_refresh.cu``): against the float64
reference of ``tests/torch_refresh_cases.py`` and against its plain version
on the card, at the training cell's 850 x 512 x 8,192, a model-axis rank's
C = 256, k = 8 (V = 32,896) and k = 9 (V = 131,072) on a few items, V at
either side of the shared-memory staging's limit, with an all-zero item
every time; its device memory held to its count; one launch a refresh.
``pergenome_planes`` (the same source's per-genome entry point): against
the float64 reference of ``tests/torch_refresh_cases.py`` and its plain
version at the tile seams (N in {1, tile - 1, tile, tile + 1, 646,000}, k
in {1, 9, 10, 31}, G in {1, 3}) with zero-weight padding and an
all-padding item; two launches bit-equal; its device memory its outputs,
code table and tile partials; one launch a refresh group in ``LazyPlanes``;
at the training cell's 512 x 646,000 its error against float64 no larger
than the plain version's.
The exact forwards' coefficients (the same source's ``exact_coefficients``
and ``exact_coefficients_shared``, forward and backward): against float64
and against the plain chain's autograd on the card, per genome at N in {1,
tile - 1, tile, tile + 1, 100,003} with padding runs and an all-padding
item, and at ``fsw_k10.train_exact``'s chunk (16 x 32 rows of 646,000);
shared at ``fsw_k7.train_exact``'s 16 x 512 x 8,192 (staged), k = 3, k = 8,
V = 8,193, one position past the staging (weights from device memory), and
16 x 64 x 131,072 (k = 9, unstaged), absent k-mers
and an all-zero item every time; two launches bit-equal; their device memory
their outputs and tile partials; ``exact_coefficients.launches`` one a
call, and a training step's count by route and chunks.
Trainers: two epochs of ``train_classifier``, of the dense
``train_model_set``, of each FSW training route (shared-vocab and
per-genome, lazy and exact) and of each chunk trainer on the card against
the CPU, from one CPU generator.
Counting beyond the piece length: a genome of 3-4 pieces (the piece length
lowered) with seams at every offset mod k, against the numpy ground truth.
Chunks: ``get_chunks`` on the card writes the CPU's bytes, and the device
chunk store's batches equal the host store's bit for bit.
Serving: ``place_features`` through the serve daemon on the card, dense and
FSW, against the same request on the CPU.

The kernels have no CPU mode, so every test here needs an NVIDIA card and
nvcc, and skips without them. On the card (where JAX is not installed, so the
JAX package's conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu_torch.io.fasta import INVALID
from kf2vecfsw_tpu_torch.kernels.histogram import (
    kmer_hist,
    kmer_hist_reference,
    span_windows,
    tile_windows,
)
from kf2vecfsw_tpu_torch.kernels.sort import (
    CLUSTER_ELEMS,
    RADIX_TILE,
    TILE_ELEMS,
    cluster_elems,
    cluster_shape,
    items_per_thread,
    radix_counts_words,
    radix_counts_words_on_card,
    sort_rows,
    sort_rows_reference,
    sort_transient_bytes,
    tile_elems,
)
from kf2vecfsw_tpu_torch.kernels.refresh import (
    EXACT_SHARED_TILE,
    PERGENOME_TILE,
    exact_coefficients,
    exact_coefficients_grad,
    exact_coefficients_grad_reference,
    exact_coefficients_reference,
    exact_coefficients_shared,
    exact_coefficients_shared_grad,
    exact_rows_scratch_bytes,
    exact_shared_scratch_bytes,
    exact_shared_tile,
    pergenome_planes,
    pergenome_planes_reference,
    pergenome_scratch_bytes,
    pergenome_tile,
    pergenome_tiles,
    quantile_coefficients,
    refresh_planes,
    refresh_planes_reference,
    scratch_bytes,
    staged_vocab_max,
)
from kf2vecfsw_tpu_torch.kmer.counter import KmerCounter, count_canonical_numpy
from kf2vecfsw_tpu_torch.models import fsw as fsw_model
from kf2vecfsw_tpu_torch.models.fsw import FSWDistEmbed, init_fsw_dist_embed_
from kf2vecfsw_tpu_torch.train.fsw_lazy import LazyPlanes

from .torch_refresh_cases import (
    pergenome_inputs,
    pergenome_planes_float64,
    plane_tolerance,
    planes_float64,
    refresh_inputs,
    rel_err,
)

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


def _ending_near(seams, k, n_total, rng):
    """Genomes laid end to end whose windows stop at seams[i] + d for d in
    (-k, -1, 0, 1, k) in turn, then one genome up to n_total bases."""
    ends = [s + d + k - 1 for s, d in zip(seams, [-k, -1, 0, 1, k] * len(seams))]
    lengths = np.diff([0] + ends + [n_total])
    assert (lengths > 0).all()
    return [_codes(rng, int(n), n_rate=0.001) for n in lengths]


@pytest.mark.parametrize("k", [2, 7, 8, 13])
def test_kernel_equals_plain_version_at_tile_and_span_seams(card, k):
    rng = np.random.default_rng(100 + k)
    tile = tile_windows()
    # a small batch: one tile per block, so genome boundaries meet tile seams
    small = 7 * tile
    assert span_windows(small) == tile
    # a large batch: spans of several tiles; boundaries at span seams and at
    # the first tile seam inside a span
    large = 40_000_000
    span = span_windows(large)
    assert span % tile == 0 and span > tile
    for n_total, seams in ((small, [m * tile for m in range(1, 6)]),
                           (large, [m * span + dt for m in (1, 2, 3) for dt in (0, tile)])):
        genomes = _ending_near(seams, k, n_total, rng)
        bases, offsets = _batch(genomes, card)
        assert bases.numel() == n_total
        got = kmer_hist(bases, offsets, k)
        torch.cuda.synchronize()
        assert torch.equal(got, kmer_hist_reference(bases, offsets, k)), n_total


@pytest.mark.parametrize("k", [2, 7, 8, 13])
def test_kernel_equals_plain_version_on_repeats(card, k):
    n = 5_000_000
    homopolymer = np.zeros(n, np.uint8)
    dinucleotide = np.tile(np.array([0, 1], np.uint8), n // 2)
    bases, offsets = _batch([homopolymer, dinucleotide], card)
    got = kmer_hist(bases, offsets, k)
    torch.cuda.synchronize()
    ref = kmer_hist_reference(bases, offsets, k)
    assert torch.equal(got, ref)
    assert int(got[0].sum()) == n - k + 1 and int((got[1] > 0).sum()) <= 2


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
    assert torch.equal(perm, rperm)  # both stable: equal on every row, ties included
    return perm


@pytest.mark.parametrize("r,p", [(37, 37), (37, 1), (1031, 1)])
@pytest.mark.parametrize("n", [3, 1000, 16_383, 16_385, 40_000])
def test_sort_equals_plain_version(card, r, p, n):
    gen = torch.Generator(device=card).manual_seed(r * n + p)
    keys = torch.randn(r, n, generator=gen, device=card)
    payload = torch.rand(p, n, generator=gen, device=card)
    before = sort_rows.launches, sort_rows.long_launches
    _assert_sort_matches_plain(keys, payload)
    assert sort_rows.launches == before[0] + 1
    assert sort_rows.long_launches == before[1] + (n > tile_elems())
    assert tile_elems() == 16_384  # 16,385 is the first length on the cluster path


# the cluster path (16,384 < N <= 131,072) and its seams: 1 block of 1024
# threads to 17,408, 2 to 34,816, 8 at 131,072, the items a thread stepping
# every 1,024 x blocks elements (24,576 / 24,577: 12 / 13 items of 2
# blocks); 131,073 is the first length on the radix path
LONG_LENGTHS = [16_385, 17_408, 17_409, 24_576, 24_577, 32_768, 32_769, 32_896, 34_816, 34_817,
                49_153, 131_071, 131_072, 131_073]


@pytest.mark.parametrize("r,p", [(37, 37), (37, 1), (1031, 1)])
@pytest.mark.parametrize("n", LONG_LENGTHS)
def test_sort_long_rows_equal_plain_version(card, r, p, n):
    gen = torch.Generator(device=card).manual_seed(r * n + p + 1)
    keys = torch.randn(r, n, generator=gen, device=card)
    keys[::2] = torch.round(keys[::2] * 4) / 4  # ties on every other row
    payload = torch.rand(p, n, generator=gen, device=card)
    before = sort_rows.launches, sort_rows.long_launches
    _assert_sort_matches_plain(keys, payload)
    assert sort_rows.launches == before[0] + 1
    on_cluster = tile_elems() < n <= cluster_elems()
    assert sort_rows.long_launches == before[1] + on_cluster
    assert cluster_elems() == 131_072 == CLUSTER_ELEMS
    assert tile_elems() == 16_384 == TILE_ELEMS
    if on_cluster:
        shape = cluster_shape(n)
        assert 1 <= shape["blocks"] <= 8 and shape["threads"] == 1024
        slots = shape["blocks"] * shape["threads"] * shape["items"]
        assert n <= slots < n + shape["blocks"] * shape["threads"]  # padding in the last block
        assert shape["active_clusters"] >= 1


RADIX_LENGTHS = [262_144, 300_007, 524_800]  # k = 10 point sets, its vocab at 524,800
# the radix path's seams (131,073: the first length on it; a tile of
# 8,192 +- 1 at 18, 32 and 64 tiles), a row of 135 tiles, 4,096 rows of 17
# tiles (69,632 tiles: far more than the card's 2 a SM at a time, so most
# blocks find their predecessors done), and adversarial keys at 300,007: all
# equal (perm the identity), only +-0.0, ascending, descending, and sharing
# their top three bytes (one digit takes every tile in passes 2-4)
RADIX_CASES = ([(r, n, "ties") for r in (1, 33) for n in RADIX_LENGTHS]
               + [(33, n, "ties") for n in (131_073, 147_455, 147_457, 262_143, 262_145,
                                            524_287, 524_289)]
               + [(2, 1_100_000, "ties"), (4096, 131_073, "ties")]
               + [(33, 300_007, kind) for kind in ("all_equal", "signed_zeros", "ascending",
                                                   "descending", "top_bytes_shared")])


def _radix_keys(kind, gen, r, n, card):
    keys = torch.randn(r, n, generator=gen, device=card)
    if kind == "ties":  # ties on every other row
        keys[1::2] = torch.round(keys[1::2] * 4) / 4
    elif kind == "all_equal":
        keys = torch.full((r, n), 0.5, device=card)
    elif kind == "signed_zeros":
        keys = torch.where(keys < 0, -0.0, 0.0)
    elif kind == "ascending":
        keys = torch.sort(keys, dim=1).values
    elif kind == "descending":
        keys = torch.sort(keys, dim=1, descending=True).values
    elif kind == "top_bytes_shared":  # 1.0f's top three bytes, the low byte random
        low = torch.randint(0, 256, (r, n), generator=gen, device=card, dtype=torch.int32)
        keys = (low | 0x3F800000).view(torch.float32)
    elif kind == "tile_runs":  # each byte constant over runs of 3, 5 and 7 whole tiles
        col = torch.arange(n, device=card, dtype=torch.int32)
        bits = ((col // (3 * RADIX_TILE)) % 256 | ((col // (5 * RADIX_TILE)) % 256) << 8
                | ((col // (7 * RADIX_TILE)) % 256) << 16)
        keys = (bits | 0x3F000000).expand(r, n).contiguous().view(torch.float32)
    elif kind == "one_digit_mostly":  # each byte 0x5A in 9 of 10 elements
        bits = torch.randint(0, 1 << 30, (r, n), generator=gen, device=card, dtype=torch.int32)
        for b in range(4):
            common = torch.rand(r, n, generator=gen, device=card) < 0.9
            keep = ~(0xFF << (8 * b)) & 0xFFFFFFFF  # the other bytes, as int32
            keep -= (keep >= 1 << 31) << 32
            bits = torch.where(common, (bits & keep) | (0x5A << (8 * b)), bits)
        keys = bits.view(torch.float32)
    return keys.contiguous()


def _assert_radix_launch_equals_plain_version(keys, payload):
    """One sort_rows launch on the radix path against the plain version,
    ``perm`` included; counted once in ``launches`` and ``radix_launches``
    and not in ``long_launches``; the bytes it asks the caching allocator
    for are ``sort_transient_bytes`` (the allocator's requested bytes, which
    its rounding and block reuse leave out). Returns the outputs."""
    (r, n), p = keys.shape, payload.shape[0]
    assert radix_counts_words_on_card(n) == radix_counts_words(n)
    before = sort_rows.launches, sort_rows.long_launches, sort_rows.radix_launches
    torch.cuda.synchronize()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    got = sort_rows(keys, payload)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_stats()["requested_bytes.all.peak"] - base
    assert (sort_rows.launches, sort_rows.long_launches, sort_rows.radix_launches) == (
        before[0] + 1, before[1], before[2] + 1)
    assert grown == sort_transient_bytes(r, n, p)
    ref = sort_rows_reference(keys, payload)
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return got


@pytest.mark.parametrize("r,n,kind", RADIX_CASES)
def test_sort_radix_lengths_equal_plain_version(card, r, n, kind):
    """Rows past CLUSTER_ELEMS take the radix path: exact, ``perm`` included,
    at payload rows P in {1, R, R/3}, counted in ``launches`` and
    ``radix_launches`` and not in ``long_launches``, and the bytes the
    launch asks for are ``sort_transient_bytes`` (outputs, radix scratch,
    look-back status and digit counts)."""
    gen = torch.Generator(device=card).manual_seed(r + n)
    keys = _radix_keys(kind, gen, r, n, card)
    for p in sorted({1, r} | ({r // 3} if r % 3 == 0 else set())):
        payload = torch.rand(p, n, generator=gen, device=card)
        got = _assert_radix_launch_equals_plain_version(keys, payload)
        if kind == "all_equal":
            assert torch.equal(got[2], torch.arange(n, dtype=torch.int32, device=card).expand(r, n))
        del got


@pytest.mark.parametrize("kind", ["tile_runs", "one_digit_mostly"])
def test_sort_radix_run_heavy_keys_equal_plain_version(card, kind):
    """Keys whose digits fill whole tiles (a tile's count of one digit is the
    whole tile, of the others 0, and runs of tiles send all their items to
    one stretch of the row) or leave most of a row in one digit (a digit's
    run spans many tiles, and the look-back's sums reach the row's length):
    exact at P in {1, R, R/3}."""
    r, n = 33, 646_000
    gen = torch.Generator(device=card).manual_seed(n + len(kind))
    keys = _radix_keys(kind, gen, r, n, card)
    for p in (1, r // 3, r):
        payload = torch.rand(p, n, generator=gen, device=card)
        _assert_radix_launch_equals_plain_version(keys, payload)


def test_sort_radix_refresh_row_equals_plain_version(card):
    """fsw_k10.train_lazy's refresh sort: 512 slices of a point set of
    503,934 points padded to 646,000 (the padding's keys equal, and equal to
    a real key of the row), 40,448 tiles; exact at P in {1, R}, and two
    launches on the same input are bit-equal."""
    r, n, points = 512, 646_000, 503_934
    gen = torch.Generator(device=card).manual_seed(n)
    keys = torch.randn(r, n, generator=gen, device=card)
    keys[:, points:] = keys[:, :1]
    for p in (1, r):
        payload = torch.rand(p, n, generator=gen, device=card)
        got = _assert_radix_launch_equals_plain_version(keys, payload)
        again = sort_rows(keys, payload)
        for a, b in zip(got, again):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        del got, again


def test_sort_equals_plain_version_around_the_block_sizes(card):
    block = 512 * items_per_thread()  # the main path's N = 8,192 fills this block
    gen = torch.Generator(device=card).manual_seed(8)
    for n in (block // 2 - 1, block // 2, block // 2 + 1, block - 1, block, block + 1,
              tile_elems() - 1, tile_elems(), tile_elems() + 1):
        keys = torch.randn(65, n, generator=gen, device=card)
        keys[::2] = torch.round(keys[::2] * 4) / 4  # ties on every other row
        _assert_sort_matches_plain(keys, torch.rand(65, n, generator=gen, device=card))
        _assert_sort_matches_plain(keys[:64].contiguous(), torch.rand(2, n, generator=gen, device=card))


@pytest.mark.parametrize("n", [5, 8192, 8193, 16_384, 16_385, 32_896, 131_072, 131_073])
def test_sort_all_equal_keys_and_f32_extremes(card, n):
    payload = torch.rand(1, n, device=card)
    perm = _assert_sort_matches_plain(torch.full((4, n), 0.5, device=card), payload)
    ramp = torch.arange(n, dtype=torch.int32, device=card).expand(4, n)
    assert torch.equal(perm, ramp)  # stable: all-equal keys keep their order
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


def _backbone(root, sizes=(6, 5), v=32):
    """.kf vectors of two clades, their .subtrees file and .di_mtrx files."""
    from kf2vecfsw_tpu_torch.io.kf import write_kf
    from kf2vecfsw_tpu_torch.tree.distance import write_di_mtrx

    rng = np.random.default_rng(9)
    kf_dir = root / "kf"
    kf_dir.mkdir()
    rows = []
    for c, n in enumerate(sizes):
        names = [f"c{c}g{i}" for i in range(n)]
        rows += [(g, c) for g in names]
        for g in names:
            x = rng.random(v) + (np.arange(v) % 2 == c)
            write_kf(str(kf_dir / f"{g}.kf"), [(g, x / x.sum())])
        d = np.abs(rng.normal(size=(n, n))) * 0.1
        d = d + d.T
        np.fill_diagonal(d, 0)
        write_di_mtrx(str(root / f"t_subtree_{c}.di_mtrx"), names, d)
    (root / "t.subtrees").write_text("genome clade\n" + "".join(f"{g} {c}\n" for g, c in rows))
    return str(kf_dir), sorted(str(p) for p in kf_dir.glob("*.kf")), str(root / "t.subtrees")


def _csv(path, header):
    with open(path) as f:
        if header:
            f.readline()
        return np.array([line.rstrip("\n").split("\t")[1:] for line in f], dtype=np.float64)


def test_trainers_on_the_card_equal_cpu(card, tmp_path):
    """Two epochs of each trainer at the default learning rate on the card and
    on the CPU, from one CPU generator (same initial weights, same batches).
    Params within atol 2 * 1.02 * lr * steps + rtol 1e-4: Adam's first steps
    move a weight by about lr * sign(grad) (a bias-corrected step is at most
    1.015 lr over the first six steps), and a gradient of rounding-noise size
    (the distance model's biases: pairwise distances do not change when all
    embeddings move together) can round to opposite signs on the two
    devices. Embeddings within atol 1e-3 (those bias steps, summed over 64
    hidden units), translation-invariant distortions and probabilities
    within rtol 1e-3 / atol 1e-5; losses finite and within rtol 1e-4."""
    from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint
    from kf2vecfsw_tpu_torch.train.classifier import train_classifier_func
    from kf2vecfsw_tpu_torch.train.distance import train_model_set_func

    kf_dir, files, sub = _backbone(tmp_path)
    lr, epochs, batch = 1e-5, 2, 4
    runs = {}
    for dev in ("cpu", "cuda"):
        out = tmp_path / dev
        train_classifier_func(kf_dir, files, sub, epochs, 64, batch, lr, 3e-6, 2000, 28, False,
                              str(out), device=dev)
        train_model_set_func(kf_dir, files, sub, str(tmp_path), epochs, 64, 16, batch, lr, 3e-6,
                             2000, None, 28, str(out), use_fsw=False, device=dev)
        runs[dev] = out
    cpu, gpu = runs["cpu"], runs["cuda"]
    for name, steps in (("classifier_model", epochs * 3), ("model_subtree_0", epochs * 2),
                        ("model_subtree_1", epochs * 2)):
        _, m_cpu, p_cpu = load_checkpoint(str(cpu / f"{name}.ckpt"))
        _, m_gpu, p_gpu = load_checkpoint(str(gpu / f"{name}.ckpt"))
        assert np.isfinite(m_gpu["lowest_loss"]) and m_gpu["best_epoch"] == m_cpu["best_epoch"]
        np.testing.assert_allclose(m_gpu["lowest_loss"], m_cpu["lowest_loss"], rtol=1e-4)
        for layer in p_cpu:
            for leaf in p_cpu[layer]:
                np.testing.assert_allclose(p_gpu[layer][leaf], p_cpu[layer][leaf], rtol=1e-4,
                                           atol=2 * 1.02 * lr * steps,
                                           err_msg=f"{name} {layer}/{leaf}")
    np.testing.assert_allclose(_csv(gpu / "backbone_classes.out", True)[:, 2:],
                               _csv(cpu / "backbone_classes.out", True)[:, 2:], rtol=1e-3, atol=1e-5)
    for c in range(2):
        np.testing.assert_allclose(_csv(gpu / f"embeddings_subtree_{c}.csv", False),
                                   _csv(cpu / f"embeddings_subtree_{c}.csv", False), atol=1e-3)
        np.testing.assert_allclose(_csv(gpu / f"distortions_subtree_{c}.csv", True),
                                   _csv(cpu / f"distortions_subtree_{c}.csv", True),
                                   rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("shared", [False, True])
def test_sort_autograd_on_the_card_equals_cpu(card, shared):
    """SortPW (16 genomes x 32 slices of 2,000 points) and SortShared (512
    slices of the 8,192-entry vocab, 16 genomes) forward and backward on the
    card equal the plain version on the CPU. The sorted keys, the sorted
    weights and SortPW's gradient bit for bit: the sort is stable on both,
    and the unsort is a scatter of the same values (SortShared's second
    output is its perm, equal on both). SortShared's gradient
    unsorts the cotangent that autograd sums over the 16 genomes, in an
    order of additions that differs between the devices: within fp32
    rounding of that sum (``torch.testing.assert_close``'s float32 default,
    rtol 1.3e-6 / atol 1e-5)."""
    from kf2vecfsw_tpu_torch.models.fsw import SortPW, SortShared

    gen = torch.Generator().manual_seed(11)
    b, c, n = (16, 512, 8192) if shared else (16, 32, 2000)
    keys = torch.randn(c if shared else b * c, n, generator=gen)
    weights = torch.rand(b, n, generator=gen)
    cot = torch.randn((b, c, n) if shared else (b * c, n), generator=gen)
    grads = []
    for dev in ("cpu", card):
        k = keys.to(dev, copy=True).requires_grad_()
        before = sort_rows.launches
        ps, ws = (SortShared if shared else SortPW).apply(k, weights.to(dev))
        assert sort_rows.launches == before + (dev != "cpu")
        ((ps[None] if shared else ps) * cot.to(dev)).sum().backward()
        grads.append((ps.detach().cpu(), ws.cpu(), k.grad.cpu()))
    (ps_cpu, ws_cpu, grad_cpu), (ps_gpu, ws_gpu, grad_gpu) = grads
    assert torch.equal(ps_gpu, ps_cpu) and torch.equal(ws_gpu, ws_cpu)
    if shared:
        torch.testing.assert_close(grad_gpu, grad_cpu)
    else:
        assert torch.equal(grad_gpu, grad_cpu)


def _fsw_backbone(root, route, n=10, k_shared=3, k_pergenome=5):
    """One clade of n .npy point sets (k=3, every canonical k-mer: the
    shared-vocab route; or k=5, 20-90 distinct k-mers padded to 128 < V/3:
    the per-genome route), the .subtrees file and the .di_mtrx."""
    from kf2vecfsw_tpu_torch.kmer.vocab import FSW_BASE_MAP, canonical_vocab_codes, codes_to_digit_matrix
    from kf2vecfsw_tpu_torch.tree.distance import write_di_mtrx

    rng = np.random.default_rng(12)
    k = k_shared if route.endswith("shared") else k_pergenome
    codes = canonical_vocab_codes(k)
    feats = root / "npy"
    feats.mkdir()
    names = [f"g{i}" for i in range(n)]
    for g in names:
        pick = codes if k == k_shared else np.sort(rng.choice(codes, int(rng.integers(20, 91)),
                                                             replace=False))
        w = rng.random(len(pick)) + 0.01
        mat = np.column_stack((codes_to_digit_matrix(pick, k, FSW_BASE_MAP), w / w.sum()))
        np.save(feats / f"{g}_k{k}.npy", mat.astype(np.float32))
    d = np.abs(rng.normal(size=(n, n))) * 0.1
    d = d + d.T
    np.fill_diagonal(d, 0)
    write_di_mtrx(str(root / f"t_subtree_0.di_mtrx"), names, d)
    (root / "t.subtrees").write_text("genome clade\n" + "".join(f"{g} 0\n" for g in names))
    return str(feats), sorted(str(p) for p in feats.glob("*.npy")), str(root / "t.subtrees")


@pytest.mark.parametrize("route", ["lazy_shared", "exact_shared", "lazy_pergenome",
                                   "exact_pergenome"])
def test_fsw_training_routes_on_the_card_equal_cpu(card, tmp_path, route):
    """Two epochs of FSW train_model_set (10 genomes, batch 4: 3 steps an
    epoch; 16 slices, base_dim 2, H 64, E 16, lr 1e-5) on the card and on the
    CPU from one CPU generator. Params within the Adam sign-flip bound of
    the dense trainers (atol 2 * 1.02 * the sum of the scheduled lr over the
    steps, lr_min + lr from the second epoch, + rtol 1e-4), best losses
    within rtol 1e-4; embeddings and distortions within rtol 1e-3 / atol
    1e-4, the FSW forward's cuda-vs-cpu tolerance, plus 1e-3 for the sign
    flips summed over 64 hidden units."""
    from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint
    from kf2vecfsw_tpu_torch.train.distance import train_model_set_func

    from kf2vecfsw_tpu_torch.train.schedule import step_lr

    feats, files, sub = _fsw_backbone(tmp_path, route)
    lr, lr_min, epochs = 1e-5, 3e-6, 2
    drift = 2 * 1.02 * 3 * sum(step_lr(e, lr, lr_min, 2000) for e in range(epochs))
    runs = {}
    for dev in ("cpu", "cuda"):
        out = tmp_path / dev
        before = sort_rows.launches
        train_model_set_func(feats, files, sub, str(tmp_path), epochs, 64, 16, 4, lr, lr_min, 2000,
                             None, 28, str(out), base_dim=2, fswout_dim=16,
                             fsw_lazy_refresh=0 if route.startswith("exact") else None,
                             device=dev)
        launched = sort_rows.launches - before
        assert launched == 0 if dev == "cpu" else launched >= 2  # training and the export
        log = "".join(p.read_text() for p in out.glob("train_model_*.log"))
        assert ("FSW shared-vocab path" in log) == route.endswith("shared")
        assert ("FSW lazy sort-refresh path" in log) == route.startswith("lazy")
        runs[dev] = out
    cpu, gpu = runs["cpu"], runs["cuda"]
    name_c, m_cpu, p_cpu = load_checkpoint(str(cpu / "model_subtree_0.ckpt"))
    name_g, m_gpu, p_gpu = load_checkpoint(str(gpu / "model_subtree_0.ckpt"))
    assert name_c == name_g == "NeuralNetFSW" and m_gpu["best_epoch"] == m_cpu["best_epoch"]
    np.testing.assert_allclose(m_gpu["lowest_loss"], m_cpu["lowest_loss"], rtol=1e-4)
    for key in ("lookup", "fsw/slices", "fsw/freqs", "fc1/w", "fc1/b", "fc2/w", "fc2/b"):
        a, b = p_gpu, p_cpu
        for part in key.split("/"):
            a, b = a[part], b[part]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=drift, err_msg=key)
    np.testing.assert_allclose(_csv(gpu / "embeddings_subtree_0.csv", False),
                               _csv(cpu / "embeddings_subtree_0.csv", False), rtol=1e-3,
                               atol=1.1e-3)
    np.testing.assert_allclose(_csv(gpu / "distortions_subtree_0.csv", True),
                               _csv(cpu / "distortions_subtree_0.csv", True), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("k", [3, 7, 13])
def test_kmer_counter_counts_a_genome_beyond_its_piece_length(card, monkeypatch, k):
    """The CPU test of the same name on the card: one genome of 4 pieces,
    with N runs across every other seam, between two short genomes."""
    from kf2vecfsw_tpu_torch.kmer import counter as counter_mod
    from kf2vecfsw_tpu_torch.kmer.counter import concat_with_separators

    rng = np.random.default_rng(400 + k)
    counter = KmerCounter(k, device=card)
    for piece in range(200_000, 200_000 + k):
        step = piece - k + 1
        genome = _codes(rng, 3 * step + piece // 4)
        for j in range(1, 4, 2):
            genome[j * step - 2 : j * step + 1] = INVALID
        batch = [[_codes(rng, 500)], [genome, _codes(rng, 301)], [_codes(rng, 9_000)]]
        want = np.stack([count_canonical_numpy(concat_with_separators(seqs, k), k)
                         for seqs in batch])[:, counter.vocab]
        monkeypatch.setattr(counter_mod, "PIECE_BASES", piece)
        before = kmer_hist.launches
        np.testing.assert_array_equal(counter.count_batch(batch), want)
        assert kmer_hist.launches == before + 1  # 6 rows of one launch


def _chunk_fasta(root, n=4):
    rng = np.random.default_rng(13)
    fna = root / "fna"
    fna.mkdir()
    for i in range(n):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=int(rng.integers(50_000, 120_001)),
                         p=[0.2475, 0.2525, 0.25, 0.24, 0.01])
        (fna / f"g{i}.fna").write_bytes(b">a\n%s\n>b\n%s\n" % (seq[:30_000].tobytes(),
                                                                seq[30_000:].tobytes()))
    return fna


@pytest.mark.parametrize("k", [3, 7])
def test_get_chunks_on_the_card_equals_cpu(card, tmp_path, k):
    from kf2vecfsw_tpu_torch.ingest.chunks import get_chunks

    fna = _chunk_fasta(tmp_path)
    outs = {}
    for dev in ("cpu", "cuda"):
        outs[dev] = tmp_path / dev
        outs[dev].mkdir()
        before = kmer_hist.launches
        written = get_chunks(str(fna), str(outs[dev]), k=k, device=dev)
        assert len(written) == 4
        assert (kmer_hist.launches > before) == (dev == "cuda")
    for path in outs["cpu"].glob("*.kf"):
        assert (outs["cuda"] / path.name).read_bytes() == path.read_bytes()


def _chunk_backbone(root):
    """Chunk .kf rows of two clades (8-30 windows of raw counts at k=3),
    full-genome .kf vectors, .subtrees and .di_mtrx."""
    from kf2vecfsw_tpu_torch.io.kf import write_kf
    from kf2vecfsw_tpu_torch.tree.distance import write_di_mtrx

    rng = np.random.default_rng(14)
    chunks_dir, full_dir = root / "chunks", root / "full"
    chunks_dir.mkdir()
    full_dir.mkdir()
    rows = []
    for c, n in enumerate((6, 5)):
        names = [f"c{c}g{i}" for i in range(n)]
        rows += [(g, c) for g in names]
        for g in names:
            mat = rng.integers(0, 60, size=(int(rng.integers(8, 31)), 32)).astype(np.float64)
            mat[:, c::2] += 20
            write_kf(str(chunks_dir / f"{g}.kf"), [(f"{g}.w{i}", r) for i, r in enumerate(mat)])
            total = mat.sum(axis=0)
            write_kf(str(full_dir / f"{g}.kf"), [(g, total / total.sum())])
        d = np.abs(rng.normal(size=(n, n))) * 0.1
        d = d + d.T
        np.fill_diagonal(d, 0)
        write_di_mtrx(str(root / f"t_subtree_{c}.di_mtrx"), names, d)
    (root / "t.subtrees").write_text("genome clade\n" + "".join(f"{g} {c}\n" for g, c in rows))
    return str(chunks_dir), str(full_dir), sorted(str(p) for p in chunks_dir.glob("*.kf")), str(root / "t.subtrees")


def test_device_chunk_store_batches_equal_the_host_store(card, tmp_path):
    """Bit for bit: int32 prefix sums gathered on the card against int64 sums
    on the host, both normalised in float64 and cast to float32 last."""
    from kf2vecfsw_tpu_torch.train.chunks import ChunkStore, DeviceChunkStore, batch_source, epoch_plan

    _, _, files, _ = _chunk_backbone(tmp_path)
    host = ChunkStore(files)
    dev = DeviceChunkStore(host.matrices, card)
    assert dev.prefix.is_cuda
    for seed, epoch, draws in ((28, 0, 2), (28, 9, 1), (3, 500, 2)):
        _, spans = epoch_plan(seed, epoch, host.counts, draws)
        rows = 4 * draws
        on_card = batch_source(host, dev, spans, rows, card)
        on_host = batch_source(host, None, spans, rows, card)
        for bi in range(-(-len(files) // 4)):
            a, b = on_card(bi), on_host(bi)
            assert a.is_cuda and b.is_cuda
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_chunk_trainers_on_the_card_equal_cpu(card, tmp_path):
    """Two epochs of each chunk trainer (batch 4, H 64, E 16, lr 1e-5) on the
    card and on the CPU from one CPU generator and one span stream: params
    within the Adam sign-flip bound of ``test_trainers_on_the_card_equal_cpu``
    (2 * 1.02 * the lr summed over the steps, lr_min + lr from the second
    epoch, + rtol 1e-4), best losses within rtol 1e-4; class probabilities,
    embeddings and distortions as there."""
    from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint
    from kf2vecfsw_tpu_torch.train.chunks import train_classifier_chunks_func, train_model_set_chunks_func
    from kf2vecfsw_tpu_torch.train.schedule import step_lr

    chunks_dir, full_dir, files, sub = _chunk_backbone(tmp_path)
    lr, lr_min, epochs, batch = 1e-5, 3e-6, 2, 4
    per_step = 2 * 1.02 * sum(step_lr(e, lr, lr_min, 2000) for e in range(epochs))
    runs = {}
    for dev in ("cpu", "cuda"):
        out = tmp_path / dev
        train_classifier_chunks_func(chunks_dir, full_dir, files, sub, epochs, 64, batch, lr, lr_min,
                                     2000, 28, False, False, str(out), device=dev)
        train_model_set_chunks_func(chunks_dir, full_dir, files, sub, str(tmp_path), epochs, 64, 16,
                                    batch, lr, lr_min, 2000, None, 28, False, str(out), device=dev)
        log = "".join(p.read_text() for p in out.glob("*.log"))
        assert log.count("Chunk store: device-resident prefix sums") == 3
        runs[dev] = out
    cpu, gpu = runs["cpu"], runs["cuda"]
    for name, steps in (("classifier_model", 3), ("model_subtree_0", 2), ("model_subtree_1", 2)):
        _, m_cpu, p_cpu = load_checkpoint(str(cpu / f"{name}.ckpt"))
        _, m_gpu, p_gpu = load_checkpoint(str(gpu / f"{name}.ckpt"))
        assert np.isfinite(m_gpu["lowest_loss"]) and m_gpu["best_epoch"] == m_cpu["best_epoch"]
        np.testing.assert_allclose(m_gpu["lowest_loss"], m_cpu["lowest_loss"], rtol=1e-4)
        for layer in p_cpu:
            for leaf in p_cpu[layer]:
                np.testing.assert_allclose(p_gpu[layer][leaf], p_cpu[layer][leaf], rtol=1e-4,
                                           atol=per_step * steps, err_msg=f"{name} {layer}/{leaf}")
    np.testing.assert_allclose(_csv(gpu / "backbone_classes.out", True)[:, 2:],
                               _csv(cpu / "backbone_classes.out", True)[:, 2:], rtol=1e-3, atol=1e-5)
    for c in range(2):
        np.testing.assert_allclose(_csv(gpu / f"embeddings_subtree_{c}.csv", False),
                                   _csv(cpu / f"embeddings_subtree_{c}.csv", False), atol=1e-3)
        np.testing.assert_allclose(_csv(gpu / f"distortions_subtree_{c}.csv", True),
                                   _csv(cpu / f"distortions_subtree_{c}.csv", True),
                                   rtol=1e-3, atol=1e-5)


def _serving_library(root, fsw_k, v=32, hidden=64, emb=16, n_anchors=8):
    """A classifier and two subtree models (dense, or FSW at fsw_k with
    base_dim 2 and 16 slices) with their anchors, from one CPU generator, and
    six queries' .kf vectors (and point sets for FSW)."""
    from kf2vecfsw_tpu_torch.io.kf import write_kf
    from kf2vecfsw_tpu_torch.models.mlp import Classifier, DistEmbed, init_params_, params_to_jax
    from kf2vecfsw_tpu_torch.train.checkpoint import save_checkpoint
    from kf2vecfsw_tpu_torch.train.distance import f32_row

    gen = torch.Generator().manual_seed(21)
    rng = np.random.default_rng(21)
    lib, q = root / "lib", root / "q"
    lib.mkdir()
    q.mkdir()
    save_checkpoint(str(lib / "classifier_model.ckpt"), "NeuralNetClassifierOnly",
                    {"model_input_size": v, "model_hidden_size_fc1": hidden, "model_class_count": 2},
                    params_to_jax(init_params_(Classifier(v, hidden, 2), gen)))
    for c in range(2):
        if fsw_k:
            model = init_fsw_dist_embed_(FSWDistEmbed(fsw_k, 2, 16, hidden, emb), gen)
            meta = {"model_input_size": fsw_k + 1, "fsw_k": fsw_k, "fsw_base_dim": 2,
                    "fsw_out_dim": 16}
        else:
            model = init_params_(DistEmbed(v, hidden, emb), gen)
            meta = {"model_input_size": v}
        save_checkpoint(str(lib / f"model_subtree_{c}.ckpt"), "NeuralNetFSW" if fsw_k else "NeuralNet",
                        {**meta, "model_hidden_size_fc1": hidden, "model_embedding_size": emb},
                        params_to_jax(model))
        (lib / f"embeddings_subtree_{c}.csv").write_text("".join(
            f"a{c}_{i}\t" + f32_row(rng.normal(size=emb).astype(np.float32)) for i in range(n_anchors)))
    for i in range(6):
        x = rng.random(v) + 2.0 * (np.arange(v) % 2 == i % 2)
        write_kf(str(q / f"q{i}.kf"), [(f"q{i}", x / x.sum())])
        if fsw_k:
            n = int(rng.integers(5, 30))
            pts = np.concatenate([rng.integers(0, 4, (n, fsw_k)), rng.random((n, 1))], axis=1)
            np.save(q / f"q{i}_k{fsw_k}.npy", pts.astype(np.float32))
    return str(lib), str(q)


def _tsv(path, header):
    with open(path) as f:
        if header:
            f.readline()
        return {p[0]: np.array(p[1:], dtype=np.float64)
                for p in (line.rstrip("\n").split("\t") for line in f)}


@pytest.mark.parametrize("fsw_k", [None, 3])
def test_serve_place_features_on_the_card_equals_cpu(card, tmp_path, fsw_k):
    """``place_features`` through the serve daemon on the card against the
    same request on the CPU, with the main path's tolerances: class
    probabilities within rtol 1e-4, APPLES and `.emb` rows within rtol 1e-4 /
    atol 1e-5 (dense) or 1e-3 / 1e-4 (FSW, see
    ``test_fsw_model_on_the_card_equals_cpu``), for every genome whose top
    two classes are more than 1e-3 apart in log-probability."""
    import io
    import json

    from kf2vecfsw_tpu_torch.cli import build_parser
    from kf2vecfsw_tpu_torch.infer.cache import clear_all
    from kf2vecfsw_tpu_torch.infer.serve import ServeDaemon

    lib, q = _serving_library(tmp_path, fsw_k)
    outs = {}
    for dev in ("cpu", "cuda"):
        clear_all()
        outs[dev] = tmp_path / f"out_{dev}"
        args = build_parser().parse_args(["serve", "-classifier_model", lib, "-distance_model", lib,
                                          "-device", dev])
        requests = [{"cmd": "warm"}, {"cmd": "place_features", "features_dir": q,
                                      "output_dir": str(outs[dev])}]
        stdout = io.StringIO()
        before = sort_rows.launches
        ServeDaemon(args).serve(stdin=io.StringIO("".join(json.dumps(r) + "\n" for r in requests)),
                                stdout=stdout)
        replies = [json.loads(line) for line in stdout.getvalue().splitlines()]
        assert all(r["ok"] for r in replies), replies
        assert replies[1]["models"] == 3
        assert (sort_rows.launches > before) == (dev == "cuda" and fsw_k is not None)
    clear_all()
    cls_cpu, cls_gpu = (_tsv(outs[d] / "classes.out", True) for d in ("cpu", "cuda"))
    assert sorted(cls_cpu) == sorted(cls_gpu) == [f"q{i}" for i in range(6)]
    rtol, atol = (1e-3, 1e-4) if fsw_k else (1e-4, 1e-5)
    compared = 0
    for g in cls_cpu:
        np.testing.assert_allclose(cls_gpu[g][2:], cls_cpu[g][2:], rtol=1e-4, atol=1e-7)
        with np.errstate(divide="ignore"):  # a probability may round to 0
            logp = np.sort(np.log(cls_gpu[g][2:]))
        if logp[-1] - logp[-2] <= 1e-3:
            continue
        assert cls_gpu[g][0] == cls_cpu[g][0]
        c = int(cls_gpu[g][0])
        for name, header in ((f"apples_input_di_mtrx_subtree_{c}.csv", True),
                             (f"embedding_subtree_{c}.emb", False)):
            a, b = (_tsv(outs[d] / name, header)[g] for d in ("cuda", "cpu"))
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{g} {name}")
        compared += 1
    assert compared >= 3


# (k, C, n, vocab): the training cell, a model-axis rank's slices, k = 8 and
# k = 9 (weights gathered from device memory), a small k; vocab None is the
# canonical vocab at k
REFRESH_CASES = [(7, 512, 850, None), (7, 256, 9, None), (8, 512, 5, None), (9, 512, 3, None),
                 (3, 16, 6, None)]


def _refresh_against_references(inputs, got):
    """Every item's planes within ``plane_tolerance`` of float64, and within
    twice that of the plain version on the card (both float32, summed in
    other orders); the all-zero last item exactly zero."""
    ps, perm, wn, freqs, digits = inputs
    s, g2 = got
    n, c = g2.shape
    s64, g64 = planes_float64(*inputs)
    plain_s, plain_g2 = refresh_planes_reference(*inputs, 8)
    tol = plane_tolerance(c)
    worst = {"float64": 0.0, "plain": 0.0}
    for i in range(n - 1):
        worst["float64"] = max(worst["float64"], rel_err(s[i], s64[i]), rel_err(g2[i], g64[i]))
        worst["plain"] = max(worst["plain"], rel_err(s[i], plain_s[i]),
                             rel_err(g2[i], plain_g2[i]))
    assert worst["float64"] <= tol and worst["plain"] <= 2 * tol, (worst, tol)
    assert torch.equal(s[-1], torch.zeros_like(s[-1]))
    assert torch.equal(g2[-1], torch.zeros_like(g2[-1]))


@pytest.mark.parametrize("k,c,n,vocab", REFRESH_CASES)
def test_refresh_kernel_equals_float64_and_plain_version(card, k, c, n, vocab):
    inputs = refresh_inputs(k, c, n, 1000 * k + c, card, vocab)
    before = refresh_planes.launches
    got = refresh_planes(*inputs)
    torch.cuda.synchronize()
    assert refresh_planes.launches == before + 1
    assert got[0].shape == (n, c, k, 4) and got[1].shape == (n, c)
    _refresh_against_references(inputs, got)


@pytest.mark.parametrize("side", [0, 1])
def test_refresh_kernel_at_the_staging_limit(card, side):
    """V at the largest that a block stages in shared memory (side 0) and one
    past it (side 1: the weights gathered from device memory), random digits."""
    v = staged_vocab_max() + side
    inputs = refresh_inputs(7, 64, 6, 77 + side, card, vocab=v)
    got = refresh_planes(*inputs)
    torch.cuda.synchronize()
    _refresh_against_references(inputs, got)


def test_refresh_kernel_memory_is_its_outputs_and_records(card):
    """The launch allocates its records (``scratch_bytes``) and its planes:
    at the training cell's shape 50 MB of each, where the plain version's
    groups hold 2.1 GB."""
    k, c, n = 7, 512, 850
    inputs = refresh_inputs(k, c, n, 9, card)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    refresh_planes(*inputs)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert grown <= scratch_bytes(c, inputs[0].shape[1]) + 4 * n * c * (4 * k + 1) + 2 * 512


def test_lazy_planes_launch_the_kernel_once_a_refresh(card):
    """A shared-route refresh is one sort and one planes launch, whatever the
    group, and its planes are the wrapper's on that sort, bit for bit (the
    kernel sums in a fixed order)."""
    k, c, n = 5, 64, 11
    gen = torch.Generator().manual_seed(11)
    model = init_fsw_dist_embed_(FSWDistEmbed(k, 2, c, 16, 8), gen).to(card)
    w = torch.rand(n, fsw_model.canonical_vocab_size(k), generator=gen).to(card)
    planes = LazyPlanes(w, True, 4, 3, 4)
    sorts, launches = sort_rows.launches, refresh_planes.launches
    for _ in range(2):
        planes.refresh(model)
    torch.cuda.synchronize()
    assert sort_rows.launches == sorts + 2 and refresh_planes.launches == launches + 2
    with torch.no_grad():
        digits = fsw_model.vocab_digits(k, card)
        wn = fsw_model._normalized(w)
        keys = (model.slices @ fsw_model.lookup_points(model.lookup, digits).T).contiguous()
        ps, _, perm = sort_rows(keys, wn[:1])
        s, g2 = refresh_planes(ps, perm, wn, model.freqs, digits)
    assert torch.equal(planes.s, s) and torch.equal(planes.g2, g2)


def _pergenome_errors(inputs, got) -> dict[str, float]:
    """The largest relative norm error of any item's S or g2: the kernel's
    against float64 and against the plain version on the card, and the
    plain version's against float64 (the all-padding item, which reads 0,
    left out)."""
    plain = pergenome_planes_reference(*inputs)
    want = pergenome_planes_float64(*inputs)
    g = got[1].shape[0]
    items = range(g - 1 if g > 1 else g)
    worst = {"kernel": 0.0, "kernel_vs_plain": 0.0, "plain": 0.0}
    for a, b, w in zip(got, plain, want):
        for i in items:
            worst["kernel"] = max(worst["kernel"], rel_err(a[i], w[i]))
            worst["kernel_vs_plain"] = max(worst["kernel_vs_plain"], rel_err(a[i], b[i]))
            worst["plain"] = max(worst["plain"], rel_err(b[i], w[i]))
    return worst


def test_pergenome_tile_is_the_hosts(card):
    assert pergenome_tile() == PERGENOME_TILE


@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("k", [1, 9, 10, 31])
@pytest.mark.parametrize("n", [1, PERGENOME_TILE - 1, PERGENOME_TILE, PERGENOME_TILE + 1,
                               646_000])
def test_pergenome_kernel_equals_float64_and_plain_version(card, n, k, g):
    """Every item within ``plane_tolerance`` of float64, and within the plain
    version's own error of it; a fifth of each item's points padding; at G =
    3 a heavy item and an all-padding item, whose planes are exactly zero."""
    c = 32
    inputs = pergenome_inputs(g, c, n, k, 7 * n + k + g, card, real=n - n // 5)
    before = pergenome_planes.launches
    got = pergenome_planes(*inputs)
    torch.cuda.synchronize()
    assert pergenome_planes.launches == before + 1
    assert got[0].shape == (g, c, k, 4) and got[1].shape == (g, c)
    worst = _pergenome_errors(inputs, got)
    tol = plane_tolerance(c)
    assert worst["kernel"] <= tol and worst["kernel_vs_plain"] <= worst["plain"] + tol, (worst, tol)
    if g > 1:
        assert torch.equal(got[0][-1], torch.zeros_like(got[0][-1]))
        assert torch.equal(got[1][-1], torch.zeros_like(got[1][-1]))


def test_pergenome_kernel_is_deterministic(card):
    """No float atomics: two launches give the same bits."""
    inputs = pergenome_inputs(2, 64, 100_003, 10, 5, card, real=90_000)
    a, b = pergenome_planes(*inputs), pergenome_planes(*inputs)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_pergenome_kernel_memory_is_its_outputs_codes_and_partials(card):
    """The launch allocates its planes, its code table and its tile partials
    (``pergenome_scratch_bytes``): nothing of size (G*C, N)."""
    g, c, n, k = 2, 512, 200_000, 10
    inputs = pergenome_inputs(g, c, n, k, 9, card)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pergenome_planes(*inputs)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert grown <= pergenome_scratch_bytes(g, c, n, k) + 4 * g * c * (4 * k + 1) + 5 * 512
    assert grown < 4 * g * c * n  # not one f32 buffer of the rows


def test_lazy_planes_launch_the_pergenome_kernel_once_a_group(card):
    """A per-genome refresh of 5 items in groups of 2 is 3 sorts and 3
    launches, and its planes are the wrapper's on those sorts, bit for bit."""
    k, c, n = 10, 64, 3000
    gen = torch.Generator().manual_seed(12)
    model = init_fsw_dist_embed_(FSWDistEmbed(k, 2, c, 16, 8), gen).to(card)
    x = torch.zeros(5, n, k + 1)
    x[..., :k] = torch.randint(0, 4, (5, n, k), generator=gen).float()
    x[:, : n - 500, -1] = torch.rand(5, n - 500, generator=gen)  # 500 padding rows each
    x = x.to(card)
    planes = LazyPlanes(x, False, 4, 3, 2)
    sorts, launches = sort_rows.launches, pergenome_planes.launches
    for _ in range(2):
        planes.refresh(model)
    torch.cuda.synchronize()
    assert sort_rows.launches == sorts + 6 and pergenome_planes.launches == launches + 6
    with torch.no_grad():
        want = [pergenome_planes(*fsw_model._sorted_group(model.slices, model.lookup, x[rows]),
                                 model.freqs) for rows in (slice(0, 2), slice(2, 4), slice(4, 5))]
    assert torch.equal(planes.s, torch.cat([s for s, _ in want]))
    assert torch.equal(planes.g2, torch.cat([g2 for _, g2 in want]))


def test_pergenome_kernel_at_the_cell_is_closer_to_float64_than_plain(card):
    """At ``fsw_k10.train_lazy``'s group (one item, 512 slices, N = 646,000
    with 503,934 real points) the kernel's error against float64 is no
    larger than the plain version's, in S and in g2."""
    inputs = pergenome_inputs(1, 512, 646_000, 10, 2819900002, card, real=503_934)
    got = pergenome_planes(*inputs)
    plain = pergenome_planes_reference(*inputs)
    want = pergenome_planes_float64(*inputs)
    for a, b, w in zip(got, plain, want):
        assert rel_err(a[0], w[0]) <= rel_err(b[0], w[0]), (rel_err(a[0], w[0]),
                                                            rel_err(b[0], w[0]))
    assert rel_err(got[0][0], want[0][0]) <= plane_tolerance(512)


# -- the exact forwards' coefficients --------------------------------------------


def _exact_errors(got: tuple, want64: tuple, plain: tuple, items: int) -> dict:
    """For each of E (B, C), d_ps and d_xi the largest relative norm error:
    the kernel's and the plain chain's against float64, and the kernel's
    against the plain chain; E and a per-genome d_ps item by item, the first
    ``items`` items (an all-zero item reads 0)."""
    worst = {}
    for name, a, w, b in zip(("e", "d_ps", "d_xi"), got, want64, plain):
        parts = range(items) if name == "e" or a.dim() == 3 else [slice(None)]
        worst[name] = {
            "kernel": max(rel_err(a[i], w[i]) for i in parts),
            "plain": max(rel_err(b[i], w[i]) for i in parts),
            "kernel_vs_plain": max(rel_err(a[i], b[i]) for i in parts)}
    return worst


def _assert_within(worst: dict, tol: float) -> None:
    for name, err in worst.items():
        assert err["kernel"] <= tol and err["kernel_vs_plain"] <= err["plain"] + tol, (
            name, worst, tol)


def _plain_chain(ps, ws, freqs, grad):
    """(E, d_ps, d_xi) of the CPU's exact chain, run on the card: the float32
    product of ps and ``quantile_coefficients``, summed, and autograd."""
    ps = ps.detach().clone().requires_grad_()
    xi = freqs.detach().clone().requires_grad_()
    e = torch.sum((ps if ps.dim() == 3 else ps[None])
                  * quantile_coefficients(ws, xi[None, :, None]), dim=-1)
    e.backward(grad)
    return e.detach(), ps.grad, xi.grad


def _pergenome_exact(g, c, n, seed, card, real):
    ps, ws, _, _, freqs = pergenome_inputs(g, c, n, 1, seed, card, real=real)
    grad = torch.randn(g, c, generator=torch.Generator().manual_seed(seed)).to(card)
    return ps, ws, freqs, grad


def _pergenome_exact_errors(ps, ws, freqs, grad) -> dict:
    """``_exact_errors`` of both per-genome entry points on (ps, ws, freqs)
    and the cotangent grad; checks the launch count, the shapes and that an
    all-padding last item (G > 1) reads zero."""
    g, c = grad.shape
    n = ps.shape[1]
    before = exact_coefficients.launches
    e, tile_sums = exact_coefficients(ps, ws, freqs)
    d_ps, d_xi = exact_coefficients_grad(ps, ws, freqs, tile_sums, grad)
    torch.cuda.synchronize()
    assert exact_coefficients.launches == before + 2
    assert e.shape == (g, c) and d_ps.shape == ps.shape and d_xi.shape == (c,)
    v3 = (g, c, n)
    want = (exact_coefficients_reference(ps.double().view(v3), ws.double().view(v3),
                                         freqs.double()),
            *exact_coefficients_grad_reference(ps.double().view(v3), ws.double().view(v3),
                                               freqs.double(), grad.double()))
    plain = _plain_chain(ps.view(v3), ws.view(v3), freqs, grad)
    if g > 1:  # the all-padding item
        assert torch.equal(e[-1], torch.zeros_like(e[-1]))
        assert torch.equal(d_ps[-c:], torch.zeros_like(d_ps[-c:]))
    return _exact_errors((e, d_ps.view(v3), d_xi), want, plain, g - 1 if g > 1 else g)


@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("n", [1, PERGENOME_TILE - 1, PERGENOME_TILE, PERGENOME_TILE + 1,
                               100_003])
def test_exact_rows_kernels_equal_float64_and_the_plain_chain(card, n, g):
    """E, d_ps and d_xi of the per-genome route within ``plane_tolerance`` of
    float64 and within the plain chain's own error of it; a fifth of each
    item's points padding (one run, sorted together), at G = 3 a heavy item
    and an all-padding item, whose E and d_ps are exactly zero."""
    _assert_within(_pergenome_exact_errors(*_pergenome_exact(g, 32, n, 3 * n + g, card,
                                                             n - n // 5)), plane_tolerance(32))


def test_exact_rows_kernels_at_the_cell(card):
    """At ``fsw_k10.train_exact``'s chunk: 16 items x 32 slices of 646,000
    positions, 503,934 real, the last chunk's frequencies 480..511. The
    error of E, d_ps and d_xi against float64 is under a tenth of the plain
    chain's (its float32 scan over 646,000 weights reads 8e-3 in E on an
    H100, the kernels' compensated prefix 7e-5 to 1e-4: cbar rounded to
    float32, times pi xi up to 511 pi, and the cancellation in E's sum)."""
    ps, ws, _, grad = _pergenome_exact(16, 32, 646_000, 3200000004, card, 503_934)
    freqs = torch.arange(480, 512, dtype=torch.float32, device=card)
    worst = _pergenome_exact_errors(ps, ws, freqs, grad)
    for name, err in worst.items():
        assert err["kernel"] <= err["plain"] / 10, (name, worst)


SHARED_EXACT_CASES = [(7, 512, 16, None), (3, 16, 6, None), (8, 64, 5, None),
                      (7, 32, 3, 16 * EXACT_SHARED_TILE + 1), (5, 32, 2, None),
                      (9, 64, 16, None)]


@pytest.mark.parametrize("k,c,n,vocab", SHARED_EXACT_CASES)
def test_exact_shared_kernels_equal_float64_and_the_plain_chain(card, k, c, n, vocab):
    """E, d_ps (summed over the items) and d_xi of the shared route at the
    training cell (16 items, 512 slices, V = 8,192: weights staged), k = 3, k
    = 8 and V = 8,193, one position past the staging (weights from device
    memory), one real item, and k = 9's vocabulary (V = 131,072, 16 items:
    ``fsw_k9.train_exact``'s unstaged path, 64 slices so that the plain
    chain's buffers fit); absent k-mers, and the last item all zero: its E
    exactly zero. Within ``plane_tolerance`` of float64 and within the plain chain's
    own error of it."""
    ps, perm, wn, freqs, _ = refresh_inputs(k, c, n, 500 * k + c, card, vocab)
    grad = torch.randn(n, c, generator=torch.Generator().manual_seed(c)).to(card)
    before = exact_coefficients.launches
    e = exact_coefficients_shared(ps, perm, wn, freqs)
    d_ps, d_xi = exact_coefficients_shared_grad(ps, perm, wn, freqs, grad)
    torch.cuda.synchronize()
    assert exact_coefficients.launches == before + 2
    assert e.shape == (n, c) and d_ps.shape == ps.shape and d_xi.shape == (c,)
    wsb64 = wn.double()[:, perm.long()]
    want = (exact_coefficients_reference(ps.double(), wsb64, freqs.double()),
            *exact_coefficients_grad_reference(ps.double(), wsb64, freqs.double(),
                                               grad.double()))
    del wsb64
    plain = _plain_chain(ps, wn[:, perm.long()], freqs, grad)
    worst = _exact_errors((e, d_ps, d_xi), want, plain, n - 1)
    _assert_within(worst, plane_tolerance(c))
    assert torch.equal(e[-1], torch.zeros_like(e[-1]))


def test_exact_shared_tile_is_the_hosts(card):
    assert exact_shared_tile() == EXACT_SHARED_TILE
    assert exact_shared_scratch_bytes(16, 512, 8192) == 0  # staged on an H100
    assert exact_shared_scratch_bytes(16, 512, 32_896) == 8 * 16 * 512 * 65


@pytest.mark.parametrize("shared", [False, True])
def test_exact_kernels_are_deterministic(card, shared):
    """No float atomics: two launches of each entry point give the same bits."""
    if shared:
        ps, perm, wn, freqs, _ = refresh_inputs(7, 128, 9, 21, card)
        grad = torch.randn(9, 128, device=card)
        runs = [(exact_coefficients_shared(ps, perm, wn, freqs),
                 *exact_coefficients_shared_grad(ps, perm, wn, freqs, grad)) for _ in range(2)]
    else:
        ps, ws, freqs, grad = _pergenome_exact(2, 64, 100_003, 5, card, 90_000)
        runs = []
        for _ in range(2):
            e, tile_sums = exact_coefficients(ps, ws, freqs)
            runs.append((e, tile_sums, *exact_coefficients_grad(ps, ws, freqs, tile_sums, grad)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _grown(fn) -> int:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def test_exact_kernels_memory_is_their_outputs_and_tile_partials(card):
    """Each launch allocates its outputs and its tile partials
    (``exact_rows_scratch_bytes``, ``exact_shared_scratch_bytes``): nothing
    of size (B*C, N) but the backward's d_ps, no (B, C, V) gather."""
    g, c, n = 4, 64, 200_000
    ps, ws, freqs, grad = _pergenome_exact(g, c, n, 9, card, None)
    rows = g * c
    slack = 5 * 512  # the allocator's rounding of each block
    assert _grown(lambda: exact_coefficients(ps, ws, freqs)) <= (
        exact_rows_scratch_bytes(rows, n) + 4 * rows + slack)
    _, tile_sums = exact_coefficients(ps, ws, freqs)
    grown = _grown(lambda: exact_coefficients_grad(ps, ws, freqs, tile_sums, grad))
    assert grown <= 4 * rows * n + 4 * rows * pergenome_tiles(n) + 4 * c + slack
    assert grown < 2 * 4 * rows * n
    b, c, v = 16, 512, 8192
    ps, perm, wn, freqs, _ = refresh_inputs(7, c, b, 10, card)
    grad = torch.randn(b, c, device=card)
    scratch = exact_shared_scratch_bytes(b, c, v)
    assert _grown(lambda: exact_coefficients_shared(ps, perm, wn, freqs)) <= (
        scratch + 4 * b * c + slack)
    assert _grown(lambda: exact_coefficients_shared_grad(ps, perm, wn, freqs, grad)) <= (
        scratch + 4 * c * v + 4 * c + slack)


@pytest.mark.parametrize("shared,chunk", [(False, 0), (False, 8), (True, 0), (True, 8)])
def test_exact_training_step_counts_its_launches(card, shared, chunk):
    """A step of the exact route under autograd launches the coefficients once
    forward and once backward a chunk, and once more a chunk for the
    recompute where the slices are chunked (``fsw_k10.train_exact``: 16
    chunks, 48; ``fsw_k7.train_exact``: 2); each launch under the span
    ``fsw.exact.coefficients``; inference once a chunk and no span. Both
    devices count the step's coefficients alike: B x C x N forward, twice
    where chunked, and once backward. The
    card's step equals the CPU's plain chain to the FSW forward's cuda-vs-cpu
    tolerance."""
    from kf2vecfsw_tpu_torch.utils import phases

    k, c = (5, 32) if shared else (10, 32)
    gen = torch.Generator().manual_seed(31)
    model = init_fsw_dist_embed_(FSWDistEmbed(k, 2, c, 16, 8), gen)
    if shared:
        x = torch.rand(6, fsw_model.canonical_vocab_size(k), generator=gen)
        x[x < 0.2] = 0.0
    else:
        x = torch.zeros(6, 3000, k + 1)
        x[..., :k] = torch.randint(0, 4, (6, 3000, k), generator=gen).float()
        x[:, :2500, -1] = torch.rand(6, 2500, generator=gen)
    cot = torch.randn(6, 8, generator=gen)
    grads = {}
    for dev in ("cpu", card):
        m = FSWDistEmbed(k, 2, c, 16, 8)
        m.load_state_dict(model.state_dict())
        m = m.to(dev)
        before = exact_coefficients.launches
        with phases.collect() as stats:
            out = m(x.to(dev), chunk)
            out.backward(cot.to(dev))
        chunks = c // chunk if chunk else 1
        n = x.shape[0] * c * x.shape[1]  # B x C x V shared, B x C x N per genome
        assert stats[fsw_model.COEFFICIENTS_FORWARD] == (2 if chunk else 1) * n
        assert stats[fsw_model.COEFFICIENTS_BACKWARD] == n
        if dev == "cpu":
            assert exact_coefficients.launches == before
            assert "fsw.exact.coefficients" not in stats
        else:
            assert exact_coefficients.launches == before + (3 if chunk else 2) * chunks
            assert "fsw.exact.coefficients" in stats
            before = exact_coefficients.launches
            with phases.collect() as quiet, torch.no_grad():
                m(x.to(dev), chunk)
            assert exact_coefficients.launches == before + chunks
            assert "fsw.exact.coefficients" not in quiet
        grads[str(dev)] = (out.detach().cpu(), {n: p.grad.cpu() for n, p in m.named_parameters()})
    (out_cpu, g_cpu), (out_gpu, g_gpu) = grads["cpu"], grads[str(card)]
    np.testing.assert_allclose(out_gpu.numpy(), out_cpu.numpy(), rtol=1e-3, atol=1e-4)
    for name, g in g_cpu.items():
        assert rel_err(g_gpu[name], g) < 1e-3, name
