"""The port's FSW memory budgets count what its sort really allocates.

``sort_rows`` allocates its three outputs and, for rows longer than
``CLUSTER_ELEMS``, the radix path's scratch: 32-bit keys and columns per
element, each tile's look-back status and a row's digit counts. The JAX
package sizes its sorts for XLA (four f32 buffers an element), and the port
copied those formulas; these tests hold the repaired budgets:
- ``sort_transient_bytes`` to the bytes ``_launch`` allocates (read from
  the one shared ``launch_buffers``);
- ``auto_slice_chunk`` and ``pick_refresh_group`` past ``CLUSTER_ELEMS`` to
  hand arithmetic on a faked device (``KF2VEC_HBM_BYTES``), and against the
  JAX package's values, which they never exceed;
- the counted stages to the live tensors of the sliced forward and of a
  refresh group (per genome and shared) on the CPU, with the sort replaced
  by one that allocates what the CUDA launch allocates.
The parity tests at N <= 131,072 stay in test_torch_fsw.py and
test_torch_fsw_train.py."""

import contextlib
import types
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

from kf2vecfsw_tpu.models.fsw import _auto_slice_chunk as jax_auto_slice_chunk
from kf2vecfsw_tpu.train import fsw_lazy as jlazy
from kf2vecfsw_tpu_torch.kernels import sort as sort_mod
from kf2vecfsw_tpu_torch.kernels.sort import (
    CLUSTER_ELEMS,
    launch_buffers,
    sort_rows_reference,
    sort_transient_bytes,
)
from kf2vecfsw_tpu_torch.models import fsw
from kf2vecfsw_tpu_torch.train import fsw_lazy as tlazy

GIB = 1 << 30
D_OUT, B, K, BASE_DIM = 512, 16, 10, 4
# bytes of small tensors (a chunk's outputs, g2, a tangent) the counts leave out
SMALL = 4096


class LiveBytes(TorchDispatchMode):
    """The peak bytes of the tensor storages that the ops of a region create
    and keep alive (views share their base's storage), inputs excluded."""

    def __init__(self, *inputs: torch.Tensor):
        super().__init__()
        self.refs: dict[int, list[int]] = {}
        self.live = self.peak = 0
        self.exclude = {t.untyped_storage().data_ptr() for t in inputs}

    def _release(self, key: int) -> None:
        entry = self.refs[key]
        entry[1] -= 1
        if entry[1] == 0:
            del self.refs[key]
            self.live -= entry[0]

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            try:
                key = t.untyped_storage().data_ptr()
            except RuntimeError:  # a functorch wrapper: its parts are counted
                continue
            if key in self.exclude:
                continue
            if key in self.refs:
                self.refs[key][1] += 1
            else:
                self.refs[key] = [t.untyped_storage().nbytes(), 1]
                self.live += self.refs[key][0]
            weakref.finalize(t, self._release, key)
        self.peak = max(self.peak, self.live)
        return out


def _card_like_sort(keys, payload):
    """sort_rows with the CUDA launch's allocations (``launch_buffers``) and
    the plain version's values."""
    r, n = keys.shape
    bufs = {name: torch.empty(shape, dtype=dtype)
            for name, (shape, dtype) in launch_buffers(r, n).items()}
    with _disable_current_modes():
        ref = sort_rows_reference(keys, payload)
    for name, value in zip(("keys", "payload", "perm"), ref):
        bufs[name].copy_(value)
    return bufs["keys"], bufs["payload"], bufs["perm"]


# fsw_k7's shared sort, the tile's last length, a k = 8 query block's rows,
# radix tile seams, the k = 10 vocab and fsw_k10's padded row among them
@pytest.mark.parametrize("r,n,p", [(1, 1, 1), (33, 16_385, 1), (4, 131_072, 4), (3, 131_073, 1),
                                   (2, 262_144, 2), (1, 300_007, 1), (512, 8_192, 1),
                                   (1, 16_384, 1), (16, 32_896, 16), (1, 147_457, 1),
                                   (4, 262_145, 1), (1, 524_800, 1), (1, 646_000, 1),
                                   (1, 1_100_000, 1)])
def test_sort_transient_bytes_is_what_launch_allocates(monkeypatch, r, n, p):
    """``_launch`` allocates ``launch_buffers``, whose bytes are
    ``sort_transient_bytes``, and hands ``sort_rows_launch`` the radix
    path's three scratch buffers past CLUSTER_ELEMS and null scratch up to
    it."""
    seen = {}

    def fake_entry(*args):
        seen["scratch"] = args[5:-4]
        return 0

    monkeypatch.setattr(sort_mod, "_lib",
                        lambda: types.SimpleNamespace(sort_rows_launch=fake_entry))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    keys, payload = torch.zeros(r, n), torch.zeros(p, n)
    with LiveBytes(keys, payload) as live:
        out = sort_mod._launch(keys, payload)
    assert [tuple(t.shape) for t in out] == [(r, n)] * 3
    assert [t.dtype for t in out] == [torch.float32, torch.float32, torch.int32]
    assert [ptr is not None for ptr in seen["scratch"]] == [n > CLUSTER_ELEMS] * 3
    buffers = launch_buffers(r, n)
    assert live.peak == sum(np.prod(s) * d.itemsize for s, d in buffers.values())
    assert live.peak == sort_transient_bytes(r, n, p)


@pytest.mark.parametrize("n", [16_384, 16_385, 131_072, 131_073, 646_000])
def test_radix_launches_count_rows_past_cluster_elems(monkeypatch, n):
    """A launch counts in ``sort_rows.launches``, and in ``radix_launches``
    exactly when its rows are longer than CLUSTER_ELEMS (``long_launches``:
    the cluster path's, from TILE_ELEMS up to CLUSTER_ELEMS)."""
    monkeypatch.setattr(sort_mod, "_lib", lambda: types.SimpleNamespace(
        sort_rows_launch=lambda *args: 0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    counts = sort_mod.sort_rows
    before = counts.launches, counts.long_launches, counts.radix_launches
    sort_mod._launch(torch.zeros(1, n), torch.zeros(1, n))
    radix = n > CLUSTER_ELEMS
    assert (counts.launches, counts.long_launches, counts.radix_launches) == (
        before[0] + 1, before[1] + (sort_mod.TILE_ELEMS < n <= CLUSTER_ELEMS), before[2] + radix)


def test_sort_transient_bytes_by_hand():
    """12 B an element of outputs; past CLUSTER_ELEMS 8 B an element of
    radix scratch (keys and columns) and a row's counts: 4 B for each of 256
    digits of each tile of 8,192 (the look-back status), 4 KiB for each
    histogram block of 16 tiles, 4 KiB of digit starts and 16 B of tile
    counters."""
    assert CLUSTER_ELEMS == 131_072 and sort_mod.TILE_ELEMS == 16_384
    assert sort_mod.RADIX_TILE == 8_192 and sort_mod.RADIX_HIST_TILES == 16
    assert sort_transient_bytes(512, 8192, 1) == 12 * 512 * 8192
    assert sort_transient_bytes(33, 131_072, 33) == 12 * 33 * 131_072
    # 17 tiles of 131,073 in 2 histogram blocks: 86,508,180 + 980,496
    assert sort_mod.radix_counts_words(131_073) == 256 * 17 + 1024 * 2 + 1024 + 4 == 7_428
    assert sort_transient_bytes(33, 131_073, 1) == 20 * 33 * 131_073 + 4 * 33 * 7_428 == 87_488_676
    # one refresh group of 8 genomes at k = 10: 4,096 rows of 524,800, 65
    # tiles in 5 histogram blocks
    assert sort_mod.radix_counts_words(524_800) == 256 * 65 + 1024 * 5 + 1024 + 4 == 22_788
    assert sort_transient_bytes(4096, 524_800, 8) == 20 * 4096 * 524_800 + 4 * 4096 * 22_788
    assert sort_transient_bytes(4096, 524_800, 8) == 43_364_974_592
    # fsw_k10.train_lazy's refresh sort: 512 rows of 646,000, 79 tiles in 5
    # histogram blocks; counts 54,009,856 B (21,037,056 with 40 tiles of
    # 16,384, a count of each digit in each)
    assert sort_mod.radix_counts_words(646_000) == 256 * 79 + 1024 * 5 + 1024 + 4 == 26_372
    assert sort_transient_bytes(512, 646_000, 1) == 20 * 512 * 646_000 + 54_009_856
    for bad in ((0, 8, 1), (8, 0, 1), (8, 8, 3), (8, (1 << 30) + 1, 1)):
        with pytest.raises(ValueError):
            sort_transient_bytes(*bad)


# B = 16 rows a slice: 24 B an element (keys, outputs, radix scratch) plus
# a row's counts: 1 KiB a tile of 8,192, 4 KiB a histogram block of 16
# tiles, 4 KiB and 16 B; the budget is 1/8 of the card: 2 GiB or 10 GiB.
#   N = 131,073 (17 tiles, 2 blocks): 50,332,032 + 475,392 = 50,807,424 B a
#     slice: 2 GiB / that = 42.3 -> 32; 10 GiB / that = 211.3 -> 128
#   N = 262,144 (32 tiles, 2 blocks): 100,663,296 + 721,152 = 101,384,448:
#     21.2 -> 16; 105.9 -> 64
#   N = 524,800 (65 tiles, 5 blocks): 201,523,200 + 1,458,432 = 202,981,632:
#     10.6 -> 8; 52.9 -> 32
@pytest.mark.parametrize("n,hbm_gib,chunk", [
    (131_073, 16, 32), (131_073, 80, 128), (262_144, 16, 16), (262_144, 80, 64),
    (524_800, 16, 8), (524_800, 80, 32)])
def test_auto_slice_chunk_counts_the_merge_scratch(monkeypatch, n, hbm_gib, chunk):
    monkeypatch.setenv("KF2VEC_HBM_BYTES", str(hbm_gib * GIB))
    tiles = -(-n // 8_192)
    per_slice = 24 * B * n + B * (1024 * tiles + 4096 * (-(-tiles // 16) + 1) + 16)
    assert fsw.slice_sort_bytes(B, n) == per_slice
    got = fsw.auto_slice_chunk(B, n, D_OUT, "cpu")
    assert got == chunk
    budget = hbm_gib * GIB // 8
    assert got * per_slice <= budget or got == 8  # 8 is the floor
    assert got == 8 or 2 * got * per_slice > budget  # the largest power of two that fits
    jax_chunk = jax_auto_slice_chunk(B, n, D_OUT)
    assert got <= jax_chunk
    if (n, hbm_gib) == (524_800, 80):
        assert (got, jax_chunk) == (32, 64)


def test_auto_slice_chunk_below_the_merge_path_is_unchanged(monkeypatch):
    """Up to CLUSTER_ELEMS the count is the JAX package's 16 B an element, so
    the chunk is its chunk, at the seam too."""
    for hbm_gib in (1, 16, 80):
        monkeypatch.setenv("KF2VEC_HBM_BYTES", str(hbm_gib * GIB))
        for n in (16_384, 100_000, 131_072):
            assert fsw.slice_sort_bytes(B, n) == 16 * B * n
            assert fsw.auto_slice_chunk(B, n, D_OUT, "cpu") == jax_auto_slice_chunk(B, n, D_OUT)
    assert fsw.auto_slice_chunk(0, 131_073, D_OUT, "cpu") == 0


def _refresh_by_hand(group, n):
    """The per-genome refresh's worst stage at d_out 512 and k = 10: the jvp
    for d delta / d xi, 16 f32 buffers of (G*512, N), beside the group's
    int64 digits (G, N, 10)."""
    return 64 * group * D_OUT * n + 8 * group * n * K


# budget 3/8 of the card: 6 GiB = 6,442,450,944 B or 30 GiB = 32,212,254,720 B
#   N = 131,073: G = 1 takes 4,305,485,904 B: 16 GiB -> 1; 80 GiB -> 4 (8: 34.4e9)
#   N = 262,144: G = 1 takes 8,610,906,112 B: 16 GiB -> 0; 80 GiB -> 2 (4: 34.4e9)
#   N = 524,800: G = 1 takes 17,238,630,400 B: 16 GiB -> 0; 80 GiB -> 1 (2: 34.5e9)
@pytest.mark.parametrize("n,hbm_gib,group", [
    (131_073, 16, 1), (131_073, 80, 4), (262_144, 16, 0), (262_144, 80, 2),
    (524_800, 16, 0), (524_800, 80, 1)])
def test_pick_refresh_group_per_genome(monkeypatch, n, hbm_gib, group):
    monkeypatch.setenv("KF2VEC_HBM_BYTES", str(hbm_gib * GIB))
    points = (K, BASE_DIM)
    for g in (1, 2, 4, 8):
        assert tlazy.refresh_transient_bytes(D_OUT, n, g, points) == _refresh_by_hand(g, n)
        # the sort stage (digits, keys, weight rows, outputs, radix scratch:
        # 20 B an element and a row's counts) stays below the jvp's
        tiles = -(-n // 8_192)
        sort_stage = (8 * g * n * K + 4 * g * D_OUT * n + 4 * g * n + 20 * g * D_OUT * n
                      + g * D_OUT * (1024 * tiles + 4096 * (-(-tiles // 16) + 1) + 16))
        assert sort_stage == (8 * g * n * K + 4 * g * D_OUT * n + 4 * g * n
                              + sort_transient_bytes(g * D_OUT, n, g))
        assert sort_stage < _refresh_by_hand(g, n)
    got = tlazy.pick_refresh_group(D_OUT, n, "cpu", points=points)
    assert got == group
    assert tlazy.lazy_applicable(D_OUT, n, "cpu", points=points) == (group > 0)
    budget = 3 * hbm_gib * GIB // 8
    assert got == 0 or _refresh_by_hand(got, n) <= budget
    assert got == 8 or _refresh_by_hand(max(2 * got, 1), n) > budget
    jax_group = jlazy.pick_refresh_group(D_OUT, n)
    assert got <= jax_group
    if (n, hbm_gib) == (524_800, 80):
        # the worked case: the JAX formula admits G = 8 at 30.1 GB; the
        # group's jvp alone would hold 8 x 17.2 GB
        assert jax_group == 8 and got == 1
        assert jlazy.refresh_transient_bytes(D_OUT, n, 8) == 4 * 28 * D_OUT * n == 30_094_131_200


def _shared_by_hand(vocab, k, group, items, d_out=D_OUT):
    """The shared refresh's jvp stage: the held (n, V) weights,
    (C, V) ps, sort payload and int64 perm (4 buffers of 4 C V), the f32
    (V, 4k) one-hot, the earlier groups' S and g2 rows, and 14 f32 buffers
    of (G, C, V), 16 in a group after the first."""
    cv = 4 * d_out * vocab
    held = 4 * items * vocab + 4 * cv + 16 * k * vocab
    g = min(group, items)
    return held + 4 * (items - g) * d_out * (4 * k + 1) + (16 if items > group else 14) * g * cv


# V = 8,192 (k = 7), 32,896 (k = 8), 131,072 (k = 9); budget 3/8 of the card
# k = 9, one group of 8 (n = 8): 4,194,304 + 1,073,741,824 + 18,874,368 held
#   + 14 x 2,147,483,648 = 31,161,581,568 B, under 30 GiB = 32,212,254,720;
#   n = 64: 33,554,432 + 1,073,741,824 + 18,874,368 + 4 x 56 x 512 x 37
#   (4,243,456) + 16 x 2,147,483,648 = 35,490,152,448: over, so G = 4
#   (18,310,586,368); at 16 GiB (6 GiB budget) G = 1 (5,425,911,808;
#   G = 2 takes 9,720,803,328), where the JAX formula's 4 x 16 x 268,435,456
#   = 4,294,967,296 admits 4
@pytest.mark.parametrize("vocab,k,hbm_gib,items,group,jax_group", [
    (8192, 7, 16, 64, 8, 8), (32_896, 8, 16, 64, 4, 8), (32_896, 8, 80, 64, 8, 8),
    (131_072, 9, 80, 8, 8, 8), (131_072, 9, 80, 64, 4, 8), (131_072, 9, 16, 64, 1, 4)])
def test_shared_refresh_bytes_by_hand(monkeypatch, vocab, k, hbm_gib, items, group, jax_group):
    monkeypatch.setenv("KF2VEC_HBM_BYTES", str(hbm_gib * GIB))
    for g in (1, 2, 4, 8):
        assert tlazy.shared_refresh_bytes(D_OUT, vocab, g, items) == _shared_by_hand(vocab, k, g, items)
        assert tlazy.refresh_transient_bytes(D_OUT, vocab, g, items=items) == _shared_by_hand(
            vocab, k, g, items)
    got = tlazy.pick_refresh_group(D_OUT, vocab, "cpu", items=items)
    assert got == group
    assert jlazy.pick_refresh_group(D_OUT, vocab) == jax_group
    budget = 3 * hbm_gib * GIB // 8
    assert _shared_by_hand(vocab, k, got, items) <= budget
    assert got == 8 or _shared_by_hand(vocab, k, 2 * got, items) > budget
    if vocab == 131_072:
        assert _shared_by_hand(vocab, k, 8, 8) == 31_161_581_568
        assert _shared_by_hand(vocab, k, 8, 64) == 35_490_152_448
    with pytest.raises(ValueError):
        tlazy.refresh_transient_bytes(D_OUT, vocab, 1)


def _point_sets(gen, g, n, k):
    x = torch.zeros(g, n, k + 1)
    x[..., :k] = torch.randint(0, 4, (g, n, k), generator=gen).float()
    x[..., -1] = torch.rand(g, n, generator=gen)
    return x


def _sliced_forward_peak(monkeypatch, b, c, n, chunk):
    monkeypatch.setattr(fsw, "sort_rows", _card_like_sort)
    gen = torch.Generator().manual_seed(n)
    points, w = torch.randn(b, n, K * BASE_DIM, generator=gen), torch.rand(b, n, generator=gen)
    slices, freqs = torch.randn(c, K * BASE_DIM, generator=gen), torch.arange(c).float()
    with torch.no_grad(), LiveBytes(points, w, slices, freqs) as live:
        fsw.fsw_embed(slices, freqs, points, w, chunk)
    return live.peak


@pytest.mark.parametrize("n", [131_073, 262_144, 300_007])
def test_sliced_forward_peaks_at_its_counted_sort(monkeypatch, n):
    """Past CLUSTER_ELEMS the live tensors of a sliced no-grad forward peak
    at the chunk's counted sort (keys, outputs, scratch: at least 24 B an
    element) beside the weight rows, its payload: the cos/sinc stage after
    it holds 20 B an element."""
    b, chunk = 2, 8
    peak = _sliced_forward_peak(monkeypatch, b, 16, n, chunk)
    counted = chunk * fsw.slice_sort_bytes(b, n) + 4 * b * n
    assert counted - SMALL <= peak <= counted + SMALL


def test_sliced_forward_below_the_merge_path(monkeypatch):
    """Up to CLUSTER_ELEMS the count stays the JAX package's 16 B an element
    (its parity), and the cos/sinc stage's 20 B leads: the forward holds
    5/4 of the counted sort, beside the weight rows."""
    b, chunk, n = 2, 8, 1000
    peak = _sliced_forward_peak(monkeypatch, b, 16, n, chunk)
    counted = chunk * fsw.slice_sort_bytes(b, n)
    assert counted == chunk * 16 * b * n
    assert peak <= counted * 5 // 4 + 4 * b * n + SMALL


@pytest.mark.parametrize("g,c,n,k", [(1, 16, 140_000, 10), (2, 32, 1000, 10), (1, 64, 2000, 3),
                                     (3, 8, 700, 5), (1, 4, 5000, 12)])
def test_pergenome_refresh_group_fits_its_count(monkeypatch, g, c, n, k):
    """One group of the per-genome refresh holds no more than
    ``pergenome_refresh_bytes``, and where the jvp stage leads (d_out of 8
    and more at these k) exactly that."""
    monkeypatch.setattr(fsw, "sort_rows", _card_like_sort)
    gen = torch.Generator().manual_seed(g * n + c)
    x = _point_sets(gen, g, n, k)
    slices, freqs = torch.randn(c, k * BASE_DIM, generator=gen), torch.arange(c).float()
    lookup = torch.randn(4, BASE_DIM, generator=gen)
    with LiveBytes(x, slices, freqs, lookup) as live:
        fsw.fsw_lazy_refresh_pergenome(slices, freqs, lookup, x, g)
    counted = tlazy.pergenome_refresh_bytes(c, n, g, k, BASE_DIM)
    assert live.peak <= counted + SMALL
    jvp = 8 * g * n * k + 64 * g * c * n
    if counted == jvp:
        assert live.peak >= counted


@pytest.mark.parametrize("g,c,n,k,groups", [(1, 16, 140_000, 10, 3), (2, 32, 1000, 10, 3),
                                            (1, 64, 2000, 3, 4)])
def test_pergenome_refresh_later_groups_fit_the_count(monkeypatch, g, c, n, k, groups):
    """Every group of the per-genome refresh, not only the first, holds no
    more than ``pergenome_refresh_bytes`` beside the earlier groups' S and
    g2 rows (4 (4k + 1) C B an item): the last group's delta, perm and
    one-hot are gone before the next group's jvp."""
    monkeypatch.setattr(fsw, "sort_rows", _card_like_sort)
    gen = torch.Generator().manual_seed(groups * n + c)
    x = _point_sets(gen, groups * g, n, k)
    slices, freqs = torch.randn(c, k * BASE_DIM, generator=gen), torch.arange(c).float()
    lookup = torch.randn(4, BASE_DIM, generator=gen)
    with LiveBytes(x, slices, freqs, lookup) as live:
        fsw.fsw_lazy_refresh_pergenome(slices, freqs, lookup, x, g)
    counted = tlazy.pergenome_refresh_bytes(c, n, g, k, BASE_DIM)
    earlier = 4 * (4 * k + 1) * c * (groups - 1) * g
    assert counted <= live.peak <= counted + earlier + SMALL


@pytest.mark.parametrize("g,c,n", [(1, 16, 4), (4, 128, 8), (8, 64, 8), (8, 128, 8)])
def test_shared_refresh_live_set(monkeypatch, g, c, n):
    """One shared refresh of n items in groups of g holds no more than
    ``shared_refresh_bytes`` and, where the jvp stage leads (here in every
    case), exactly that: 14 f32 buffers of (G, C, V) in the first group, 16
    in a later one, beside the held weights, ps, perm and one-hot. The JAX
    package's (3G + 4) buffers of (C, V) count a third of it."""
    monkeypatch.setattr(fsw, "sort_rows", _card_like_sort)
    k, v = 7, 8192
    gen = torch.Generator().manual_seed(g * c)
    digits = fsw.vocab_digits(k, torch.device("cpu"))
    slices, freqs = torch.randn(c, k * BASE_DIM, generator=gen), torch.arange(c).float()
    points = fsw.lookup_points(torch.randn(4, BASE_DIM, generator=gen), digits)
    w = torch.rand(n, v, generator=gen)
    with LiveBytes(slices, freqs, points, digits, w) as live:
        fsw.fsw_lazy_refresh(slices, freqs, points, digits, w, g)
    counted = tlazy.shared_refresh_bytes(c, v, g, n)
    assert live.peak <= counted + SMALL
    if counted == _shared_by_hand(v, k, g, n, c):
        assert live.peak >= counted
    assert live.peak >= 2.9 * jlazy.refresh_transient_bytes(c, v, g)
