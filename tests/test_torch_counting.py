"""The port's k-mer histogram (plain version, as run on CPU tensors) against
the JAX package's Pallas kernels B1 (``_hist_kernel_batch``) and B2
(``_hist_kernel``) in interpret mode and against the numpy ground truth.
Counts are integers: every comparison is exact."""

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.io.fasta import encode_bases as jax_encode_bases
from kf2vecfsw_tpu.kernels import histogram as H
from kf2vecfsw_tpu.kmer.counter import KmerCounter as JaxKmerCounter
from kf2vecfsw_tpu.kmer.counter import concat_with_separators as jax_concat
from kf2vecfsw_tpu.kmer.counter import count_canonical_numpy
from kf2vecfsw_tpu_torch.io.fasta import INVALID, encode_bases
from kf2vecfsw_tpu_torch.kernels.histogram import kmer_hist, kmer_hist_reference
from kf2vecfsw_tpu_torch.kmer.counter import KmerCounter, concat_with_separators

torch.set_num_threads(1)


def _random_bytes(rng, n, alphabet=b"ACGTN", p=(0.2475, 0.2525, 0.25, 0.24, 0.01)):
    return bytes(rng.choice(np.frombuffer(alphabet, np.uint8), size=n, p=p).astype(np.uint8))


def _genomes(rng):
    """Genomes as lists of raw records: N, lowercase, multi-record, empty and
    shorter-than-k cases."""
    return [
        [_random_bytes(rng, 30_000)],
        [_random_bytes(rng, 40_000, b"acgtnACGT", (0.12,) * 4 + (0.02,) + (0.125,) * 4)],
        [_random_bytes(rng, 20_000), _random_bytes(rng, 17), _random_bytes(rng, 13_001)],
        [],
        [b"ACG"],
        [_random_bytes(rng, 59_999, b"ACGT", (0.25,) * 4)],
    ]


def _encoded(genomes, k, concat, encode):
    return [concat([encode(r) for r in recs], k) for recs in genomes]


def _batch(codes_list):
    offsets = np.zeros(len(codes_list) + 1, dtype=np.int64)
    np.cumsum([c.size for c in codes_list], out=offsets[1:])
    bases = np.concatenate(codes_list) if codes_list else np.zeros(0, np.uint8)
    return torch.from_numpy(bases), torch.from_numpy(offsets)


@pytest.mark.parametrize("k", [5, 7])
def test_plain_version_equals_pallas_b1_b2_and_numpy(k):
    genomes = _genomes(np.random.default_rng(k))
    port_codes = _encoded(genomes, k, concat_with_separators, encode_bases)
    jax_codes = _encoded(genomes, k, jax_concat, jax_encode_bases)
    for a, b in zip(port_codes, jax_codes):
        np.testing.assert_array_equal(a, b)
    bases, offsets = _batch(port_codes)
    got = kmer_hist_reference(bases, offsets, k)
    assert got.dtype == torch.int32 and got.shape == (len(genomes), 4**k)
    got = got.numpy().astype(np.int64)
    np.testing.assert_array_equal(kmer_hist(bases, offsets, k).numpy(), got)

    # B1: one batched dispatch of every genome (int8 one-hots, interpret mode)
    _, packed, inv = H._pack_genome_batch(jax_codes)
    b1 = np.asarray(H._count_batch_jit(packed, inv, k, True, True))[: len(genomes), : 4**k]
    np.testing.assert_array_equal(got, b1.astype(np.int64))
    for row, codes in zip(got, jax_codes):
        np.testing.assert_array_equal(row, count_canonical_numpy(codes, k))
        if codes.size:  # B2: the single-genome kernel
            p, ib, _ = H.pack_2bit(H._pad_to_quantum(codes))
            b2 = np.asarray(H._count_jit_pallas(p, ib, k, True)).reshape(-1)[: 4**k]
            np.testing.assert_array_equal(row, b2.astype(np.int64))


@pytest.mark.parametrize("k", [2, 3, 9])
def test_plain_version_equals_numpy(k):
    genomes = _genomes(np.random.default_rng(100 + k))
    codes = _encoded(genomes, k, concat_with_separators, encode_bases)
    bases, offsets = _batch(codes)
    got = kmer_hist(bases, offsets, k).numpy()
    for row, c in zip(got, codes):
        np.testing.assert_array_equal(row.astype(np.int64), count_canonical_numpy(c, k))


def test_windows_never_straddle_genomes():
    # "ACGT" + "ACGT" laid end to end: the 4 windows across the join must not count
    bases, offsets = _batch([encode_bases(b"ACGT"), encode_bases(b"ACGT")])
    got = kmer_hist(bases, offsets, 4).numpy()
    assert got.sum() == 2 and (got.sum(axis=1) == 1).all()


def test_empty_batch_and_all_short():
    bases, offsets = _batch([])
    assert kmer_hist(bases, offsets, 5).shape == (0, 4**5)
    bases, offsets = _batch([encode_bases(b"AC"), np.zeros(0, np.uint8)])
    assert kmer_hist(bases, offsets, 3).sum() == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    bases, offsets = _batch([encode_bases(b"ACGTACGT")])
    with pytest.raises(ValueError, match="k <="):
        kmer_hist(bases, offsets, 14)
    with pytest.raises(ValueError, match="k <="):
        kmer_hist(bases, offsets, 1)
    with pytest.raises(ValueError, match="uint8"):
        kmer_hist(bases.to(torch.int32), offsets, 5)
    with pytest.raises(ValueError, match="int64"):
        kmer_hist(bases, offsets.to(torch.int32), 5)


def test_kmer_counter_splits_batches_at_the_int32_limit(monkeypatch):
    from kf2vecfsw_tpu_torch.kmer import counter as counter_mod

    rng = np.random.default_rng(5)
    seqs_batch = [[encode_bases(_random_bytes(rng, n))] for n in (60, 30, 0, 50, 99, 7)]
    counter = KmerCounter(3, device="cpu")
    whole = counter.count_batch(seqs_batch)
    calls = []
    real = counter_mod.kmer_hist
    monkeypatch.setattr(counter_mod, "kmer_hist", lambda b, o, k: calls.append(o.numel() - 1) or real(b, o, k))
    monkeypatch.setattr(counter_mod, "MAX_BASES", 100)
    monkeypatch.setattr(counter_mod, "PIECE_BASES", 99)
    np.testing.assert_array_equal(counter.count_batch(seqs_batch), whole)
    assert calls == [3, 1, 1, 1]  # 60+30+0 | 50 | 99 | 7: each join would reach 100
    assert counter.count_batch([]).shape == (0, whole.shape[1])
    # a genome of MAX_BASES bases no longer raises: it is counted in pieces
    calls.clear()
    long_batch = [[encode_bases(b"ACGT")], [encode_bases(_random_bytes(rng, 100))]]
    got = counter.count_batch(long_batch)
    assert calls == [1, 1, 1]  # ACGT | the first piece, 99 bases | the last, 3 bases
    monkeypatch.setattr(counter_mod, "MAX_BASES", 1 << 31)
    monkeypatch.setattr(counter_mod, "PIECE_BASES", (1 << 31) - 1)
    np.testing.assert_array_equal(got, counter.count_batch(long_batch))


@pytest.mark.parametrize("k", [5, 7])
def test_kmer_counter_cpu_equals_jax_feature_vector(k):
    genomes = _genomes(np.random.default_rng(200 + k))
    seqs_batch = [[encode_bases(r) for r in recs] for recs in genomes]
    counts = KmerCounter(k, device="cpu").count_batch(seqs_batch)
    jax_counter = JaxKmerCounter(k, backend="numpy")
    assert counts.shape == (len(genomes), jax_counter.vocab.size)
    for recs, row in zip(genomes, counts):
        ref = jax_counter.feature_vector([jax_encode_bases(r) for r in recs])
        np.testing.assert_array_equal(row.astype(np.float64), ref)


def _long_genome(rng, n, seams, k):
    """Two records (n and 301 bases, 1% N) with a run of N across every
    other seam of the pieces: windows that touch it must stay uncounted on
    both sides of the seam."""
    codes = encode_bases(_random_bytes(rng, n))
    for i, s in enumerate(seams):
        if i % 2:
            codes[max(s - 2, 0) : s + 1] = INVALID
    return concat_with_separators([codes, encode_bases(_random_bytes(rng, 301))], k)


@pytest.mark.parametrize("k", [3, 7])
def test_kmer_counter_counts_a_genome_beyond_its_piece_length(monkeypatch, k):
    """A genome of 3-4 pieces, with the piece length lowered by monkeypatch
    from 2^31 - 1 bases: over k consecutive piece lengths the seams fall at
    every offset mod k. count_batch and sparse_batch equal the numpy ground
    truth exactly, with short genomes before and after the long one."""
    from kf2vecfsw_tpu_torch.kmer import counter as counter_mod

    rng = np.random.default_rng(300 + k)
    counter = KmerCounter(k, device="cpu")
    for piece in range(2_000, 2_000 + k):
        step = piece - k + 1
        seams = [j * step for j in range(1, 4)]
        genome = _long_genome(rng, 3 * step + piece // 4, seams, k)
        assert 3 * step < genome.size - k + 1 <= 4 * step  # 4 pieces: the last one partial
        batch = [[encode_bases(b"ACGTTGCA")], [genome], [], [encode_bases(_random_bytes(rng, 900))]]
        want = [count_canonical_numpy(concat_with_separators(seqs, k), k) for seqs in batch]
        monkeypatch.setattr(counter_mod, "PIECE_BASES", piece)
        pieces = counter_mod.genome_pieces(genome, k, piece)
        assert len(pieces) == 4 and sum(p.size for p in pieces) == genome.size + 3 * (k - 1)
        got = counter.count_batch(batch)
        np.testing.assert_array_equal(got, np.stack(want)[:, counter.vocab])
        for (codes, counts), row in zip(counter.sparse_batch(batch), want):
            nz = np.nonzero(row)[0]
            np.testing.assert_array_equal(codes, nz)
            np.testing.assert_array_equal(counts, row[nz])
