"""Canonical k-mer counting (the in-repo replacement for Jellyfish).

Semantics of the reference's ``jellyfish count -m k -C`` + ``dump``
(main.py:309-319), as in the JAX package's ``kmer/counter.py``:

- every record of a file is scanned; each length-k window of A/C/G/T only
  (case-insensitive) adds one to its canonical k-mer (the smaller of the
  k-mer and its reverse complement in A<C<G<T order),
- windows holding any other character are skipped,
- counts are reported over the sorted canonical vocabulary, zeros included.

``KmerCounter`` counts a batch of genomes with one ``kmer_hist`` call: the
CUDA kernel for every genome on the card, its plain version on the CPU.
The numpy functions below are the host ground truth the tests hold both to,
and ``count_canonical_sparse`` is also the route for k > MAX_K, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..io.fasta import INVALID
from ..kernels.histogram import MAX_BASES, MAX_K, MIN_K, kmer_hist
from .vocab import MAX_DENSE_K, canonical_vocab_codes

MAX_SPARSE_K = 31  # int64 window codes hold 2k bits
# bases per piece of a long genome: a genome longer than this is counted in
# pieces that overlap by k - 1 bases (read at call time, so a test can lower it)
PIECE_BASES = MAX_BASES - 1


def window_codes_numpy(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Base-4 canonical window codes + validity mask (vectorized numpy).

    Returns (canon, valid) of length L-k+1 (empty if L < k).
    """
    codes = np.asarray(codes)
    n = codes.size - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
    b = codes.astype(np.int64)
    fwd = np.zeros(n, dtype=np.int64)
    rc = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for i in range(k):
        digit = b[i : i + n]
        fwd += digit << (2 * (k - 1 - i))
        rc += (3 - digit) << (2 * i)
        valid &= digit < INVALID
    # invalid digits (=4) corrupt fwd/rc but those windows are masked out
    canon = np.minimum(fwd, rc)
    return canon, valid


def count_canonical_numpy(codes: np.ndarray, k: int) -> np.ndarray:
    """Dense histogram over all 4^k codes; only canonical bins are nonzero."""
    if k > MAX_DENSE_K:
        raise ValueError(f"dense counting supports k <= {MAX_DENSE_K}")
    canon, valid = window_codes_numpy(codes, k)
    return np.bincount(canon[valid], minlength=4**k).astype(np.int64)


def count_canonical_sparse(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(unique canonical codes ascending, counts) — works for any k <= 31."""
    canon, valid = window_codes_numpy(codes, k)
    return np.unique(canon[valid], return_counts=True)


def concat_with_separators(seqs: list[np.ndarray], k: int) -> np.ndarray:
    """Concatenate encoded records with k-1 INVALID separators so windows
    never straddle record boundaries (matches per-record Jellyfish scans)."""
    if not seqs:
        return np.zeros(0, dtype=np.uint8)
    sep = np.full(k - 1, INVALID, dtype=np.uint8)
    parts: list[np.ndarray] = []
    for i, s in enumerate(seqs):
        if i:
            parts.append(sep)
        parts.append(np.asarray(s, dtype=np.uint8))
    return np.concatenate(parts)


def genome_pieces(genome: np.ndarray, k: int, piece: int) -> list[np.ndarray]:
    """``genome`` as views of at most ``piece`` bases that overlap by k - 1:
    piece j starts at j * (piece - k + 1), and the last one ends at the
    genome's end. One piece (the genome) when it is no longer than ``piece``."""
    if genome.size <= piece:
        return [genome]
    if piece < k:
        raise ValueError(f"pieces of {piece} bases cannot hold a window of k={k}")
    step = piece - (k - 1)
    out, start = [], 0
    while True:
        out.append(genome[start : start + piece])
        if start + piece >= genome.size:
            return out
        start += step


class KmerCounter:
    """Counts canonical k-mers of genome batches on one device and folds
    them to the `.kf` column order (the canonical vocabulary).

    Dense counting (``count_batch``) takes MIN_K <= k <= MAX_K; the sparse
    point sets of ``sparse_batch`` take any k up to MAX_SPARSE_K."""

    def __init__(self, k: int, device: str | torch.device = DEFAULT_DEVICE):
        if not MIN_K <= k <= MAX_SPARSE_K:
            raise ValueError(f"k-mer counting supports {MIN_K} <= k <= {MAX_SPARSE_K}, got {k}")
        self.k = k
        self.device = resolve_device(device)
        self.vocab = canonical_vocab_codes(k) if k <= MAX_K else None
        self._vocab_dev = None if self.vocab is None else torch.from_numpy(self.vocab).to(self.device)

    def count_batch(self, seqs_batch: list[list[np.ndarray]]) -> np.ndarray:
        """int64 (G, V) vocab-ordered counts of G genomes, each a list of
        encoded records. One kernel launch and one device->host copy per
        run of consecutive pieces that together hold fewer than MAX_BASES
        bases (one run for any realistic batch).

        A genome longer than PIECE_BASES (a skim of a few Gbp of reads) is
        cut into pieces of PIECE_BASES that overlap by k - 1 bases, the seam
        rule of the JAX package's single-genome kernel B2: each window lies
        whole in exactly one piece, so none is lost or counted twice. Each
        piece is a row of the kernel's int32 output (fewer than 2^31
        windows), and a genome's rows are summed in int64 (after the vocab
        fold, which only selects columns)."""
        if self.vocab is None:
            raise ValueError(f"dense k-mer counting supports {MIN_K} <= k <= {MAX_K}, got {self.k}")
        pieces, first = [], []
        for seqs in seqs_batch:
            first.append(len(pieces))
            pieces += genome_pieces(concat_with_separators(seqs, self.k), self.k, PIECE_BASES)
        parts = [self._count(group) for group in _launch_groups(pieces)]
        if not parts:
            return np.zeros((0, self.vocab.size), dtype=np.int64)
        rows = np.concatenate(parts)
        return rows if len(pieces) == len(first) else np.add.reduceat(rows, first, axis=0)

    def sparse_batch(self, seqs_batch: list[list[np.ndarray]]) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per genome, (distinct canonical codes ascending, int64 counts):
        the point sets of get_kmers (main.py:112-184).

        For k <= MAX_K these are the nonzero columns of ``count_batch``, one
        ``kmer_hist`` launch per batch; the vocabulary is sorted, so the
        codes come out ascending. For k > MAX_K no dense row exists and the
        counts come from ``count_canonical_sparse`` on the host: that is the
        JAX package's own route at such k (its ``KmerCounter.sparse``), not
        a fallback from the card."""
        if self.vocab is None:
            return [count_canonical_sparse(concat_with_separators(seqs, self.k), self.k)
                    for seqs in seqs_batch]
        out = []
        for row in self.count_batch(seqs_batch):
            nz = np.nonzero(row)[0]
            out.append((self.vocab[nz], row[nz]))
        return out

    def dense_histogram(self, codes: np.ndarray) -> torch.Tensor:
        """int64 (4^k,) canonical histogram of one encoded base stream over
        every code (zeros at the non-canonical ones), on the device: the
        JAX package's per-device count in ``count_canonical_sharded``. A
        stream longer than PIECE_BASES is counted in overlapping pieces, as
        in ``count_batch``."""
        if self.vocab is None:
            raise ValueError(f"dense k-mer counting supports {MIN_K} <= k <= {MAX_K}, got {self.k}")
        out = torch.zeros(4**self.k, dtype=torch.int64, device=self.device)
        for group in _launch_groups(genome_pieces(np.asarray(codes, np.uint8), self.k, PIECE_BASES)):
            out += self._hist(group).sum(dim=0, dtype=torch.int64)
        return out

    def _hist(self, genomes: list[np.ndarray]) -> torch.Tensor:
        offsets = np.zeros(len(genomes) + 1, dtype=np.int64)
        np.cumsum([g.size for g in genomes], out=offsets[1:])
        return kmer_hist(
            torch.from_numpy(np.concatenate(genomes)).to(self.device),
            torch.from_numpy(offsets).to(self.device),
            self.k,
        )

    def _count(self, genomes: list[np.ndarray]) -> np.ndarray:
        counts = self._hist(genomes)
        return counts.index_select(1, self._vocab_dev).cpu().numpy().astype(np.int64)


def _launch_groups(pieces: list[np.ndarray]):
    """Runs of consecutive pieces that together hold fewer than MAX_BASES
    bases: one ``kmer_hist`` launch each."""
    start = 0
    while start < len(pieces):
        stop, total = start + 1, pieces[start].size
        while stop < len(pieces) and total + pieces[stop].size < MAX_BASES:
            total += pieces[stop].size
            stop += 1
        yield pieces[start:stop]
        start = stop
