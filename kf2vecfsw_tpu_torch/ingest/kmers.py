"""get_kmers: genome -> (N, k+1) float32 k-mer matrix for the FSW model.

Reference behavior (main.py:112-184), as in the JAX package's
``ingest/kmers.py``: per sequence file, list the present canonical k-mers
(ATCG-only) in ascending canonical code, encode their bases with A=0, T=1,
C=2, G=3, append the normalized frequency as column k+1 and save
{name}_k{k}.npy (float32). A genome without any valid k-mer is skipped with
a warning.

Files are read by ``read_batches`` (the reader pool of get_frequencies) and
counted MAX_INFLIGHT genomes per ``kmer_hist`` launch. Normalisation stays
in numpy float64, so the `.npy` bytes equal the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np

from ..device import DEFAULT_DEVICE
from ..io.fasta import list_sequence_files, sample_name
from ..kmer.counter import KmerCounter
from ..kmer.vocab import FSW_BASE_MAP, canonical_vocab_codes, codes_to_digit_matrix
from ..utils.cancel import CancelFlag, writing
from .frequencies import read_batches


def kmer_matrix(codes: np.ndarray, counts: np.ndarray, k: int) -> np.ndarray | None:
    """(distinct canonical codes, counts) -> (N, k+1) float32 rows of
    reference-coded digits and frequency; None when no k-mer was counted."""
    if codes.size == 0:
        return None
    digits = codes_to_digit_matrix(codes, k, FSW_BASE_MAP).astype(np.float32)
    freqs = (counts / counts.sum()).astype(np.float32)
    return np.column_stack((digits, freqs))


def point_sets_to_vocab_weights(mats: list[np.ndarray], k: int) -> np.ndarray:
    """(N_i, k+1) point-set matrices -> (n, V) weights over the canonical
    vocab at k: each row's reference-coded digits decode back to its
    canonical code, and its frequency lands in that code's column (absent
    k-mers stay 0; duplicate rows of one k-mer sum, one atom of their joint
    mass). Exact for the FSW embedding, whose zero-weight points are
    no-ops; it feeds the shared-vocab path. Raises ValueError on digits
    outside 0..3 or non-canonical codes (hand-made inputs: get_kmers never
    writes them), where the trainer keeps the per-genome path."""
    vocab = canonical_vocab_codes(k)
    inv = np.zeros(4, dtype=np.int64)
    inv[FSW_BASE_MAP] = np.arange(4)  # reference digit -> internal base
    w = np.zeros((len(mats), len(vocab)), dtype=np.float32)
    for i, m in enumerate(mats):
        digits = m[:, :k].astype(np.int64)
        if digits.size and (digits.min() < 0 or digits.max() > 3):
            raise ValueError("point-set rows contain out-of-range base digits")
        codes = np.zeros(len(m), dtype=np.int64)
        for j in range(k):
            codes = (codes << 2) | inv[digits[:, j]]
        idx = np.searchsorted(vocab, codes)
        if idx.size and not np.array_equal(vocab[np.minimum(idx, len(vocab) - 1)], codes):
            raise ValueError("point-set rows contain non-canonical k-mer codes")
        np.add.at(w[i], idx, m[:, k])
    return w


def get_kmers(input_dir: str, output_dir: str, k: int = 7, threads: int | None = None,
              device: str = DEFAULT_DEVICE, cancel: CancelFlag | None = None) -> list[str]:
    """Write output_dir/{sample}_k{k}.npy for every sequence file of
    input_dir; returns the written paths. ``cancel``: the serve daemon's
    flag, which guards every file write."""
    counter = KmerCounter(k, device=device)
    os.makedirs(output_dir, exist_ok=True)
    written: list[str] = []
    for batch in read_batches(input_dir, list_sequence_files(input_dir), threads):
        for (fname, _), (codes, counts) in zip(batch, counter.sparse_batch([s for _, s in batch])):
            base_name = sample_name(fname)
            print(f"--- Processing {base_name} ---")
            matrix = kmer_matrix(codes, counts, k)
            if matrix is None:
                print(f"Warning: No valid ATCG k-mers found in {base_name}")
                continue
            out_path = os.path.join(output_dir, f"{base_name}_k{k}.npy")
            with writing(cancel, out_path):
                np.save(out_path, matrix)
            print(f"Saved: {out_path} (Shape: {matrix.shape})")
            written.append(out_path)
    return written
