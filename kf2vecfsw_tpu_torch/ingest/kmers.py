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
from ..kmer.vocab import FSW_BASE_MAP, codes_to_digit_matrix
from .frequencies import read_batches


def kmer_matrix(codes: np.ndarray, counts: np.ndarray, k: int) -> np.ndarray | None:
    """(distinct canonical codes, counts) -> (N, k+1) float32 rows of
    reference-coded digits and frequency; None when no k-mer was counted."""
    if codes.size == 0:
        return None
    digits = codes_to_digit_matrix(codes, k, FSW_BASE_MAP).astype(np.float32)
    freqs = (counts / counts.sum()).astype(np.float32)
    return np.column_stack((digits, freqs))


def get_kmers(input_dir: str, output_dir: str, k: int = 7, threads: int | None = None,
              device: str = DEFAULT_DEVICE) -> list[str]:
    """Write output_dir/{sample}_k{k}.npy for every sequence file of
    input_dir; returns the written paths."""
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
            np.save(out_path, matrix)
            print(f"Saved: {out_path} (Shape: {matrix.shape})")
            written.append(out_path)
    return written
