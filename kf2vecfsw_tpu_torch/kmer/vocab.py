"""Canonical k-mer vocabulary (the port's copy of the JAX package's
``kmer/vocab.py``).

The reference ships sorted canonical k-mer lists as data files
(kf2vec/data/test_kmers_{6,7}_sorted, vocab_generator_k{3,4,5,8,9}C_fin.fa;
selected at main.py:281-296) that define the `.kf` feature-column order.

We *generate* the identical vocabulary instead of shipping files: with the
base encoding A=0, C=1, G=2, T=3 the lexicographic order of k-mer strings
equals the numeric order of their base-4 codes, so the sorted canonical
vocabulary is exactly ``sorted({min(c, revcomp(c)) for c in range(4**k)})``.
This also repairs the reference's missing-k=10 defect (main.py:295-296
references a vocab file that does not exist): any k in [2, 15] works here.

Vocabulary sizes: 4^k/2 for odd k, 4^k/2 + 4^(k/2)/2 for even k
(palindromic k-mers are their own reverse complement).
"""

from __future__ import annotations

import functools

import numpy as np

# Maximum k for dense 4^k histograms / vocab enumeration (4^15 = 1.07e9 is
# already impractical as a dense feature vector; larger k uses sparse paths).
MAX_DENSE_K = 13

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)  # letter of each base code


def revcomp_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of base-4 k-mer codes (vectorized).

    complement(b) = 3 - b under A=0,C=1,G=2,T=3; the reversed digit order
    turns digit i (value (code >> 2i) & 3) into output digit k-1-i.
    """
    codes = np.asarray(codes, dtype=np.int64)
    rc = np.zeros_like(codes)
    for i in range(k):
        digit = (codes >> (2 * i)) & 3
        rc |= (3 - digit) << (2 * (k - 1 - i))
    return rc


@functools.lru_cache(maxsize=None)
def canonical_vocab_codes(k: int) -> np.ndarray:
    """Sorted int64 codes of all canonical k-mers (code <= revcomp(code)).

    Defines the `.kf` column order; bit-identical to the reference's shipped
    vocab files (verified in tests against kf2vec/data/*).
    """
    if not (1 <= k <= MAX_DENSE_K):
        raise ValueError(f"dense canonical vocab supports 1 <= k <= {MAX_DENSE_K}, got {k}")
    codes = np.arange(4**k, dtype=np.int64)
    rc = revcomp_codes(codes, k)
    return codes[codes <= rc]


def canonical_vocab_size(k: int) -> int:
    n = 4**k // 2
    if k % 2 == 0:
        n += 4 ** (k // 2) // 2
    return n


def codes_to_strings(codes: np.ndarray, k: int) -> list[str]:
    """Decode base-4 codes into k-mer strings (A=0,C=1,G=2,T=3)."""
    codes = np.asarray(codes, dtype=np.int64)
    out = np.empty((len(codes), k), dtype=np.uint8)
    for i in range(k):
        out[:, k - 1 - i] = BASES[(codes >> (2 * i)) & 3]
    return [row.tobytes().decode() for row in out]


def codes_to_digit_matrix(codes: np.ndarray, k: int, base_map: np.ndarray) -> np.ndarray:
    """Decode codes into an (N, k) integer matrix under an arbitrary base map.

    ``base_map[b]`` gives the output integer for internal base ``b``
    (A=0,C=1,G=2,T=3). The reference's FSW `.npy` files use A=0,T=1,C=2,G=3
    (main.py:118), i.e. ``base_map = [0, 2, 3, 1]``.
    """
    codes = np.asarray(codes, dtype=np.int64)
    out = np.empty((len(codes), k), dtype=np.int64)
    for i in range(k):
        out[:, k - 1 - i] = base_map[(codes >> (2 * i)) & 3]
    return out


# Reference FSW base map: internal A,C,G,T(0..3) -> reference's A=0,T=1,C=2,G=3.
FSW_BASE_MAP = np.array([0, 2, 3, 1], dtype=np.int64)


def low_complexity_mask(k: int) -> np.ndarray:
    """Boolean mask over the canonical vocab: True = keep (>2 distinct bases).

    Reimplements the reference's hidden ``-mask`` feature
    (train_classifier_model.py:154-180: drop k-mers whose string has <= 2
    distinct characters).
    """
    codes = canonical_vocab_codes(k)
    distinct = np.zeros((len(codes), 4), dtype=bool)
    for i in range(k):
        digit = (codes >> (2 * i)) & 3
        distinct[np.arange(len(codes)), digit] = True
    return distinct.sum(axis=1) > 2
