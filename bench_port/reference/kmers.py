"""The canonical k-mer vocabulary, in NumPy.

Bases are coded A=0, C=1, G=2, T=3; a k-mer's canonical code is the
smaller of its code and its reverse complement's, and the vocabulary (the
`.kf` columns) is the canonical codes in ascending order (Jellyfish
``count -C``, kf2vec ``main.py:250-373``). The FSW point sets
(``get_kmers``, ``main.py:112-184``) code a k-mer's bases A=0, T=1, C=2,
G=3.
"""

from __future__ import annotations

import functools

import numpy as np

POINT_DIGIT = np.array([0, 2, 3, 1])  # A, C, G, T -> the point sets' A=0, T=1, C=2, G=3


def revcomp(codes: np.ndarray, k: int) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.int64)
    out = np.zeros_like(codes)
    for i in range(k):
        out |= (3 - ((codes >> (2 * i)) & 3)) << (2 * (k - 1 - i))
    return out


@functools.cache
def canonical_vocab(k: int) -> np.ndarray:
    codes = np.arange(4**k, dtype=np.int64)
    return codes[codes <= revcomp(codes, k)]


def gc_count(codes: np.ndarray, k: int) -> np.ndarray:
    """G and C bases in each k-mer code."""
    digits = (np.asarray(codes, np.int64)[:, None] >> (2 * np.arange(k))) & 3
    return ((digits == 1) | (digits == 2)).sum(axis=1)


def vocab_digits(k: int) -> np.ndarray:
    """(V, k) point-set digits of every canonical k-mer, vocab order."""
    codes = canonical_vocab(k)
    digits = np.empty((codes.size, k), np.int64)
    for i in range(k):
        digits[:, k - 1 - i] = POINT_DIGIT[(codes >> (2 * i)) & 3]
    return digits
