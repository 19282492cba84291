"""Distance-model helpers (the port's copy of what serving needs from the
JAX package's ``train/distance.py``; the trainer arrives with the training
slice)."""

from __future__ import annotations

import numpy as np

from .step import bucket_items


def f32_row(vals, sep: str = "\t") -> str:
    """One str(np.float32)-formatted row ending in '\\n'."""
    return sep.join(str(np.float32(v)) for v in vals) + "\n"


def pad_point_sets(mats: list[np.ndarray], n_fixed: int | None = None) -> np.ndarray:
    """Zero-pad variable-length (N_i, k+1) FSW matrices to (n, Nbucket, k+1);
    padded rows carry weight 0 (pad_collate, train_model_set.py:72-90). The
    length pads to a geometric bucket; n_fixed pins it outright when it
    holds every matrix (query pads to the vocab size at k <= 9)."""
    if n_fixed is not None and n_fixed >= max(m.shape[0] for m in mats):
        n_max = n_fixed
    else:
        n_max = bucket_items(max(m.shape[0] for m in mats), floor=128)
    width = mats[0].shape[1]
    out = np.zeros((len(mats), n_max, width), dtype=np.float32)
    for i, m in enumerate(mats):
        out[i, : m.shape[0]] = m
    return out


def _strip_npy_suffix(basename: str) -> str:
    """{name}_k{k}.npy -> name"""
    stem = basename[: -len(".npy")] if basename.endswith(".npy") else basename
    if "_k" in stem:
        head, _, tail = stem.rpartition("_k")
        if tail.isdigit():
            return head
    return stem
