"""Point sets made from the seed, in ``get_kmers``' ``.npy`` layout.

A genome's point set is an (N_i, k+1) float32 matrix: one row per canonical
k-mer present in the genome (count > 0), in ascending canonical code, its
bases coded A=0, T=1, C=2, G=3 in the first k columns and its frequency
(count over the genome's total, taken in float64) last (kf2vecFSW
``main.py:112-184``). The counts come from ``inputs.genome_counts``.

The padded length of a subtree (``train/distance.py`` ``pad_point_sets``:
the fullest genome's N rounded up to a bucket) must not move with the
seed, or the work and the peak of a run would. At k = 10 a genome of 6 Mb
at GC content 0.5 holds nearly all 524,800 canonical k-mers, past the
bucket edge at 516,800; one whose GC content has drifted far along the tree
lacks the k-mers rich in the rarer bases and can fall under it. So the
longest genome takes the root's GC content (0.5) on every seed
(``pinned_gc``), and every seed pads to the same bucket.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.kmers import vocab_digits

ROOT_GC = 0.5  # inputs.random_tree's GC content at the root


def pinned_gc(gc: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The leaves' GC contents, the longest genome's set to ROOT_GC."""
    out = gc.copy()
    out[int(np.argmax(lengths))] = ROOT_GC
    return out


def point_sets(counts: torch.Tensor, k: int) -> list[np.ndarray]:
    """(n, V) canonical k-mer counts (vocab order) -> each genome's (N_i,
    k+1) float32 point set, on the host."""
    digits = torch.from_numpy(vocab_digits(k).astype(np.float32)).to(counts.device)
    freqs = (counts / counts.sum(dim=1, keepdim=True)).float()
    out = []
    for c, f in zip(counts, freqs):
        present = c > 0
        out.append(torch.cat([digits[present], f[present, None]], dim=1).cpu().numpy())
    return out
