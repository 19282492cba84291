"""Canonical k-mer counting of one long genome sharded over ranks (the port's
``kf2vecfsw_tpu/parallel/counting.py``).

The genome is cut into R segments that overlap by k - 1 bases, so that every
window lies whole in exactly one segment; each rank counts its segment with
``kmer_hist`` (``kmer/counter.py``: the CUDA kernel on the card, its plain
version on the CPU), and the dense 4^k histograms are summed across the
ranks by one all-reduce in int64. The JAX package packs each segment into 2
bits before it goes to the devices, a remedy for its host-to-TPU link: here
every rank holds the genome already and cuts its own segment, so there is
no packing.
"""

from __future__ import annotations

import numpy as np

from ..kmer.counter import KmerCounter
from .mesh import DataMesh, all_reduce_


def _segment(codes_u8: np.ndarray, n_seg: int, k: int, i: int) -> np.ndarray:
    """Segment ``i`` of ``n_seg``: the bases [i * seg, (i + 1) * seg + k - 1)
    with seg = ceil(L / n_seg), cut at the genome's end (empty past it)."""
    seg = -(-codes_u8.size // n_seg)
    return codes_u8[i * seg : min(codes_u8.size, (i + 1) * seg + k - 1)]


def count_canonical_sharded(codes_u8: np.ndarray, k: int, mesh: DataMesh) -> np.ndarray:
    """int64 (4^k,) canonical histogram of the encoded bases ``codes_u8``
    (``io.fasta.encode_bases``), each rank counting its segment on its
    device; every rank returns the whole histogram."""
    codes = np.asarray(codes_u8, dtype=np.uint8)
    part = KmerCounter(k, mesh.device).dense_histogram(
        _segment(codes, mesh.world_size, k, mesh.rank))
    return all_reduce_(part).cpu().numpy()
