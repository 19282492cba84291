"""get_frequencies: genome -> canonical k-mer frequency `.kf` vector.

Replaces the reference's per-file Jellyfish subprocess pipeline
(main.py:250-373): count canonical k-mers over every record of each
FASTA/FASTQ file, optionally add a 0.5 pseudocount, normalize to sum 1
unless raw counts are requested, and write one `.kf` line per file.

A reader thread pool (``read_batches``, shared with get_kmers) parses and
encodes files ahead of the counter, which counts MAX_INFLIGHT genomes per
kernel launch. Normalisation stays in numpy
float64, so the `.kf` bytes equal the JAX package's.
"""

from __future__ import annotations

import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..device import DEFAULT_DEVICE
from ..io.fasta import list_sequence_files, read_sequences, sample_name
from ..io.kf import write_kf
from ..kmer.counter import KmerCounter
from ..utils.cancel import CancelFlag, writing

# genomes per kernel launch (the JAX package's batch of 16 per dispatch)
MAX_INFLIGHT = 16


def _check_dir(path: str) -> None:
    if not os.path.exists(path):
        print(f"No such directory '{path}'", file=sys.stderr)
        raise SystemExit(1)


def _finalize_vec(vec: np.ndarray, pseudocount: bool, raw_cnt: bool, name: str = "") -> np.ndarray:
    if pseudocount:
        vec = vec + 0.5
    if not raw_cnt:
        if vec.sum() == 0:
            # all-N / too-short input: the normalized row will be all-NaN
            # (reference parity: pandas df/df.sum() does the same) — but warn
            # loudly so the poison is traceable to its source
            print(
                f"WARNING: no valid k-mers counted{f' for {name}' if name else ''}; "
                "writing an all-NaN .kf row",
                file=sys.stderr,
            )
        with np.errstate(invalid="ignore", divide="ignore"):
            vec = vec / vec.sum()
    return vec


def read_batches(input_dir: str, files: list[str], threads: int | None = None):
    """Yield the files in order as batches of at most MAX_INFLIGHT
    (file name, encoded records) pairs. A reader thread pool parses ahead
    of the consumer, with at most threads + MAX_INFLIGHT genomes resident."""
    threads = threads or min(8, os.cpu_count() or 1)

    def load(fname: str):
        recs = read_sequences(os.path.join(input_dir, fname))
        return fname, [r.codes for r in recs]

    batch: list = []
    with ThreadPoolExecutor(max_workers=threads) as pool:
        pending = deque()
        it = iter(files)
        for fname in it:
            pending.append(pool.submit(load, fname))
            if len(pending) >= threads + MAX_INFLIGHT:
                break
        while pending:
            loaded = pending.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(pool.submit(load, nxt))
            batch.append(loaded)
            if len(batch) >= MAX_INFLIGHT:
                yield batch
                batch = []
    if batch:
        yield batch


def get_frequencies(
    input_dir: str,
    output_dir: str,
    k: int = 7,
    threads: int | None = None,
    pseudocount: bool = False,
    raw_cnt: bool = False,
    device: str = DEFAULT_DEVICE,
    cancel: CancelFlag | None = None,
) -> list[str]:
    """Process every sequence file in input_dir into output_dir/{sample}.kf.
    ``cancel``: the serve daemon's flag, which guards every file write.

    Returns the list of written paths.
    """
    counter = KmerCounter(k, device=device)
    print(f"\n==> Starting k-mer counting for {input_dir}\n")
    _check_dir(input_dir)
    _check_dir(output_dir)

    written: list[str] = []
    for batch in read_batches(input_dir, list_sequence_files(input_dir), threads):
        counts = counter.count_batch([seqs for _, seqs in batch])
        for (fname, _), row in zip(batch, counts):
            name = sample_name(fname)
            vec = _finalize_vec(row.astype(np.float64), pseudocount, raw_cnt, name=name)
            out_path = os.path.join(output_dir, f"{name}.kf")
            with writing(cancel, out_path):
                write_kf(out_path, [(name, vec)])
            written.append(out_path)

    print(f"\n==> Done processing {input_dir}")
    return written
