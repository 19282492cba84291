"""get_chunks: genome -> per-10 kb-window raw-count `.kf` rows (the port's
copy of the JAX package's ``ingest/chunks.py``; reference: main.py:654-929).

One in-memory pass per genome, in the reference's order:

1. squeeze runs of [Nn|] to a single N (the awk pre-pass, main.py:740-742),
2. remove gap characters '-', '.' and spaces (seqkit seq -g, main.py:753),
3. drop contigs shorter than the window (seqkit -m, main.py:753),
4. tile each contig with windows by the exact-tiling overlap formula
   (main.py:813-818): T = ceil(L/W), overlap = ceil((T*W - L)/(T-1)),
   step = W - overlap; a window is named {contig}_sliding__{start}-{end}
   (1-based inclusive, main.py:895-896),
5. count the raw canonical k-mers of each window (main.py:869-881),
6. write the rows in genomic order to {sample}.kf; a genome with fewer than
   ``min_chunks`` windows is dropped (main.py:845-860).

Rows are named {sample}.part_{contig}.part_{window_id} and hold float64
counts (+0.5 with ``pseudocount``), so the `.kf` bytes equal the JAX
package's. The JAX package counts a window with a host bincount over its
contig's window codes; the port counts every window through
``KmerCounter``, so on the card with ``kmer_hist``: a genome's windows are
laid end to end as the genomes of one batch. Each window's bases are copied,
and since windows overlap by less than a window the copy holds at most
twice the genome's bases. ``windows_per_launch`` bounds a launch's windows.

Reader threads (``-p``) parse, clean and encode genomes ahead of the main
thread, which counts them and formats their text in submission order, as
the JAX package's main thread formats while its threads read.
"""

from __future__ import annotations

import math
import os
import re
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import defaults
from ..device import DEFAULT_DEVICE
from ..io.fasta import encode_bases, list_sequence_files, read_sequences_raw, sample_name
from ..io.kf import append_kf
from ..kmer.counter import KmerCounter
from ..kmer.vocab import canonical_vocab_codes, canonical_vocab_size
from ..utils.logging import close_logger, make_run_logger
from ..utils.membudget import hbm_fraction
from ..utils.timing import hms

_N_RUN = re.compile(rb"[N|n]+")

# the share of the device memory that one launch's windows may take
LAUNCH_MEMORY_SHARE = (1, 16)


def clean_contig(seq: bytes) -> bytes:
    """awk N-squeeze then gap removal, in the reference's order."""
    seq = _N_RUN.sub(b"N", seq)
    return seq.replace(b"-", b"").replace(b".", b"").replace(b" ", b"")


def window_spans(length: int, window: int) -> list[tuple[int, int]]:
    """0-based [start, end) spans for seqkit-sliding-with-computed-overlap
    (main.py:813-825). Returns [] if length < window."""
    if length < window:
        return []
    total = math.ceil(length / window)
    if total != 1:
        overlap = int(math.ceil((total * window - length) / (total - 1)))
    else:
        overlap = 0
    step = window - overlap
    spans = []
    start = 0
    while start + window <= length:
        spans.append((start, start + window))
        start += step
    return spans


def windows_per_launch(k: int, window: int, device) -> int:
    """Windows counted per ``kmer_hist`` launch: each takes the kernel's
    int32 row of 4^k bins (64 KiB at k=7, but 256 MiB at k=13) and its
    vocab fold, plus 48 bytes a base for the plain version's int64
    transients, and a launch's windows take at most LAUNCH_MEMORY_SHARE of
    the device memory; at least one."""
    per_window = 4 * (4**k + canonical_vocab_size(k)) + 48 * window
    return max(1, hbm_fraction(*LAUNCH_MEMORY_SHARE, device) // per_window)


def count_windows(counter: KmerCounter, windows: list[np.ndarray], window: int) -> np.ndarray:
    """int64 (len(windows), V) vocab-ordered counts, each window a genome of
    one record, ``windows_per_launch`` of them per ``count_batch``."""
    per = windows_per_launch(counter.k, window, counter.device)
    parts = [counter.count_batch([[w] for w in windows[i : i + per]])
             for i in range(0, len(windows), per)]
    if not parts:
        return np.zeros((0, counter.vocab.size), dtype=np.int64)
    return np.concatenate(parts)


def genome_windows(sample: str, records: list[tuple[str, bytes]],
                   window: int = defaults.CHUNK_SZ) -> tuple[list[str], list[np.ndarray]]:
    """Row names and encoded bases of every window of one genome, in genomic
    order; none if no contig reaches the window size."""
    names: list[str] = []
    windows: list[np.ndarray] = []
    for contig_name, raw_seq in records:
        seq = clean_contig(raw_seq)
        if len(seq) < window:
            continue
        codes = encode_bases(seq)
        for start, end in window_spans(len(seq), window):
            names.append(f"{sample}.part_{contig_name}.part_{contig_name}_sliding__{start + 1}-{end}")
            windows.append(codes[start:end])
    return names, windows


def chunk_rows(names: list[str], counts: np.ndarray,
               pseudocount: bool = False) -> list[tuple[str, np.ndarray]]:
    """(row name, float64 count vector) rows, +0.5 with ``pseudocount``."""
    rows = []
    for name, row in zip(names, counts):
        vec = row.astype(np.float64)
        if pseudocount:
            vec = vec + 0.5
        rows.append((name, vec))
    return rows


def chunk_rows_for_genome(
    sample: str,
    records: list[tuple[str, bytes]],
    counter: KmerCounter,
    window: int = defaults.CHUNK_SZ,
    pseudocount: bool = False,
) -> list[tuple[str, np.ndarray]]:
    """All (row_name, raw count vector) chunk rows for one genome, in genomic
    order, counted at ``counter``'s k on its device. Empty list if no contig
    reaches the window size."""
    names, windows = genome_windows(sample, records, window)
    return chunk_rows(names, count_windows(counter, windows, window), pseudocount)


def get_chunks(
    input_dir: str,
    output_dir: str,
    k: int = defaults.DEFAULT_K_LEN,
    threads: int | None = None,
    pseudocount: bool = False,
    window: int = defaults.CHUNK_SZ,
    min_chunks: int = defaults.CHUNK_CNT_THR,
    device: str = DEFAULT_DEVICE,
) -> list[str]:
    since = time.time()
    for d in (input_dir, output_dir):
        if not os.path.exists(d):
            raise SystemExit(f"No such directory '{d}'")
    canonical_vocab_codes(k)  # k > 13 raises here, as in the JAX package
    counter = KmerCounter(k, device=device)
    log = make_run_logger(
        output_dir, f"get_chunks_{os.path.basename(os.path.normpath(input_dir))}.log"
    )

    def stamp(msg: str) -> None:
        hrs, mins, secs = hms(time.time() - since)
        log.info(f"{msg} Time: {hrs:02d}:{mins:02d}:{secs:02d}\n")

    def prepare(fname: str):
        sample = sample_name(fname)
        return sample, genome_windows(sample, read_sequences_raw(os.path.join(input_dir, fname)),
                                      window)

    written: list[str] = []
    threads = threads or min(8, os.cpu_count() or 1)
    try:
        stamp("\n==> Making a list of sample names.")
        files = list_sequence_files(input_dir)
        stamp("\n==> Start processing samples.")
        with ThreadPoolExecutor(max_workers=threads) as pool:
            pending = deque()
            it = iter(files)
            for fname in it:
                pending.append((fname, pool.submit(prepare, fname)))
                if len(pending) >= threads + 2:
                    break
            while pending:
                fname, future = pending.popleft()
                sample, (names, windows) = future.result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append((nxt, pool.submit(prepare, nxt)))
                log.info(f"\n==> Start processing. Sample: {fname}")
                if len(names) == 0:
                    stamp(f"\n==> Excluded {fname}. No contigs above threshold length.")
                    continue
                if len(names) < min_chunks:
                    stamp(
                        f"\n==> Excluded {fname}. {len(names)} chunks is too low. "
                        f"{min_chunks} is required."
                    )
                    continue
                rows = chunk_rows(names, count_windows(counter, windows, window), pseudocount)
                out_path = os.path.join(output_dir, f"{sample}.kf")
                with open(out_path, "w") as f:
                    for name, vec in rows:
                        append_kf(f, name, vec)
                written.append(out_path)
                stamp(f"\n==> Done chunk processing for {fname}.")
        stamp("\n==> Done getting chunks.")
    finally:
        close_logger(log)
    return written
