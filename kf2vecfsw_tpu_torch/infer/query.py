"""Query -> backbone placement distance matrices (reference: query.py:53-200).

For each predicted subtree: take that subtree's distance model and backbone
embeddings from the device-resident cache (``infer/cache.py``), embed the
queries in blocks, and write the squared+clamped query-to-backbone distances
to apples_input_di_mtrx_subtree_{c}.csv and the raw embeddings to
embedding_subtree_{c}.emb, in the JAX package's formats.

The model is chosen per subtree from the checkpoint's model_name, as in the
JAX package: a dense model (NeuralNet) reads the queries' `.kf` vectors
(gathered from the cached device matrix when there is one), an FSW model
(NeuralNetFSW) their {name}_k{k}.npy point sets from get_kmers.

The pipeline is the JAX package's: a thread loads block z+1 while the device
runs block z; each block's embeddings and distances come back as one fused
result, copied without blocking into pinned host memory behind a CUDA event,
and are written PIPE_DEPTH dispatches later, across subtrees. Two faults of
the JAX version are not carried over: the embedding width is taken from the
``fc2`` weights, not from checkpoint meta, and on any error every pending
block whose result is ready is written, in order, before the files are
closed and the error is raised again, so an error in a later subtree never
truncates the files of an earlier one.
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np
import torch

from .. import defaults
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.native.lib import load as load_textio
from ..kmer.vocab import canonical_vocab_size
from ..ops.pairwise import cdist_exact_blocked, squared_clamped
from ..train.checkpoint import fsw_k_from_meta
from ..train.distance import _strip_npy_suffix, f32_row, pad_point_sets
from ..train.step import bucket_items
from ..utils import phases
from ..utils.cancel import CancelFlag, writing
from ..utils.logging import close_logger, make_run_logger
from ..utils.prefetch import prefetch_iter
from ..utils.timing import hms
from .cache import cached_checkpoint, cached_embeddings, cached_query_matrix, read_kf_files_cached
from .classify import host_result, read_classes_out, to_device, to_host_async

# a padded FSW query block above this many bytes pads to geometric buckets
# instead of the vocab size (the JAX package's limit)
NPY_BLOCK_BYTES = 2 << 30
# dispatched blocks in flight before the oldest is written
PIPE_DEPTH = 4


def read_remap(path: str | None, log) -> dict[str, str] | None:
    if not path:
        return None
    try:
        remap: dict[str, str] = {}
        with open(path) as f:
            header = f.readline().rstrip("\n").split("\t")
            i_l = header.index("label")
            i_n = header.index("new_label")
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) > max(i_l, i_n):
                    remap[parts[i_l]] = parts[i_n]
        log.info(f"Remap loaded: {len(remap)} entries")
        return remap
    except (OSError, ValueError) as e:  # reference warns and proceeds (query.py:102-104)
        log.warning(f"Could not read remap file {path}: {e}")
        return None


def read_embeddings_csv(path: str) -> tuple[list[str], np.ndarray]:
    """Backbone embeddings (``name\\tv1\\t...`` rows) -> (names, float32
    (rows, E)), parsed as one table (float64, then rounded, as numpy rounds
    a string to float32). Text with a ',' or ' ', which the table parser
    reads as a separator where the JAX package's tab split does not, and
    text the parser refuses, take that split."""
    with open(path, "rb") as fb:
        data = fb.read()
    if b"," not in data and b" " not in data:
        res = load_textio().parse_table(data)
        if res is not None and res[0]:
            return res[0], res[1].astype(np.float32)
    return read_embeddings_csv_plain(path)


def read_embeddings_csv_plain(path: str) -> tuple[list[str], np.ndarray]:
    """``read_embeddings_csv`` in pure Python (the JAX package's parser)."""
    names: list[str] = []
    rows: list[np.ndarray] = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            names.append(parts[0])
            rows.append(np.array(parts[1:], dtype=np.float32))
    return names, np.vstack(rows)


def fused_forward(model: torch.nn.Module, x: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(rows, E + anchors): a block's embeddings and their squared, clamped
    distances to the anchors, fused so that one copy fetches both."""
    emb = model(x)
    return torch.cat([emb, squared_clamped(cdist_exact_blocked(emb, anchors))], dim=1)


def query_func(
    features_folder: str,
    feature_files: list[str],
    model_dir: str,
    classes_dir: str,
    seed: int,
    output_dir: str,
    remap_path: str | None = None,
    block_size: int = defaults.DEFAULT_BLOCK_SZ,
    device: str = DEFAULT_DEVICE,
    cancel: CancelFlag | None = None,
) -> list[str]:
    dev = resolve_device(device)
    since = time.time()
    log = make_run_logger(output_dir, "query_run.log", cancel)
    try:
        log.info("\n==> Input arguments...\n")
        log.info(f"Query directory: {features_folder}")
        log.info(f"Model directory: {model_dir}")
        log.info(f"Class information: {classes_dir}")
        log.info(f"Seed: {seed}")
        log.info(f"Device: {dev}")

        log.info("\n==> Querying...\n")
        assignments = read_classes_out(os.path.join(classes_dir, "classes.out"))
        # removesuffix, NOT split('.kf'): a genome named 'x.kf2' would
        # otherwise truncate to 'x' and be silently dropped from querying
        names = [os.path.basename(p) for p in feature_files]
        present = {n.removesuffix(".kf") for n in names if n.endswith(".kf")}
        present |= {_strip_npy_suffix(n) for n in names if n.endswith(".npy")}
        assignments = [(g, c) for g, c in assignments if g in present]
        clades = sorted({c for _, c in assignments})
        log.info(f"Total subtrees to query: {len(clades)}")

        remap = read_remap(remap_path, log)
        written: list[str] = []
        qmat = cached_query_matrix(feature_files, dev)
        open_files: dict[int, tuple] = {}  # c -> (f_dist, f_emb)
        # (c, labels, fused result on its way to the host, e_dim, last block of c?)
        pending: deque = deque()

        def _write_out(pend):
            c, labels, fused_pending, e_dim, is_last = pend
            f_dist, f_emb = open_files[c]
            with phases.phase("fetch"):
                fused = host_result(fused_pending)
            with phases.phase("format"):
                d_text = "".join(lbl + "\t" + f32_row(r) for lbl, r in zip(labels, fused[:, e_dim:]))
                e_text = "".join(lbl + "\t" + f32_row(r) for lbl, r in zip(labels, fused[:, :e_dim]))
            with writing(cancel, f_dist.name):
                f_dist.write(d_text)
                f_emb.write(e_text)
                f_dist.flush()
                f_emb.flush()
            if is_last:
                f_dist.close()
                f_emb.close()
                del open_files[c]
                log.info(f"Wrote distance matrix: {f_dist.name}")
                log.info(f"Wrote embeddings: {f_emb.name}")
                log.info(f"\n==> Computation is completed for subtree {c}!\n")
                hrs, m, s = hms(time.time() - since)
                log.info(f"Time: {hrs:02d}:{m:02d}:{s:02d}")

        try:
            with torch.no_grad():
                for c in clades:
                    contig_ids = [g for g, cl in assignments if cl == c]
                    log.info(f"\n==> Working on subtree {c} ({len(contig_ids)} contigs)...\n")
                    with phases.phase("model_load"):
                        model_name, meta, model = cached_checkpoint(
                            os.path.join(model_dir, f"model_subtree_{c}.ckpt"), dev
                        )
                        emb_names, anchors = cached_embeddings(
                            os.path.join(model_dir, f"embeddings_subtree_{c}.csv"), dev
                        )
                    if model_name == "NeuralNetFSW":
                        load = _npy_block_loader(features_folder, fsw_k_from_meta(meta))
                    elif qmat is not None:
                        load = _kf_gather_loader(qmat)
                    else:
                        load = _kf_block_loader(features_folder)
                    e_dim = model.fc2.out_features

                    dist_path = os.path.join(output_dir, f"apples_input_di_mtrx_subtree_{c}.csv")
                    emb_path = os.path.join(output_dir, f"embedding_subtree_{c}.emb")
                    with writing(cancel, dist_path):
                        f_dist = open(dist_path, "w")
                        open_files[c] = (f_dist, open(emb_path, "w"))
                        f_dist.write("\t" + "\t".join(emb_names) + "\n")
                        f_dist.flush()
                    written += [dist_path, emb_path]

                    def _blocks(ids=contig_ids, load=load):
                        for z in range(0, len(ids), block_size):
                            with phases.phase("parse"):
                                blk = load(ids[z : z + block_size])
                            yield blk

                    n_blocks = -(-len(contig_ids) // block_size)
                    for i, (names, x) in enumerate(prefetch_iter(_blocks())):
                        x = to_device(x, dev)
                        if model_name != "NeuralNetFSW" and x.shape[1] != model.fc1.in_features:
                            raise ValueError(f"feature width {x.shape[1]} != subtree {c} model "
                                             f"input {model.fc1.in_features}")
                        with phases.phase("dispatch"):
                            fused_pending = to_host_async(fused_forward(model, x, anchors))
                        phases.count("dispatches")
                        labels = [remap.get(n, n) for n in names] if remap else names
                        pending.append((c, labels, fused_pending, e_dim, i == n_blocks - 1))
                        if len(pending) > PIPE_DEPTH:
                            _write_out(pending.popleft())
            while pending:
                _write_out(pending.popleft())
        except BaseException:
            # write what was computed before the error, in order: a later
            # subtree's error must not truncate an earlier subtree's files;
            # the first block that cannot be written (a device fault, a
            # cancelled request) ends the drain
            while pending:
                try:
                    _write_out(pending.popleft())
                except Exception:
                    break
            raise
        finally:
            for f_dist, f_emb in open_files.values():
                f_dist.close()
                f_emb.close()
            open_files.clear()

        log.info("\n==> Computation Completed!\n")
        hrs, m, s = hms(time.time() - since)
        log.info(f"Total time: {hrs:02d}:{m:02d}:{s:02d}")
        return written
    finally:
        close_logger(log)


def _kf_gather_loader(qmat):
    """Block loader over the device-resident query matrix: this block's rows
    are gathered on the device by an index vector, so no feature bytes
    cross to the card per block."""
    all_names, spans, mat = qmat

    def load(ids: list[str]) -> tuple[list[str], torch.Tensor]:
        idx: list[int] = []
        names: list[str] = []
        for g in ids:
            span = spans.get(g)
            if span is None:
                raise FileNotFoundError(f"{g}.kf was not in the cached query feature set")
            start, stop = span
            idx.extend(range(start, stop))
            names.extend(all_names[start:stop])
        return names, mat[torch.tensor(idx, dtype=torch.int64).to(mat.device)]

    return load


def _kf_block_loader(folder: str):
    def load(ids: list[str]) -> tuple[list[str], np.ndarray]:
        # the host parse cache: classify parsed these same files this pass
        names, mat = read_kf_files_cached([os.path.join(folder, f"{g}.kf") for g in ids])
        return names, mat * np.float32(defaults.FEATURES_SCALER)

    return load


def _npy_block_loader(folder: str, k: int):
    """Block loader of FSW point sets: (ids, (B, N, k+1) float32),
    zero-weight padded. At k <= 9 the length is pinned to the vocab size V
    (a point set never exceeds it), unless the padded block would pass
    NPY_BLOCK_BYTES; then, and at larger k, it pads to a geometric bucket."""
    n_fixed = canonical_vocab_size(k) if 1 <= k <= 9 else None

    def load(ids: list[str]) -> tuple[list[str], np.ndarray]:
        mats = []
        for g in ids:
            p = os.path.join(folder, f"{g}_k{k}.npy")
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"FSW distance model needs k-mer point sets, but {p} is missing. "
                    f"Run `kf2vec get_kmers -input_dir {folder} -output_dir {folder} -k {k}` "
                    f"on the query genomes first (process_query_data does this "
                    f"automatically when the library is FSW)."
                )
            m = np.load(p).astype(np.float32)
            # an out-of-range digit would index past the lookup table on the card
            if m.ndim != 2 or m.shape[1] != k + 1 or (
                    m.size and not 0 <= m[:, :k].min() <= m[:, :k].max() < 4):
                raise ValueError(f"{p} is not a k={k} point set: (N, {k + 1}) rows of "
                                 "base digits 0-3 and a weight")
            mats.append(m)
        nf = n_fixed
        if nf is not None and bucket_items(len(ids)) * nf * (k + 1) * 4 > NPY_BLOCK_BYTES:
            nf = None
        return ids, pad_point_sets(mats, n_fixed=nf)

    return load
