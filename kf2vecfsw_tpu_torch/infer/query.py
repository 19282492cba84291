"""Query -> backbone placement distance matrices (reference: query.py:53-200).

For each predicted subtree: load that subtree's distance model and backbone
embeddings onto the device, embed the queries in blocks, and write the
squared+clamped query-to-backbone distances to
apples_input_di_mtrx_subtree_{c}.csv and the raw embeddings to
embedding_subtree_{c}.emb, in the JAX package's formats.

The model is chosen per subtree from the checkpoint's model_name, as in the
JAX package: a dense model (NeuralNet) reads the queries' `.kf` vectors, an
FSW model (NeuralNetFSW) their {name}_k{k}.npy point sets from get_kmers.

Two faults of the JAX version are not carried over: the embedding width is
taken from the ``fc2`` weights, not from checkpoint meta, and every block is
written before the next one is computed, so an error in a later subtree
never truncates the files of an earlier one.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import defaults
from ..device import DEFAULT_DEVICE, resolve_device
from ..kmer.vocab import canonical_vocab_size
from ..models.mlp import params_from_jax
from ..ops.pairwise import cdist_exact_blocked, squared_clamped
from ..train.checkpoint import fsw_k_from_meta, load_checkpoint
from ..train.distance import _strip_npy_suffix, f32_row, pad_point_sets
from ..train.step import bucket_items
from ..utils.logging import close_logger, make_run_logger
from ..utils.timing import hms
from .classify import load_features, read_classes_out

# a padded FSW query block above this many bytes pads to geometric buckets
# instead of the vocab size (the JAX package's limit)
NPY_BLOCK_BYTES = 2 << 30


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
) -> list[str]:
    dev = resolve_device(device)
    since = time.time()
    log = make_run_logger(output_dir, "query_run.log")
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
        for c in clades:
            contig_ids = [g for g, cl in assignments if cl == c]
            log.info(f"\n==> Working on subtree {c} ({len(contig_ids)} contigs)...\n")
            model_name, meta, params = load_checkpoint(
                os.path.join(model_dir, f"model_subtree_{c}.ckpt")
            )
            model = params_from_jax(params).to(dev).eval()
            if model_name == "NeuralNetFSW":
                load = _npy_block_loader(features_folder, fsw_k_from_meta(meta), dev)
            else:
                load = _kf_block_loader(features_folder, params["fc1"]["w"].shape[0], dev)
            emb_names, anchors = read_embeddings_csv(
                os.path.join(model_dir, f"embeddings_subtree_{c}.csv")
            )
            anchors_dev = torch.from_numpy(anchors).to(dev)

            dist_path = os.path.join(output_dir, f"apples_input_di_mtrx_subtree_{c}.csv")
            emb_path = os.path.join(output_dir, f"embedding_subtree_{c}.emb")
            written += [dist_path, emb_path]
            with open(dist_path, "w") as f_dist, open(emb_path, "w") as f_emb, torch.no_grad():
                f_dist.write("\t" + "\t".join(emb_names) + "\n")
                for z in range(0, len(contig_ids), block_size):
                    names, x = load(contig_ids[z : z + block_size])
                    emb = model(x)
                    dist = squared_clamped(cdist_exact_blocked(emb, anchors_dev))
                    emb, dist = emb.cpu().numpy(), dist.cpu().numpy()
                    labels = [remap.get(n, n) for n in names] if remap else names
                    for lbl, drow in zip(labels, dist):
                        f_dist.write(lbl + "\t" + f32_row(drow))
                    for lbl, erow in zip(labels, emb):
                        f_emb.write(lbl + "\t" + f32_row(erow))
            log.info(f"Wrote distance matrix: {dist_path}")
            log.info(f"Wrote embeddings: {emb_path}")
            log.info(f"\n==> Computation is completed for subtree {c}!\n")
            hrs, m, s = hms(time.time() - since)
            log.info(f"Time: {hrs:02d}:{m:02d}:{s:02d}")

        log.info("\n==> Computation Completed!\n")
        hrs, m, s = hms(time.time() - since)
        log.info(f"Total time: {hrs:02d}:{m:02d}:{s:02d}")
        return written
    finally:
        close_logger(log)


def _kf_block_loader(folder: str, input_size: int, dev: torch.device):
    def load(ids: list[str]) -> tuple[list[str], torch.Tensor]:
        return load_features([os.path.join(folder, f"{g}.kf") for g in ids], None, input_size, dev)

    return load


def _npy_block_loader(folder: str, k: int, dev: torch.device):
    """Block loader of FSW point sets: (ids, (B, N, k+1) device tensor),
    zero-weight padded. At k <= 9 the length is pinned to the vocab size V
    (a point set never exceeds it), unless the padded block would pass
    NPY_BLOCK_BYTES; then, and at larger k, it pads to a geometric bucket."""
    n_fixed = canonical_vocab_size(k) if 1 <= k <= 9 else None

    def load(ids: list[str]) -> tuple[list[str], torch.Tensor]:
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
        return ids, torch.from_numpy(pad_point_sets(mats, n_fixed=nf)).to(dev)

    return load
