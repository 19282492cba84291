"""Chunk trainers (the port's ``train/chunks.py``; reference:
train_model_set_chunks.py, train_classifier_model_chunks.py).

Each genome's features are a (c_i, V) matrix of raw per-10 kb-window k-mer
counts (from get_chunks). Per epoch and per genome the trainer draws random
contiguous window spans, of length floor(Exp(c/5)) + 1, redrawn uniform on
[1, c] when over c, at a uniform start (datasets.py:44-62), sums them,
normalises the sum, and trains on that "partial genome". The distance
trainer draws two spans per genome (Siamese pairs) and repeats the labels
(train_model_set_chunks.py:396-397) under ``chunks_weighted_sqrt_mse``; the
classifier draws one span per genome under the NLL.

Two stores hold the rows:
- ``ChunkStore``: the matrices on the host, uint16 (uint8 clamped at 255
  with ``-cap``), with the ``-mask`` columns dropped;
- ``DeviceChunkStore``: int32 prefix sums (G, Cmax+1, V) of those matrices
  on the device, so a span sum is two gathered rows and a subtraction. It
  is used when it fits ``KF2VEC_CHUNK_DEVICE_BUDGET`` bytes, or else 1/4 of
  the device memory; a larger clade keeps the host store, the JAX
  package's own route for a clade too large for device memory (the model
  still trains on the device).

One sample stream feeds both. The host draws an epoch's spans from
``np.random.default_rng((seed, epoch))`` in the order of
``ChunkStore.sample_one``, after the epoch's item order, that generator's
``permutation(n)``, taken first: the JAX package's host path
(``kf2vecfsw_tpu/train/chunks.py:129-143, 812-819``). The span sums
(summed by the host, or gathered on the device) are normalised on the
device as numpy does it: int64 sums, a float64 divide and x 1e4, cast to
float32 last. So both stores, and the JAX package's host path, give the
same batch bit for bit, and a resumed run replays the batches of one that
was not interrupted. The JAX package's device path draws from
``jax.random`` (``:308-333``), which PyTorch cannot reproduce; the port does
not try.

Over ranks (``parallel.mesh.initialize_distributed``, more than one rank)
each rank reads only its contiguous range of the genomes' chunk `.kf`
files (``load_chunk_store_process_sliced``; counts, widths and totals go to
every rank by one all-reduce), and the prefix sums are sharded by genome
over the ranks (``DeviceChunkStore.build_sharded``, the JAX package's
``build_process_sharded``): every rank draws the same host span plan, sums
the spans of the genomes it owns, and the batch is assembled by one
all-reduce, bit for bit the replicated store's (``sample_chunk_batch_sharded``).
When the sharded store does not fit, every rank reads every genome into
the host store. The loss and gradients take ``train/step.py``'s sharded
batch plan, and the coordinator alone writes files. On a grid with a model
axis (``mesh=parallel.mesh.make_mesh(n_data, n_model)``) the chunk trainers
train over its data axis only, every rank holding the whole model, as the
JAX package's chunk runners apply without ``model_axis``
(``kf2vecfsw_tpu/train/chunks.py:688,965``): the genome ranges, the
sharded store and the plan's collectives are those of the rank's data
index and data group.

Not ported: the multi-epoch device spans (``make_chunked_span_runner``,
``split_spans``), a TPU artefact. ``ChunkStore.sample_one_uniform``, the
reference's legacy uniform spans, is ported but no trainer draws from it.

Per-batch losses stay on the device and are fetched once per epoch. The
trainers autosave every ``autosave_every`` epochs and at the last one, in
the JAX package's trainer-state layout, so ``-resume`` works across the
packages.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import defaults
from ..device import DEFAULT_DEVICE, device_line, resolve_device
from ..io.kf import read_kf
from ..kmer.vocab import low_complexity_mask
from ..models.mlp import Classifier, DistEmbed, count_params, init_params_, params_to_jax
from ..ops.losses import chunks_weighted_sqrt_mse, nll_sum
from ..ops.pairwise import pairwise_l2_exact
from ..parallel.mesh import (
    DataMesh,
    all_reduce_,
    barrier,
    check_replicas,
    gather_rows,
    is_coordinator,
    mesh_line,
    process_row_slice,
    trainer_mesh,
)
from ..utils.logging import close_logger, make_run_logger, timestamp
from ..utils.membudget import hbm_fraction
from ..utils.timing import hms
from .checkpoint import save_checkpoint
from .classifier import (
    VOCAB_SIZES_TO_K,
    load_kf_matrix,
    read_clade_map,
    validate_class_labels,
    write_classes_table,
)
from .distance import export_embeddings, load_subtree_dist
from .resume import start_or_resume
from .schedule import step_lr
from .step import data_sum_, gathered_embeddings, local_rows, set_lr, sharded_step

F32 = np.float32
INT32_TOTAL = 2**31  # a genome's total count must stay below this in the int32 store


def _chunk_device_budget(device) -> int:
    """Bytes the device store may take: ``KF2VEC_CHUNK_DEVICE_BUDGET``, or
    else 1/4 of the device memory (the JAX package's ratio)."""
    budget_env = os.environ.get("KF2VEC_CHUNK_DEVICE_BUDGET")
    return int(budget_env) if budget_env else hbm_fraction(1, 4, device)


def _check_fullgenome_width(input_dir_fullgenomes: str, names: list[str], input_size: int) -> None:
    """Fail fast when -input_dir_fullgenomes features were built at a
    different k than the chunk features: the mismatch otherwise surfaces as
    a raw shape error in the final full-genome pass after all epochs ran."""
    missing = [
        g for g in names
        if not os.path.exists(os.path.join(input_dir_fullgenomes, g + ".kf"))
    ]
    if missing:
        raise FileNotFoundError(
            f"-input_dir_fullgenomes is missing {len(missing)} .kf file(s) "
            f"needed for the final full-genome pass (first: {missing[0]}.kf)"
        )
    # width probe on the first file only (existence is the cheap sweep above)
    _, probe = read_kf(os.path.join(input_dir_fullgenomes, names[0] + ".kf"))
    if probe.shape[1] != input_size:
        raise ValueError(
            f"full-genome feature width {probe.shape[1]} != chunk feature width "
            f"{input_size}: -input_dir and -input_dir_fullgenomes must be built "
            f"with the same k"
        )


def draw_spans(rng: np.random.Generator, counts: np.ndarray, genome_indices,
               draws: int) -> np.ndarray:
    """(3, len(genome_indices) * draws) int64 rows of genome, start and
    length: ``draws`` consecutive spans per genome, drawn in the order of
    ``ChunkStore.sample_one`` (the exponential, the redraw only when over c,
    then the start)."""
    out = np.empty((3, len(genome_indices) * draws), dtype=np.int64)
    col = 0
    for gi in genome_indices:
        c = int(counts[gi])
        for _ in range(draws):
            nrows = int(np.floor(rng.exponential(c / 5))) + 1
            if nrows > c:
                nrows = int(rng.integers(1, c + 1))
            ix = int(rng.integers(0, c - nrows + 1))
            out[:, col] = (gi, ix, nrows)
            col += 1
    return out


def epoch_plan(seed: int, epoch: int, counts: np.ndarray, draws: int):
    """(item order, spans) of one epoch: ``permutation(n)`` first, then every
    batch's spans in batch order, from the generator keyed by the absolute
    epoch."""
    erng = np.random.default_rng((seed, epoch))
    perm = erng.permutation(len(counts))
    return perm, draw_spans(erng, counts, perm, draws)


def normalize_spans(sums: torch.Tensor, scaler: float = defaults.FEATURES_SCALER) -> torch.Tensor:
    """(R, V) int64 span sums -> float32 feature rows: each row over its
    total in float64, x ``scaler``, cast last (zeros for an all-zero span),
    which is numpy's arithmetic in the JAX package's host sampler."""
    vec = sums.to(torch.float64)
    total = vec.sum(dim=1, keepdim=True)  # exact: integers below 2^53
    vec = torch.where(total > 0, vec / total.clamp(min=1.0), torch.zeros_like(vec))
    return (vec * scaler).to(torch.float32)


def load_chunk_matrices(kf_paths: list[str], cap: bool = False, threads: int = 8,
                        column_mask: np.ndarray | None = None) -> list[np.ndarray]:
    """The chunk matrices of ``kf_paths``, read in parallel: uint16 by
    default, uint8 with ``cap`` (values clamped to 255, utils.py:408-430).
    ``column_mask`` drops feature columns up front (the hidden -mask
    low-complexity filter, train_classifier_model_chunks.py:171-195)."""
    def load(p):
        _, mat = read_kf(p)
        if column_mask is not None:
            mat = mat[:, column_mask]
        if cap:
            return np.minimum(mat, 255).astype(np.uint8)
        return mat.astype(np.uint16)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(load, kf_paths))


class ChunkStore:
    """Host-resident chunk matrices (``load_chunk_matrices``)."""

    def __init__(self, kf_paths: list[str], cap: bool = False, threads: int = 8,
                 column_mask: np.ndarray | None = None):
        self.matrices = load_chunk_matrices(kf_paths, cap, threads, column_mask)
        self.names = [os.path.basename(p)[: -len(".kf")] for p in kf_paths]
        self.counts = np.array([m.shape[0] for m in self.matrices], dtype=np.int64)

    @property
    def input_size(self) -> int:
        return self.matrices[0].shape[1]

    def span_sums(self, spans: np.ndarray) -> np.ndarray:
        """int64 (R, V) sums of the (genome, start, length) columns of ``spans``."""
        out = np.empty((spans.shape[1], self.input_size), dtype=np.int64)
        for j, (gi, ix, n) in enumerate(spans.T):
            out[j] = self.matrices[gi][ix : ix + n].sum(axis=0, dtype=np.int64)
        return out

    def batch(self, spans: np.ndarray, device) -> torch.Tensor:
        """float32 (R, V) rows of ``spans`` on ``device``."""
        return normalize_spans(torch.from_numpy(self.span_sums(spans)).to(device))

    def sample_batch(self, rng: np.random.Generator, genome_indices, draws: int) -> np.ndarray:
        """(len(indices) * draws, V) float32: ``draws`` spans per genome,
        consecutive rows belong to the same genome."""
        return self.batch(draw_spans(rng, self.counts, genome_indices, draws), "cpu").numpy()

    def sample_one(self, rng: np.random.Generator, gi: int) -> np.ndarray:
        """One normalised random-span vector (datasets.py:44-62)."""
        return self.sample_batch(rng, [gi], 1)[0]

    def sample_one_uniform(self, rng: np.random.Generator, gi: int) -> np.ndarray:
        """One normalised span of the legacy uniform sampling (Dataset_chunks,
        datasets.py:271-325): length ~ U[1, c), start ~ U[0, c - length),
        each range at least one wide."""
        c = int(self.counts[gi])
        nrows = int(rng.integers(1, max(c, 2)))
        ix = int(rng.integers(0, max(c - nrows, 1)))
        return self.batch(np.array([[gi], [ix], [nrows]], dtype=np.int64), "cpu").numpy()[0]


def _prefix_sums(matrices: list[np.ndarray], n_rows: int, cmax: int, width: int,
                 device: torch.device) -> torch.Tensor:
    """(n_rows, cmax + 1, width) int32 prefix sums of ``matrices`` over the
    chunk axis, a genome's total repeated past its end, zero rows after the
    last matrix; raises ``OverflowError`` for a genome whose total count
    reaches 2^31."""
    prefix = torch.zeros((n_rows, cmax + 1, width), dtype=torch.int32, device=device)
    for i, m in enumerate(matrices):
        total = int(m.sum(dtype=np.int64))
        if total >= INT32_TOTAL:
            raise OverflowError(
                f"genome {i}: total chunk count {total} overflows the int32 "
                "device prefix store; use the host ChunkStore path"
            )
        p = torch.from_numpy(m.astype(np.int32)).to(device).cumsum(0, dtype=torch.int32)
        prefix[i, 1 : m.shape[0] + 1] = p
        prefix[i, m.shape[0] + 1 :] = p[-1]
    return prefix


class DeviceChunkStore:
    """Per-genome prefix sums over the chunk axis on the device, one
    (G, Cmax+1, V) int32 tensor: a span sum is ``prefix[g, ix + n] -
    prefix[g, ix]``, exact because every genome's total count is below 2^31
    (``fits``; the constructor raises ``OverflowError`` otherwise). A genome
    shorter than Cmax repeats its total in the rows past its end.

    ``build_sharded`` makes the genome-sharded store of a mesh of ranks: each
    rank holds the prefix sums of its ``g_local`` genomes only, and
    ``batch`` assembles every span row by one all-reduce."""

    def __init__(self, matrices: list[np.ndarray], device, scaler: float = defaults.FEATURES_SCALER):
        self.counts = np.array([m.shape[0] for m in matrices], dtype=np.int64)
        self.device, self.scaler = torch.device(device), float(scaler)
        self.rank, self.g_local = 0, None  # replicated: every genome here
        self.prefix = _prefix_sums(matrices, len(matrices), int(self.counts.max()),
                                   matrices[0].shape[1], self.device)

    @classmethod
    def build_sharded(cls, local_matrices: list[np.ndarray], counts_global: np.ndarray,
                      input_size: int, mesh: DataMesh,
                      scaler: float = defaults.FEATURES_SCALER) -> "DeviceChunkStore":
        """The store of ``mesh``'s rank from the chunk matrices of its genome
        range (``load_chunk_store_process_sliced``); ``counts_global`` are
        the chunk counts of every genome, padded with 1 to a multiple of the
        world size."""
        self = cls.__new__(cls)
        self.counts = np.asarray(counts_global, dtype=np.int64)
        self.device, self.scaler = mesh.device, float(scaler)
        self.rank, self.g_local = mesh.data_rank, self.counts.size // mesh.n_data
        self.group = mesh.data_group
        self.prefix = _prefix_sums(local_matrices, self.g_local, int(self.counts.max()),
                                   input_size, self.device)
        return self

    @staticmethod
    def nbytes(matrices: list[np.ndarray]) -> int:
        cmax = max(m.shape[0] for m in matrices)
        return len(matrices) * (cmax + 1) * matrices[0].shape[1] * 4

    @staticmethod
    def fits(matrices: list[np.ndarray], device) -> bool:
        if DeviceChunkStore.nbytes(matrices) > _chunk_device_budget(device):
            return False
        return all(int(m.sum(dtype=np.int64)) < INT32_TOTAL for m in matrices)

    def batch(self, spans: torch.Tensor) -> torch.Tensor:
        """float32 (R, V) rows of the (3, R) int64 ``spans`` on the device. The
        sharded store normalises the rows of the genomes this rank owns, zero
        elsewhere, and sums the ranks' rows: exact, since each row is
        nonzero on one rank only (x + 0 = x)."""
        g, ix, n = spans
        if self.g_local is None:
            return normalize_spans((self.prefix[g, ix + n] - self.prefix[g, ix]).to(torch.int64),
                                   self.scaler)
        own = g // self.g_local == self.rank
        li = torch.where(own, g - self.rank * self.g_local, 0)
        rows = normalize_spans((self.prefix[li, ix + n] - self.prefix[li, ix]).to(torch.int64),
                               self.scaler)
        return all_reduce_(torch.where(own[:, None], rows, torch.zeros_like(rows)), self.group)

    def sample_batch(self, rng: np.random.Generator, genome_indices, draws: int) -> np.ndarray:
        """``ChunkStore.sample_batch`` from the device store."""
        spans = draw_spans(rng, self.counts, genome_indices, draws)
        return self.batch(torch.from_numpy(spans).to(self.device)).cpu().numpy()


def load_chunk_store_process_sliced(kf_paths: list[str], mesh: DataMesh, cap: bool,
                                    column_mask: np.ndarray | None = None):
    """Chunk ingest over ranks: this rank reads only the chunk `.kf` files of
    its contiguous genome range, [rank * per, (rank + 1) * per) with per =
    ceil(G / R); every genome's chunk count and total count and the feature
    width reach every rank by one all-reduce. Returns (local_matrices,
    counts_global, input_size, totals_global), the counts padded with 1 and
    the totals with 0 to R * per rows, for ``DeviceChunkStore.build_sharded``
    and ``sharded_store_fits``; None when there is no range to split (one
    rank, or no process group). With one rank per device the ranges always
    divide: the JAX package's other None, a process count that does not
    divide its devices, has no counterpart."""
    if not mesh.distributed or mesh.n_data == 1:
        return None
    g_pad = -(-len(kf_paths) // mesh.n_data) * mesh.n_data
    mine = process_row_slice(g_pad, mesh)
    local = load_chunk_matrices(kf_paths[mine], cap, column_mask=column_mask)
    rows = torch.zeros((mine.stop - mine.start, 3), dtype=torch.int64)
    rows[:, 0] = 1
    for i, m in enumerate(local):
        rows[i] = torch.tensor([m.shape[0], int(m.sum(dtype=np.int64)), m.shape[1]])
    table = gather_rows(rows.to(mesh.device), mine.start, g_pad, mesh.data_group).cpu().numpy()
    return local, table[:, 0], int(table[:, 2].max()), table[:, 1]


def sharded_store_fits(counts_global: np.ndarray, input_size: int, mesh: DataMesh,
                       totals_global: np.ndarray | None = None) -> bool:
    """Whether the genome-sharded store fits: its (G_pad, Cmax+1, V) int32
    prefix sums within the device budget times the ranks, and every genome's
    total below 2^31 (the guard of ``DeviceChunkStore.fits``)."""
    nbytes = int(counts_global.shape[0]) * (int(np.max(counts_global)) + 1) * input_size * 4
    if nbytes > _chunk_device_budget(mesh.device) * mesh.n_data:
        return False
    return totals_global is None or bool(np.all(totals_global < INT32_TOTAL))


def batch_source(store: ChunkStore, dstore: DeviceChunkStore | None, spans: np.ndarray,
                 rows_per_batch: int, device):
    """``sample(bi)``: the rows of the epoch's bi-th batch on ``device``, from
    the device store when there is one (the epoch's spans go to the device
    once), else summed on the host."""
    if dstore is not None:
        spans_dev = torch.from_numpy(spans).to(device)
        return lambda bi: dstore.batch(spans_dev[:, bi * rows_per_batch : (bi + 1) * rows_per_batch])
    return lambda bi: store.batch(spans[:, bi * rows_per_batch : (bi + 1) * rows_per_batch], device)


def chunk_distance_epoch(model: torch.nn.Module, opt: torch.optim.Optimizer, sample,
                         dist: torch.Tensor, order: torch.Tensor, batch_size: int,
                         mesh: DataMesh | None = None) -> torch.Tensor:
    """One epoch of the chunk distance trainer: two span rows per item of a
    batch, their labels the item's row of ``dist`` repeated; returns the
    per-batch losses on the device. Over ranks each rank embeds the span
    rows of its items (``step.local_rows``)."""
    model.train()
    losses = []
    for bi, idx in enumerate(torch.split(order, batch_size)):
        x = sample(bi)
        ridx = idx.repeat_interleave(2)
        true_dist = dist.index_select(0, ridx).index_select(1, ridx)
        lo, hi = local_rows(idx.numel(), batch_size, mesh)
        own = model(x[2 * lo : 2 * hi])
        loss = sharded_step(model, opt, lambda: chunks_weighted_sqrt_mse(pairwise_l2_exact(
            gathered_embeddings(own, 2 * lo, x.shape[0], mesh)), true_dist), True, mesh)
        losses.append(loss.detach())
    return torch.stack(losses)


def chunk_classifier_epoch(model: torch.nn.Module, opt: torch.optim.Optimizer, sample,
                           labels: torch.Tensor, order: torch.Tensor, batch_size: int,
                           mesh: DataMesh | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One epoch of the chunk classifier trainer, one span row per item;
    returns the per-batch NLL and correct counts (taken before each step)
    on the device. Over ranks each rank takes its rows of every batch, and
    the per-batch sums are all-reduced once, after the epoch."""
    model.train()
    losses, correct = [], []
    for bi, idx in enumerate(torch.split(order, batch_size)):
        x = sample(bi)
        lo, hi = local_rows(idx.numel(), batch_size, mesh)
        log_probs = model(x[lo:hi])
        y = labels.index_select(0, idx[lo:hi])
        loss = sharded_step(model, opt, lambda: nll_sum(log_probs, y) / idx.numel(), True, mesh)
        losses.append(loss.detach())
        correct.append((log_probs.detach().argmax(dim=1) == y).sum())
    sums = data_sum_(torch.stack([torch.stack(losses).double(), torch.stack(correct).double()]),
                     mesh)
    return sums[0].float(), sums[1].long()


def _store_line(dstore, suffix: str = "") -> str:
    if dstore is not None and dstore.g_local is not None:
        return "Chunk store: device-resident prefix sums, sharded by genome over the ranks" + suffix
    if dstore is not None:
        return "Chunk store: device-resident prefix sums" + suffix
    return "Chunk store: host streaming (prefix array exceeds device budget)"


def _open_stores(paths: list[str], cap: bool, column_mask, mesh: DataMesh, log):
    """(host store or None, device store or None, every genome's chunk
    count, feature width). Over ranks the genome-sharded device store from
    each rank's slice of the files, when it fits; else the host store of
    every file, with its prefix sums on the device when they fit (the host
    store serves the batches otherwise)."""
    sliced = load_chunk_store_process_sliced(paths, mesh, cap, column_mask)
    if sliced is not None:
        local, counts, input_size, totals = sliced
        if sharded_store_fits(counts, input_size, mesh, totals):
            log.info(f"Chunk ingest: per-rank genome slices ({len(paths)} genomes over "
                     f"{mesh.n_data} data ranks)")
            return (None, DeviceChunkStore.build_sharded(local, counts, input_size, mesh),
                    counts[: len(paths)], input_size)
    if mesh.distributed:
        log.info("Chunk ingest: every rank reads every genome"
                 + (" (the sharded store exceeds the device budget)" if sliced else ""))
    store = ChunkStore(paths, cap=cap, column_mask=column_mask)
    fits = DeviceChunkStore.fits(store.matrices, mesh.device)
    return (store, DeviceChunkStore(store.matrices, mesh.device) if fits else None, store.counts,
            store.input_size)


def _batch_sizes(n_items: int, batch_size: int) -> np.ndarray:
    n_full, tail = divmod(n_items, batch_size)
    return np.array([batch_size] * n_full + ([tail] if tail else []))


def _autosave_due(epoch: int, num_epochs: int, autosave_every: int) -> bool:
    return bool(autosave_every) and ((epoch + 1) % autosave_every == 0 or epoch == num_epochs - 1)


# -- chunk distance trainer ------------------------------------------------------


def train_model_set_chunks_func(
    features_folder: str,
    input_dir_fullgenomes: str,
    feature_files: list[str],
    clades_info: str,
    true_dist_dir: str,
    num_epochs: int,
    hidden_size: int,
    embedding_size: int,
    batch_size: int,
    lr0: float,
    lr_min: float,
    lr_decay: float,
    clades_to_train: list[int] | None,
    seed: int,
    cap_data: bool,
    model_filepath: str,
    resume: bool = False,
    autosave_every: int = 500,
    device: str = DEFAULT_DEVICE,
    mesh: DataMesh | None = None,
) -> list[str]:
    from ..ingest.tree_ops import read_subtrees

    dev = resolve_device(device)
    mesh = trainer_mesh(mesh, dev)
    since = time.time()
    clade_tag = (
        "_".join(str(c) for c in clades_to_train) if clades_to_train is not None else "all"
    )
    log = make_run_logger(model_filepath, f"train_model_{timestamp()}_clade_{clade_tag}.log")
    try:
        log.info("\n==> Input arguments...\n")
        log.info(f"Feature directory: {features_folder}")
        log.info(f"Clades information: {clades_info}")
        log.info(f"Ground truth directory: {true_dist_dir}")
        log.info("\n==> Parameters...\n")
        log.info(device_line(dev))
        if mesh.distributed:
            log.info(mesh_line(mesh))
        log.info(f"Hidden Size fc1: {hidden_size}")
        log.info(f"Embedding Size: {embedding_size}")
        log.info(f"Total Epochs: {num_epochs}")
        log.info(f"Batch Size: {batch_size}")
        log.info(f"Cap kmer frequencies: {cap_data}")

        rows = read_subtrees(clades_info)
        clade_order: list[int] = []
        for _, c in rows:
            if c not in clade_order:
                clade_order.append(c)
        if clades_to_train is not None:
            clade_order = list(clades_to_train)
        log.info(f"Number of Classes: {len(clade_order)}")

        avail = {os.path.basename(f)[: -len(".kf")]: f for f in feature_files}
        saved: list[str] = []
        for c in clade_order:
            log.info(f"\n==> Working on subtree {c}...\n")
            clade_genomes = {g for g, cl in rows if cl == c}
            backbone_names = [g for g in avail if g in clade_genomes]
            saved.append(_train_distance_clade(
                log, since, dev, mesh, c, backbone_names, [avail[g] for g in backbone_names],
                input_dir_fullgenomes, true_dist_dir, num_epochs, hidden_size, embedding_size,
                batch_size, lr0, lr_min, lr_decay, seed, cap_data, model_filepath, resume,
                autosave_every))
            log.info(f"\n==> Training for subtree {c} completed!\n")

        log.info("\n==> Training Completed!\n")
        hrs, m, s = hms(time.time() - since)
        log.info(f"Time: {hrs:02d}:{m:02d}:{s:02d}")
    finally:
        close_logger(log)
    barrier(mesh)  # every rank returns once the coordinator's files are written
    return saved


def _train_distance_clade(log, since, dev, mesh, c, backbone_names, clade_paths,
                          input_dir_fullgenomes, true_dist_dir, num_epochs, hidden_size,
                          embedding_size, batch_size, lr0, lr_min, lr_decay, seed, cap_data,
                          model_filepath, resume, autosave_every) -> str:
    store, dstore, counts, input_size = _open_stores(clade_paths, cap_data, None, mesh, log)
    n_items = len(backbone_names)
    log.info(f"Dimensions of feature matrix rows: {n_items}, cols: {input_size}")
    _check_fullgenome_width(input_dir_fullgenomes, backbone_names, input_size)
    dist = load_subtree_dist(true_dist_dir, c, backbone_names).astype(F32)

    gen = torch.Generator().manual_seed(seed)
    model = init_params_(DistEmbed(input_size, hidden_size, embedding_size), gen)
    log.info(f"Total parameters: {count_params(model)}")
    state_path = os.path.join(model_filepath, f"trainer_state_chunks_subtree_{c}.ckpt")
    st = start_or_resume(model, gen, n_items, state_path, resume, log, lr0, dev, mesh)
    log.info(_store_line(dstore, " (sampling fused into the train step)"))
    dist_dev = torch.from_numpy(dist).to(dev)

    n_batches = max(1, math.ceil(n_items / batch_size))
    stop_epochs = int(math.ceil(n_items / batch_size * 2))
    lq: deque = deque([float("nan")] * stop_epochs, maxlen=stop_epochs)
    log.info(f"Stopping epochs: {stop_epochs}")
    consec_lowest, consec_best_epoch = math.inf, -1
    batch_sizes = _batch_sizes(n_items, batch_size)
    for epoch in range(st.start_epoch, num_epochs):
        set_lr(st.opt, step_lr(epoch, lr0, lr_min, lr_decay))
        perm, spans = epoch_plan(seed, epoch, counts, draws=2)
        sample = batch_source(store, dstore, spans, 2 * batch_size, dev)
        losses = chunk_distance_epoch(st.model, st.opt, sample, dist_dev,
                                      torch.from_numpy(perm).to(dev), batch_size, mesh)
        loss_row = losses.cpu().numpy().astype(np.float64)  # the epoch's one fetch
        for bi, lv in enumerate(loss_row):
            if epoch > 5 and lv > 0.2:
                log.info(
                    f"Epoch [{epoch + 1}/{num_epochs}], Step [{bi + 1}/{n_batches}], "
                    f"Outlier: {lv:.20f} batch size: {batch_sizes[bi] * 2}"
                )
            if math.isnan(lv):
                log.info(f"Loss: {lv}")
        epoch_loss = float((loss_row * batch_sizes).sum() / max(batch_sizes.sum(), 1))
        lq.appendleft(epoch_loss)
        lq_mean = float(np.nanmean(lq))
        if lq_mean < consec_lowest:
            consec_lowest, consec_best_epoch = lq_mean, epoch
        hrs, m, s = hms(time.time() - since)
        log.info(
            f"Epoch [{epoch + 1}/{num_epochs}], Step [{n_batches}/{n_batches}], "
            f"Train loss: {epoch_loss:.20f}, Time: {hrs:02d}:{m:02d}:{s:02d}"
        )
        st.keep_if_best(epoch, epoch_loss)
        if _autosave_due(epoch, num_epochs, autosave_every):
            st.autosave(state_path, epoch)

    log.info(f"Best Epoch [{st.best_epoch + 1}/{num_epochs}], Lowest loss: {st.lowest:.20f}")
    log.info(
        f"Best consecutive Epoch [{consec_best_epoch + 1}/{num_epochs}], "
        f"Lowest loss: {consec_lowest:.20f}"
    )
    meta = {
        "model_input_size": input_size,
        "model_hidden_size_fc1": hidden_size,
        "model_embedding_size": embedding_size,
        "best_epoch": st.best_epoch,
        "lowest_loss": st.lowest,
    }
    ckpt_path = os.path.join(model_filepath, f"model_subtree_{c}.ckpt")
    if mesh.distributed:
        log.info(check_replicas(st.best, mesh, f"subtree {c} best params"))
    save_checkpoint(ckpt_path, "NeuralNet", meta, params_to_jax(st.best))
    del dstore, dist_dev
    if not is_coordinator():  # the coordinator alone reads the full genomes and exports
        return ckpt_path

    # final embeddings from the full genomes (train_model_set_chunks.py:578-616)
    full_names, full_feats = load_kf_matrix(
        [os.path.join(input_dir_fullgenomes, g + ".kf") for g in backbone_names])
    full_feats = torch.from_numpy(full_feats * F32(defaults.FEATURES_SCALER)).to(dev)
    export_embeddings(st.best, full_feats, full_names, model_filepath, c, log)
    return ckpt_path


# -- chunk classifier trainer ----------------------------------------------------


def train_classifier_chunks_func(
    features_folder: str,
    input_dir_fullgenomes: str,
    feature_files: list[str],
    clades_info: str,
    num_epochs: int,
    hidden_size: int,
    batch_size: int,
    lr0: float,
    lr_min: float,
    lr_decay: float,
    seed: int,
    custom_mask: bool,
    cap_data: bool,
    model_filepath: str,
    resume: bool = False,
    autosave_every: int = 500,
    device: str = DEFAULT_DEVICE,
    mesh: DataMesh | None = None,
) -> str:
    dev = resolve_device(device)
    mesh = trainer_mesh(mesh, dev)
    since = time.time()
    log = make_run_logger(model_filepath, f"train_classifier_{timestamp()}.log")
    try:
        ckpt_path = _train_classifier(
            log, since, dev, mesh, input_dir_fullgenomes, feature_files, clades_info, num_epochs,
            hidden_size, batch_size, lr0, lr_min, lr_decay, seed, custom_mask, cap_data,
            model_filepath, resume, autosave_every)
    finally:
        close_logger(log)
    barrier(mesh)  # every rank returns once the coordinator's files are written
    return ckpt_path


def _train_classifier(log, since, dev, mesh, input_dir_fullgenomes, feature_files, clades_info,
                      num_epochs, hidden_size, batch_size, lr0, lr_min, lr_decay, seed,
                      custom_mask, cap_data, model_filepath, resume, autosave_every) -> str:
    log.info("\n==> Preparing Data...\n")
    log.info(device_line(dev))
    if mesh.distributed:
        log.info(mesh_line(mesh))
    column_mask, k_inferred = None, None
    if custom_mask:
        _, probe = read_kf(feature_files[0])
        k_inferred = VOCAB_SIZES_TO_K.get(probe.shape[1])
        if k_inferred is None:
            raise ValueError(f"cannot infer k from width {probe.shape[1]} for -mask")
        column_mask = low_complexity_mask(k_inferred)
    store, dstore, counts, input_size = _open_stores(feature_files, cap_data, column_mask, mesh,
                                                     log)
    names = [os.path.basename(p)[: -len(".kf")] for p in feature_files]
    n_items = len(names)
    log.info(f"Dimensions of feature matrix rows: {n_items}, cols: {input_size}")
    log.info(f"Masking: {custom_mask}")
    log.info(f"Cap kmer frequencies: {cap_data}")
    # with -mask the chunk width is the masked count; the full-genome files
    # are unmasked, so compare against the mask's source width
    _check_fullgenome_width(input_dir_fullgenomes, names,
                            int(column_mask.size) if column_mask is not None else input_size)

    clade_map = read_clade_map(clades_info)
    labels = np.array([clade_map[n] for n in names], dtype=np.int64)
    class_count = validate_class_labels(labels)
    log.info(f"Number of Classes: {class_count}")

    gen = torch.Generator().manual_seed(seed)
    model = init_params_(Classifier(input_size, hidden_size, class_count), gen)
    log.info(f"Total parameters: {count_params(model)}")
    state_path = os.path.join(model_filepath, "trainer_state_chunks_classifier.ckpt")
    st = start_or_resume(model, gen, n_items, state_path, resume, log, lr0, dev, mesh)
    highest_acc = float(st.extra.get("acc_at_best", -1.0))
    log.info(_store_line(dstore))
    labels_dev = torch.from_numpy(labels).to(dev)

    n_batches = max(1, math.ceil(n_items / batch_size))
    batch_sizes = _batch_sizes(n_items, batch_size)
    items = max(int(batch_sizes.sum()), 1)
    for epoch in range(st.start_epoch, num_epochs):
        set_lr(st.opt, step_lr(epoch, lr0, lr_min, lr_decay))
        perm, spans = epoch_plan(seed, epoch, counts, draws=1)
        sample = batch_source(store, dstore, spans, batch_size, dev)
        losses, correct = chunk_classifier_epoch(st.model, st.opt, sample, labels_dev,
                                                 torch.from_numpy(perm).to(dev), batch_size, mesh)
        loss_row, corr_row = torch.stack([losses.double(), correct.double()]).cpu().numpy()
        epoch_loss = float((loss_row * batch_sizes).sum() / items)
        acc = float(corr_row.sum() / items)
        hrs, m, s = hms(time.time() - since)
        log.info(
            f"Epoch [{epoch + 1}/{num_epochs}], Step [{n_batches}/{n_batches}], "
            f"Train loss: {epoch_loss:.20f}, {acc:.20f}, Time: {hrs:02d}:{m:02d}:{s:02d}"
        )
        if st.keep_if_best(epoch, epoch_loss):
            highest_acc = acc
        if _autosave_due(epoch, num_epochs, autosave_every):
            st.autosave(state_path, epoch, extra={"acc_at_best": highest_acc})

    log.info(
        f"Best Epoch [{st.best_epoch + 1}/{num_epochs}], Lowest loss: {st.lowest:.20f}, "
        f"Highest accuracy: {highest_acc:.20f}"
    )
    meta = {
        "model_input_size": input_size,
        "model_hidden_size_fc1": hidden_size,
        "model_class_count": class_count,
        "best_epoch": st.best_epoch,
        "lowest_loss": st.lowest,
    }
    if custom_mask:
        meta["low_complexity_mask_k"] = k_inferred
    ckpt_path = os.path.join(model_filepath, "classifier_model.ckpt")
    if mesh.distributed:
        log.info(check_replicas(st.best, mesh, "best params"))
    save_checkpoint(ckpt_path, "NeuralNetClassifierOnly", meta, params_to_jax(st.best))
    del dstore
    if not is_coordinator():  # the coordinator alone reads the full genomes and writes
        return ckpt_path

    # backbone classes from the full genomes (train_classifier_model_chunks.py:
    # 517-559), masked as the chunks were
    full_names, full_feats = load_kf_matrix(
        [os.path.join(input_dir_fullgenomes, g + ".kf") for g in names])
    if column_mask is not None:
        full_feats = full_feats[:, column_mask]
    full_feats = np.ascontiguousarray(full_feats * F32(defaults.FEATURES_SCALER))
    with torch.no_grad():
        probs = np.exp(st.best.eval()(torch.from_numpy(full_feats).to(dev)).cpu().numpy())
    full_labels = np.array([clade_map[n] for n in full_names], dtype=np.int32)
    write_classes_table(os.path.join(model_filepath, "backbone_classes.out"), full_names, probs,
                        class_count, true_class=full_labels)
    log.info(f"Dimensions of class output rows:{len(full_names)} cols:{4 + class_count}")

    log.info("\n==> Training Completed!\n")
    hrs, m, s = hms(time.time() - since)
    log.info(f"Time: {hrs:02d}:{m:02d}:{s:02d}")
    return ckpt_path
