"""Per-subtree distance-embedding trainer (the port's ``train_model_set``;
reference: train_model_set.py, JAX package: ``train/distance.py``).

One model per clade: embeddings are trained so pairwise L2 distances
approximate sqrt(patristic distance) under inverse-distance weighting
(losses.py:13-49). Two model families:
- NeuralNet (``-no_fsw``) on the `.kf` vectors;
- NeuralNetFSW (the default) on the `.npy` k-mer point sets of get_kmers.
  A clade whose padded point sets cover at least a third of the canonical
  vocab trains on (n, V) vocab weights (the shared-vocab path, one sort a
  batch); others, and inputs that are not canonical k-mers, keep the
  per-genome point sets. On either, the lazy sort-refresh route
  (``train/fsw_lazy.py``) runs by default at R = 128 when its refresh fits
  the device; ``fsw_lazy_refresh=0`` asks for the exact per-step sort, N > 0
  for R = N. The export always runs the exact per-genome forward.

The clade's features and true distances live on the device; each epoch
draws its item order from a CPU generator seeded by ``seed`` (which also
drew the initial weights, afresh for every clade, as the JAX package reuses
one key per clade); the loss is fetched once per epoch. A held-out
``-test_set`` is scored each epoch with the exact forward, ``-save_interval``
writes snapshots, and the params of the lowest epoch loss are written to
``model_subtree_{c}.ckpt`` and embedded into the APPLES-compatible
embeddings/distortions CSVs. With ``KF2VEC_PROFILE_DIR`` set, each clade's
second epoch is traced into ``<dir>/train_model_clade_{c}/``
(``utils/profiling.py``).

Over ranks (``parallel.mesh.initialize_distributed``) every rank holds the
clade's features and draws the same orders; each route takes the sharded
batch plan (the exact route sorts each rank's own point sets, the lazy
route refreshes every item's planes on every rank); the replicas are
checked bit-equal before each checkpoint, and the coordinator alone writes
files. ``mesh=parallel.mesh.make_mesh(n_data, n_model)`` trains on a grid
with a model axis (``kf2vecfsw_tpu/train/distance.py:181,245,327-352``):
every rank draws the full init from the trainer's CPU generator and keeps
its cut (``shard_module``), so a grid trains from the weights of one
process; an FSW rank sorts and refreshes only its d_out / n_model slices.
Every rank gathers the full weights (``gather_module``) before the
coordinator writes a checkpoint, a snapshot or a trainer state, and the
exports run the unsharded forward on them.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .. import defaults
from ..device import DEFAULT_DEVICE, device_line, resolve_device
from ..ingest.kmers import point_sets_to_vocab_weights
from ..io.native.lib import load as load_textio
from ..models.fsw import FSWDistEmbed, init_fsw_dist_embed_, shared_vocab_applicable
from ..models.mlp import DistEmbed, count_params, init_params_, params_from_jax, params_to_jax
from ..parallel.mesh import (
    DataMesh,
    barrier,
    check_replicas,
    gather_module,
    is_coordinator,
    mesh_line,
    trainer_mesh,
)
from ..ops.pairwise import cdist_exact_blocked, squared_clamped
from ..utils.logging import close_logger, make_run_logger, timestamp
from ..utils.profiling import maybe_trace
from ..utils.timing import hms
from .checkpoint import load_checkpoint, save_checkpoint
from .classifier import load_kf_matrix
from .fsw_lazy import LazyPlanes, lazy_distance_epoch, pick_refresh_group
from .resume import start_or_resume
from .schedule import step_lr
from .step import bucket_items, distance_epoch, epoch_order, eval_loss, set_lr

F32 = np.float32
EXPORT_BLOCK = 512  # backbone rows per forward of the export
FSW_EXPORT_BLOCK = 16  # point sets per forward of the export (a training batch)


def f32_row(vals, sep: str = "\t") -> str:
    """One str(np.float32)-formatted row ending in '\\n' (the port's C++ text
    library)."""
    return load_textio().format_floats(np.asarray(vals, dtype=np.float32), sep=sep)


def f32_row_plain(vals, sep: str = "\t") -> str:
    """``f32_row`` in pure Python."""
    return sep.join(str(np.float32(v)) for v in vals) + "\n"


def read_test_ids(path: str | None) -> list[str]:
    """-test_set file: one filename per line, extension stripped
    (utils.py:440-454)."""
    if path is None:
        return []
    with open(path) as f:
        return [os.path.splitext(line.strip())[0] for line in f if line.strip()]


def load_subtree_dist(true_dist_dir: str, clade: int, order: list[str]) -> np.ndarray:
    """Find *_subtree_{c}.di_mtrx and reindex to feature order
    (train_model_set.py:260-268 + utils.py sort_df)."""
    from ..tree.distance import read_di_mtrx, reindex_matrix

    candidates = [f for f in os.listdir(true_dist_dir) if f"_subtree_{clade}.di_mtrx" in f]
    if not candidates:
        raise FileNotFoundError(f"no *_subtree_{clade}.di_mtrx under {true_dist_dir}")
    rl, cl, v = read_di_mtrx(os.path.join(true_dist_dir, candidates[0]))
    return reindex_matrix(rl, cl, v, order)


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


@torch.no_grad()
def export_embeddings(model: torch.nn.Module, feats: torch.Tensor, backbone_names: list[str],
                      out_dir: str, clade, log) -> np.ndarray:
    """Embed the full backbone; write distortions_subtree_{c}.csv (squared,
    <1e-6 clamped to 0) and embeddings_subtree_{c}.csv
    (train_model_set.py:602-643). Returns the embeddings; the coordinator
    alone computes and writes them (None on the other ranks)."""
    if not is_coordinator():
        return None
    model.eval()
    block = FSW_EXPORT_BLOCK if feats.dim() == 3 else EXPORT_BLOCK
    outputs = torch.cat([model(feats[i : i + block]) for i in range(0, feats.shape[0], block)])
    dist = squared_clamped(cdist_exact_blocked(outputs, outputs)).cpu().numpy()
    outputs = outputs.cpu().numpy()
    with open(os.path.join(out_dir, f"distortions_subtree_{clade}.csv"), "w") as f:
        f.write("\t" + "\t".join(backbone_names) + "\n")
        for name, row in zip(backbone_names, dist):
            f.write(name + "\t" + f32_row(row))
    with open(os.path.join(out_dir, f"embeddings_subtree_{clade}.csv"), "w") as f:
        for name, row in zip(backbone_names, outputs):
            f.write(name + "\t" + f32_row(row))
    if log:
        log.info(
            f"Dimensions of distortion matrix rows:{len(backbone_names)} "
            f"cols:{len(backbone_names) + 1}"
        )
        log.info(
            f"Dimensions of embedding output rows:{len(backbone_names)} "
            f"cols:{outputs.shape[1] + 1}"
        )
    return outputs


def train_model_set_func(
    features_folder: str,
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
    model_filepath: str,
    test_ids_path: str | None = None,
    save_interval: int | None = None,
    use_fsw: bool = True,
    base_dim: int = defaults.FSW_BASE_DIM,
    fswout_dim: int = defaults.FSW_OUT_DIM,
    resume: bool = False,
    autosave_every: int = 500,
    fsw_lazy_refresh: int | None = None,
    device: str = DEFAULT_DEVICE,
    mesh: DataMesh | None = None,
) -> list[str]:
    dev = resolve_device(device)
    mesh = trainer_mesh(mesh, dev)
    if use_fsw and not any(f.endswith(".npy") for f in feature_files):
        raise SystemExit(
            f"train_model_set: no .npy k-mer point sets in {features_folder}; FSW models "
            "(the default) train on the output of get_kmers. Pass -no_fsw to train dense "
            "models on .kf files."
        )
    since = time.time()
    clade_tag = (
        "_".join(str(c) for c in clades_to_train) if clades_to_train is not None else "all"
    )
    log = make_run_logger(model_filepath, f"train_model_{timestamp()}_clade_{clade_tag}.log")
    try:
        saved = _train_all(
            log, since, dev, mesh, features_folder, feature_files, clades_info, true_dist_dir,
            num_epochs, hidden_size, embedding_size, batch_size, lr0, lr_min,
            lr_decay, clades_to_train, seed, model_filepath, test_ids_path,
            save_interval, use_fsw, base_dim, fswout_dim, resume, autosave_every,
            fsw_lazy_refresh,
        )
    finally:
        close_logger(log)
    barrier(mesh)  # every rank returns once the coordinator's files are written
    return saved


def _feature_files(feature_files: list[str], use_fsw: bool) -> dict[str, str]:
    """Sample name -> feature file: ``{name}.kf``, or ``{name}_k{k}.npy``
    with one k per directory."""
    if not use_fsw:
        return {os.path.basename(f)[: -len(".kf")]: f for f in feature_files}
    avail: dict[str, str] = {}
    for f in feature_files:
        stem = _strip_npy_suffix(os.path.basename(f))
        if stem in avail:
            # genome_k7.npy and genome_k9.npy both strip to 'genome': picking
            # one would train the clade at the wrong k
            raise ValueError(
                f"feature dir contains multiple .npy files for '{stem}' "
                f"({os.path.basename(avail[stem])} and {os.path.basename(f)}); "
                "keep one k per directory"
            )
        avail[stem] = f
    return avail


def _fsw_features(paths: list[str], batch_size: int):
    """(padded point sets (n, N, k+1), training features, shared): the
    training features are (n, V) vocab weights when the clade takes the
    shared-vocab path, else the point sets themselves."""
    mats = [np.load(p).astype(np.float32) for p in paths]
    k = mats[0].shape[-1] - 1
    feats = pad_point_sets(mats)
    if shared_vocab_applicable(k, feats.shape[1], batch_size):
        try:
            return feats, point_sets_to_vocab_weights(mats, k), True
        except ValueError:
            pass  # rows outside the canonical vocab: the per-genome path
    return feats, feats, False


def _train_all(
    log, since, dev, mesh, features_folder, feature_files, clades_info, true_dist_dir,
    num_epochs, hidden_size, embedding_size, batch_size, lr0, lr_min, lr_decay,
    clades_to_train, seed, model_filepath, test_ids_path, save_interval,
    use_fsw, base_dim, fswout_dim, resume, autosave_every, fsw_lazy_refresh,
):
    from ..ingest.tree_ops import read_subtrees

    log.info("\n==> Input arguments...\n")
    log.info(f"Feature directory: {features_folder}")
    log.info(f"Clades information: {clades_info}")
    log.info(f"Ground truth directory: {true_dist_dir}")
    log.info(f"Test set: {test_ids_path if test_ids_path else 'None'}")

    log.info("\n==> Parameters...\n")
    log.info(device_line(dev))
    if mesh.distributed:
        log.info(mesh_line(mesh))
    log.info(f"Hidden Size fc1: {hidden_size}")
    log.info(f"Embedding Size: {embedding_size}")
    log.info(f"Total Epochs: {num_epochs}")
    log.info(f"Batch Size: {batch_size}")
    log.info(f"Learning Rate: {lr0:g}")
    log.info(f"Learning Rate Min: {lr_min:g}")
    log.info(f"Learning Rate Decay: {lr_decay:g}")
    log.info(f"Clades to train: {clade_list_str(clades_to_train)}")
    log.info(f"Random Seed: {seed}")
    log.info(f"Model save interval: {save_interval if save_interval is not None else 'unspecified'}")
    model_name = "NeuralNetFSW" if use_fsw else "NeuralNet"
    log.info(f"Model family: {model_name}")

    log.info("\n==> Subtree training...\n")
    rows = read_subtrees(clades_info)
    clade_order: list[int] = []
    for _, c in rows:
        if c not in clade_order:
            clade_order.append(c)
    if clades_to_train is not None:
        clade_order = list(clades_to_train)
    log.info(f"Number of Classes: {len(clade_order)}")

    test_ids = set(read_test_ids(test_ids_path))
    avail = _feature_files(feature_files, use_fsw)
    # the lazy route: auto at R = 128 unless asked for (0 = the exact sort)
    lazy_auto = fsw_lazy_refresh is None
    lazy_refresh = defaults.FSW_LAZY_AUTO_REFRESH if lazy_auto else fsw_lazy_refresh
    saved: list[str] = []
    for c in clade_order:
        log.info(f"\n==> Working on subtree {c}...\n")
        log.info("\n==> Preparing Data...\n")
        clade_set = {g for g, cl in rows if cl == c}
        if use_fsw:
            backbone_names = [g for g in avail if g in clade_set]
            points, feats, fsw_shared = _fsw_features([avail[g] for g in backbone_names],
                                                      batch_size)
            input_size = points.shape[-1]
        else:
            backbone_names, feats = load_kf_matrix([avail[g] for g in avail if g in clade_set])
            feats = feats * F32(defaults.FEATURES_SCALER)
            input_size = feats.shape[1]
            fsw_shared = False
        n_items = len(backbone_names)
        log.info(f"Dimensions of feature matrix rows: {n_items}, cols: {input_size}")

        dist = load_subtree_dist(true_dist_dir, c, backbone_names).astype(np.float32)
        log.info(
            f"Dimensions of true distance matrix rows: {dist.shape[0]}, cols: {dist.shape[1]}"
        )
        train_idx = [i for i, g in enumerate(backbone_names) if g not in test_ids]
        test_idx = [i for i, g in enumerate(backbone_names) if g in test_ids]
        log.info(f"Number of Train Samples: {len(train_idx)}")
        if test_idx:
            log.info(f"Number of Test Samples: {len(test_idx)}")

        log.info("\n==> Building model...\n")
        gen = torch.Generator().manual_seed(seed)
        meta = {
            "model_input_size": input_size,
            "model_hidden_size_fc1": hidden_size,
            "model_embedding_size": embedding_size,
        }
        if use_fsw:
            k = input_size - 1
            model = init_fsw_dist_embed_(
                FSWDistEmbed(k, base_dim, fswout_dim, hidden_size, embedding_size), gen)
            if fsw_shared:
                log.info(f"FSW shared-vocab path: V={feats.shape[1]} (one shared sort per batch)")
            meta.update(fsw_k=k, fsw_base_dim=base_dim, fsw_out_dim=fswout_dim)
        else:
            model = init_params_(DistEmbed(input_size, hidden_size, embedding_size), gen)
        log.info(f"Total parameters: {count_params(model)}")
        log.info(f"Trainable parameters: {count_params(model)}")
        ckpt_path = os.path.join(model_filepath, f"model_subtree_{c}.ckpt")
        state_path = os.path.join(model_filepath, f"trainer_state_subtree_{c}.ckpt")
        st = start_or_resume(model, gen, len(train_idx), state_path, resume, log, lr0, dev, mesh,
                             shard=True)

        feats_dev = torch.from_numpy(feats).to(dev)
        dist_dev = torch.from_numpy(dist).to(dev)
        # the epoch permutes [0, n_train): train rows and columns subset once
        sub = torch.tensor(train_idx, dtype=torch.int64, device=dev)
        feats_train = feats_dev.index_select(0, sub)
        dist_train = dist_dev.index_select(0, sub).index_select(1, sub)

        n_batches = -(-len(train_idx) // batch_size)
        planes = None
        if use_fsw and lazy_refresh > 0:
            # the refresh transients scale with the features' minor length,
            # V (vocab weights) or N (padded point sets)
            group = pick_refresh_group(fswout_dim, feats.shape[1], dev, mesh.n_model,
                                       None if fsw_shared else (k, base_dim),
                                       items=len(train_idx))
            if group > 0:
                planes = LazyPlanes(feats_train, fsw_shared, lazy_refresh, n_batches, group)
            else:
                log.info(
                    "FSW lazy-refresh "
                    + ("auto-check: " if lazy_auto else "requested but ")
                    + "the refresh sort transients exceed the per-device "
                    "HBM budget for this clade; using the exact "
                    + ("shared" if fsw_shared else "per-genome")
                    + " path"
                )
        if planes is not None:
            log.info(
                "FSW lazy sort-refresh path"
                + ("" if fsw_shared else " (per-genome sort orders)")
                + f": refresh every {lazy_refresh} steps"
                + (" (auto-enabled; pass -fsw_lazy_refresh 0 for the exact per-step sort)"
                   if lazy_auto else "")
            )

        hrs, m, s = hms(time.time() - since)
        log.info(f"Time: {hrs:02d}:{m:02d}:{s:02d}")
        log.info("\n==> Training model...\n")

        for epoch in range(st.start_epoch, num_epochs):
            lr = step_lr(epoch, lr0, lr_min, lr_decay)
            set_lr(st.opt, lr)
            order = epoch_order(gen, len(train_idx)).to(dev)
            # the second epoch under KF2VEC_PROFILE_DIR (the first pays for set-up)
            with (maybe_trace(f"train_model_clade_{c}", dev) if epoch == st.start_epoch + 1
                  else contextlib.nullcontext()):
                if planes is None:
                    loss = distance_epoch(st.model, st.opt, feats_train, dist_train, order,
                                          batch_size, mesh=mesh)
                else:
                    loss = lazy_distance_epoch(st.model, st.opt, planes, dist_train, order,
                                               batch_size, mesh=mesh)
            loss = float(loss)  # the epoch's one fetch
            if loss != loss:  # NaN watch (train_model_set_chunks.py:431-432)
                log.info(f"Loss: {loss}")
            st.keep_if_best(epoch, loss)
            hrs, m, s = hms(time.time() - since)
            log.info(
                f"Epoch [{epoch + 1}/{num_epochs}], Step [{n_batches}/{n_batches}], "
                f"Train loss: {loss:.20f}, Time: {hrs:02d}:{m:02d}:{s:02d}"
            )
            if test_idx:
                test_loss = eval_loss(st.model, feats_dev, dist_dev, test_idx, batch_size)
                log.info(f"Epoch [{epoch + 1}/{num_epochs}], Test loss: {test_loss:.20f}")
            log.info(f"Epoch {epoch + 1}\t \x20\x20LR:{lr:.20f}")
            if autosave_every and (epoch + 1) % autosave_every == 0:
                st.autosave(state_path, epoch)
            if save_interval is not None and (
                epoch % save_interval == 0 or epoch == num_epochs - 1
            ):
                snapshot = gather_module(st.model)  # every rank: a collective on a model axis
                if is_coordinator():
                    subdir = os.path.join(model_filepath, f"model_epoch_{epoch + 1}")
                    os.makedirs(subdir, exist_ok=True)
                    save_checkpoint(os.path.join(subdir, f"model_subtree_{c}.ckpt"), model_name,
                                    meta, params_to_jax(snapshot))

        log.info(f"Best Epoch [{st.best_epoch + 1}/{num_epochs}], Lowest loss: {st.lowest:.20f}")
        best = gather_module(st.best)
        if mesh.distributed:
            log.info(check_replicas(best, mesh, f"subtree {c} best params"))
        save_checkpoint(
            ckpt_path, model_name,
            {**meta, "best_epoch": st.best_epoch, "lowest_loss": st.lowest},
            params_to_jax(best),
        )
        saved.append(ckpt_path)

        # final export with the best params (train_model_set.py:602-643); FSW
        # models embed the per-genome point sets with the exact forward,
        # whichever route trained them
        export_feats = torch.from_numpy(points).to(dev) if fsw_shared else feats_dev
        export_embeddings(best, export_feats, backbone_names, model_filepath, c, log)
        # interval snapshots also get embeddings (train_model_set.py:646-683)
        if save_interval is not None and is_coordinator():
            for name in sorted(os.listdir(model_filepath)):
                subdir = os.path.join(model_filepath, name)
                snap = os.path.join(subdir, f"model_subtree_{c}.ckpt")
                if not (name.startswith("model_epoch_") and os.path.exists(snap)):
                    continue
                log.info(f"Computing embeddings for interval: {subdir}")
                _, _, snap_params = load_checkpoint(snap)
                export_embeddings(params_from_jax(snap_params).to(dev), export_feats,
                                  backbone_names, subdir, c, None)

        log.info(f"\n==> Training for subtree {c} completed!\n")
        hrs, m, s = hms(time.time() - since)
        log.info(f"Time: {hrs:02d}:{m:02d}:{s:02d}")

    log.info("\n==> Training Completed!\n")
    hrs, m, s = hms(time.time() - since)
    log.info(f"Time: {hrs:02d}:{m:02d}:{s:02d}")
    return saved


def clade_list_str(clades) -> str:
    return " ".join(str(c) for c in clades) if clades is not None else "all"


def _strip_npy_suffix(basename: str) -> str:
    """{name}_k{k}.npy -> name"""
    stem = basename[: -len(".npy")] if basename.endswith(".npy") else basename
    if "_k" in stem:
        head, _, tail = stem.rpartition("_k")
        if tail.isdigit():
            return head
    return stem
