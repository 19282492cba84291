"""Classifier trainer (the port's ``train_classifier``; reference:
train_classifier_model.py, JAX package: ``train/classifier.py``).

The backbone's `.kf` rows are read in parallel, scaled by FEATURES_SCALER
and (with ``-mask``) cut to the low-complexity mask's columns, then held on
the device. Each epoch draws its item order from a CPU generator seeded by
``seed`` (which also drew the initial weights) and runs
``step.classifier_epoch``; the loss and accuracy are fetched once per
epoch. The params of the lowest epoch loss (strict ``<``) are written to
``classifier_model.ckpt`` (NeuralNetClassifierOnly), and a forward of the
whole backbone with them to ``backbone_classes.out``, both in the JAX
package's formats.

Over ranks (``parallel.mesh.initialize_distributed``) every rank holds the
features, draws the same orders and takes the sharded batch plan; the
replicas are checked bit-equal before the checkpoint, and the coordinator
alone writes files. ``mesh=parallel.mesh.make_mesh(n_data, n_model)``
trains on a grid with a model axis (``kf2vecfsw_tpu/train/classifier.py:
122,189-197``): each rank keeps its cut of the full init over the hidden
dimension, and every rank gathers the full weights before the coordinator
writes the checkpoint, a trainer state or ``backbone_classes.out``.
"""

from __future__ import annotations

import glob
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import defaults
from ..device import DEFAULT_DEVICE, device_line, resolve_device
from ..io.kf import float_repr, read_kf
from ..kmer.vocab import low_complexity_mask
from ..models.mlp import Classifier, count_params, init_params_, params_from_jax, params_to_jax
from ..parallel.mesh import (
    DataMesh,
    barrier,
    check_replicas,
    gather_module,
    is_coordinator,
    mesh_line,
    trainer_mesh,
)
from ..utils.logging import close_logger, make_run_logger, timestamp
from ..utils.timing import hms
from .checkpoint import load_checkpoint, save_checkpoint
from .resume import start_or_resume
from .schedule import step_lr
from .step import classifier_epoch, epoch_order, set_lr

VOCAB_SIZES_TO_K = {32: 3, 136: 4, 512: 5, 2080: 6, 8192: 7, 32896: 8, 131072: 9}


def load_kf_matrix(paths: list[str], threads: int = 8) -> tuple[list[str], np.ndarray]:
    """Parallel .kf ingest (replaces mp.Pool(my_read_csv),
    train_classifier_model.py:144-147). Returns (names, float32 matrix)."""
    with ThreadPoolExecutor(max_workers=threads) as pool:
        results = list(pool.map(read_kf, paths))
    names: list[str] = []
    mats = []
    for n, m in results:
        names.extend(n)
        mats.append(m)
    return names, np.vstack(mats).astype(np.float32)


def read_clade_map(subtrees_path: str) -> dict[str, int]:
    from ..ingest.tree_ops import read_subtrees

    return dict(read_subtrees(subtrees_path))


def validate_class_labels(labels: np.ndarray) -> int:
    """Class ids must be exactly {0..C-1}; returns C.

    The class id IS the output column index everywhere downstream
    (classes.out probability columns, query's model_subtree_{c}.ckpt lookup),
    so a non-contiguous or negative id in a hand-made .subtrees file would
    silently mistrain and misroute queries. divide_tree always emits
    contiguous 0-based ids."""
    uniq = np.unique(labels)
    if uniq.size == 0 or uniq[0] != 0 or int(uniq[-1]) != uniq.size - 1:
        raise ValueError(
            "clade ids in the .subtrees file must be contiguous 0-based "
            f"integers (got {uniq[:10].tolist()}...); regenerate it with "
            "divide_tree"
        )
    return int(uniq.size)


def write_classes_table(
    path: str,
    genomes: list[str],
    probs: np.ndarray,
    class_count: int,
    true_class: np.ndarray | None = None,
) -> None:
    """classes.out / backbone_classes.out writer (TSV; top_class rendered as a
    float to match the reference's np.hstack of floats,
    train_classifier_model.py:496-506, classify.py:96-124); the coordinator
    alone writes."""
    if not is_coordinator():
        return
    top_class = probs.argmax(axis=1)
    top_p = probs.max(axis=1)
    with open(path, "w") as f:
        cols = ["genome"]
        if true_class is not None:
            cols.append("true_class")
        cols += ["top_class", "top_p"] + [str(x) for x in range(class_count)]
        f.write("\t".join(cols) + "\n")
        for i, g in enumerate(genomes):
            row = [g]
            if true_class is not None:
                row.append(str(int(true_class[i])))
            row.append(float_repr(float(top_class[i])))
            row.append(float_repr(float(top_p[i])))
            row.extend(float_repr(float(p)) for p in probs[i])
            f.write("\t".join(row) + "\n")


def train_classifier_func(
    features_folder: str,
    feature_files: list[str],
    clades_info: str,
    num_epochs: int,
    hidden_size: int,
    batch_size: int,
    lr: float,
    lr_min: float,
    lr_decay: float,
    seed: int,
    custom_mask: bool,
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
        ckpt_path = _train(
            log, since, dev, mesh, features_folder, feature_files, clades_info, num_epochs,
            hidden_size, batch_size, lr, lr_min, lr_decay, seed, custom_mask,
            model_filepath, resume, autosave_every,
        )
    finally:
        close_logger(log)
    barrier(mesh)  # every rank returns once the coordinator's files are written
    return ckpt_path


def _train(
    log, since, dev, mesh, features_folder, feature_files, clades_info, num_epochs,
    hidden_size, batch_size, lr0, lr_min, lr_decay, seed, custom_mask,
    model_filepath, resume, autosave_every,
):
    log.info("\n==> Input arguments...\n")
    log.info(f"Feature directory: {features_folder}")
    log.info(f"Clades information: {clades_info}")

    log.info("\n==> Parameters...\n")
    log.info(device_line(dev))
    if mesh.distributed:
        log.info(mesh_line(mesh))
    log.info(f"Hidden Size fc1: {hidden_size}")
    log.info(f"Total Epochs: {num_epochs}")
    log.info(f"Batch Size: {batch_size}")
    log.info(f"Learning Rate: {lr0:g}")
    log.info(f"Learning Rate Min: {lr_min:g}")
    log.info(f"Learning Rate Decay: {lr_decay:g}")
    log.info(f"Random Seed: {seed}")
    log.info(f"Masking: {custom_mask}")

    log.info("\n==> Preparing Data...\n")
    if not feature_files:
        feature_files = sorted(glob.glob(os.path.join(features_folder, "*.kf")))
    names, feats = load_kf_matrix(feature_files)
    feats = feats * np.float32(defaults.FEATURES_SCALER)
    input_size = feats.shape[1]
    log.info(f"Dimensions of feature matrix rows: {feats.shape[0]}, cols: {input_size}")

    mask_k = None
    if custom_mask:
        mask_k = VOCAB_SIZES_TO_K.get(input_size)
        if mask_k is None:
            raise ValueError(f"cannot infer k from input size {input_size} for -mask")
        feats = feats[:, low_complexity_mask(mask_k)]
        input_size = feats.shape[1]
        log.info(
            f"Dimensions of feature matrix after masking rows: {feats.shape[0]}, "
            f"cols: {input_size}"
        )

    clade_map = read_clade_map(clades_info)
    labels = np.array([clade_map[n] for n in names], dtype=np.int64)
    class_count = validate_class_labels(labels)
    n_items = len(names)
    log.info(f"Number of Train Samples: {n_items}")

    log.info("\n==> Building model...\n")
    log.info(f"Number of Classes: {class_count}")
    gen = torch.Generator().manual_seed(seed)
    model = init_params_(Classifier(input_size, hidden_size, class_count), gen)
    log.info(f"Total parameters: {count_params(model)}")
    log.info(f"Trainable parameters: {count_params(model)}")
    state_path = os.path.join(model_filepath, "trainer_state_classifier.ckpt")
    st = start_or_resume(model, gen, n_items, state_path, resume, log, lr0, dev, mesh,
                         shard=True)
    highest_acc = float(st.extra.get("highest_acc", -1.0))
    feats_dev = torch.from_numpy(np.ascontiguousarray(feats)).to(dev)
    labels_dev = torch.from_numpy(labels).to(dev)

    hrs, m, s = hms(time.time() - since)
    log.info(f"Time: {hrs:02d}:{m:02d}:{s:02d}")
    log.info("\n==> Training model...\n")

    n_batches = -(-n_items // batch_size)
    for epoch in range(st.start_epoch, num_epochs):
        lr = step_lr(epoch, lr0, lr_min, lr_decay)
        set_lr(st.opt, lr)
        order = epoch_order(gen, n_items).to(dev)
        loss_t, acc_t = classifier_epoch(st.model, st.opt, feats_dev, labels_dev, order,
                                         batch_size, mesh)
        loss, acc = torch.stack([loss_t, acc_t]).tolist()  # the epoch's one fetch
        if st.keep_if_best(epoch, loss):
            highest_acc = acc
        hrs, m, s = hms(time.time() - since)
        log.info(
            f"Epoch [{epoch + 1}/{num_epochs}], Step [{n_batches}/{n_batches}], "
            f"Train loss: {loss:.20f}, {acc:.20f}, "
            f"Time: {hrs:02d}:{m:02d}:{s:02d}"
        )
        log.info(f"Epoch {epoch + 1}\t \x20\x20LR:{lr:.20f}")
        if autosave_every and ((epoch + 1) % autosave_every == 0 or epoch == num_epochs - 1):
            st.autosave(state_path, epoch, extra={"highest_acc": highest_acc})

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
    if mask_k is not None:
        # classify filters query features with the same mask
        meta["low_complexity_mask_k"] = mask_k
    ckpt_path = os.path.join(model_filepath, "classifier_model.ckpt")
    best = gather_module(st.best)
    if mesh.distributed:
        log.info(check_replicas(best, mesh, "best params"))
    save_checkpoint(ckpt_path, "NeuralNetClassifierOnly", meta, params_to_jax(best))
    if not is_coordinator():
        return ckpt_path

    # full-backbone forward with the saved params -> backbone_classes.out
    # (train_classifier_model.py:470-506)
    model_name, _, loaded = load_checkpoint(ckpt_path)
    if model_name != "NeuralNetClassifierOnly":
        raise ValueError(f"unexpected classifier model {model_name!r} in {ckpt_path}")
    with torch.no_grad():
        probs = np.exp(params_from_jax(loaded).to(dev).eval()(feats_dev).cpu().numpy())
    write_classes_table(os.path.join(model_filepath, "backbone_classes.out"), names, probs,
                        class_count, true_class=labels)
    log.info(f"Dimensions of class output rows:{len(names)} cols:{4 + class_count}")

    log.info("\n==> Training Completed!\n")
    hrs, m, s = hms(time.time() - since)
    log.info(f"Time: {hrs:02d}:{m:02d}:{s:02d}")
    return ckpt_path
