"""Query classification (reference: classify.py:57-129).

Loads the classifier checkpoint onto the device, reads query `.kf` files in
blocks, scales them by FEATURES_SCALER, applies the checkpoint's column
mask, runs the forward pass on the device and appends one row per query to
classes.out in the JAX package's format.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import defaults
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.kf import float_repr, read_kf_files
from ..models.mlp import params_from_jax
from ..train.checkpoint import load_checkpoint
from ..utils.logging import close_logger, make_run_logger
from ..utils.timing import hms


def load_features(paths: list[str], column_mask: np.ndarray | None, input_size: int,
                  device: torch.device) -> tuple[list[str], torch.Tensor]:
    """`.kf` rows -> (names, float32 (rows, input_size) device tensor scaled by
    FEATURES_SCALER). Rows are parsed as float64 and scaled in float32, as
    the JAX package does."""
    names, mat = read_kf_files(paths, dtype=np.float32)
    if column_mask is not None and mat.shape[1] == column_mask.size:
        mat = mat[:, column_mask]
    if mat.shape[1] != input_size:
        raise ValueError(f"feature width {mat.shape[1]} != model input {input_size}")
    x = torch.from_numpy(np.ascontiguousarray(mat)).to(device)
    return names, x * np.float32(defaults.FEATURES_SCALER)


def classify_func(
    features_folder: str,
    feature_files: list[str],
    model_dir: str,
    seed: int,
    output_dir: str,
    block_size: int = defaults.DEFAULT_BLOCK_SZ,
    device: str = DEFAULT_DEVICE,
) -> str:
    dev = resolve_device(device)
    since = time.time()
    log = make_run_logger(output_dir, "classification.log")
    try:
        log.info("\n==> Input arguments...\n")
        log.info(f"Feature directory: {features_folder}")
        log.info(f"Model: {model_dir}")
        log.info(f"Seed: {seed}")
        log.info(f"Device: {dev}")
        log.info("\n==> Building model...\n")

        model_name, meta, params = load_checkpoint(
            os.path.join(model_dir, "classifier_model.ckpt")
        )
        if model_name != "NeuralNetClassifierOnly":
            raise ValueError(f"unexpected classifier model {model_name!r}")
        input_size = int(meta["model_input_size"])
        class_count = int(meta["model_class_count"])
        column_mask = None
        if meta.get("low_complexity_mask_k"):
            from ..kmer.vocab import low_complexity_mask

            column_mask = low_complexity_mask(int(meta["low_complexity_mask_k"]))
        model = params_from_jax(params).to(dev).eval()

        classes_path = os.path.join(output_dir, "classes.out")
        header = ["genome", "top_class", "top_p"] + [str(x) for x in range(class_count)]
        with open(classes_path, "w") as f, torch.no_grad():
            f.write("\t".join(header) + "\n")
            for z in range(0, len(feature_files), block_size):
                names, x = load_features(
                    feature_files[z : z + block_size], column_mask, input_size, dev
                )
                probs = np.exp(model(x).cpu().numpy())
                top = probs.argmax(axis=1)
                for i, name in enumerate(names):
                    row = [
                        name,
                        float_repr(float(top[i])),
                        float_repr(float(probs[i, top[i]])),
                    ] + [float_repr(float(p)) for p in probs[i]]
                    f.write("\t".join(row) + "\n")

        log.info("\n==> Classification Completed!\n")
        hrs, m, s = hms(time.time() - since)
        log.info(f"Time: {hrs:02d}:{m:02d}:{s:02d}")
        return classes_path
    finally:
        close_logger(log)


def read_classes_out(path: str) -> list[tuple[str, int]]:
    """classes.out -> [(genome, top_class)]."""
    out = []
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        i_genome = header.index("genome")
        i_top = header.index("top_class")
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) <= max(i_genome, i_top):
                continue
            out.append((parts[i_genome], int(float(parts[i_top]))))
    return out
