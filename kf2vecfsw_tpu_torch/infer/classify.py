"""Query classification (reference: classify.py:57-129).

Takes the classifier from the device-resident cache (``infer/cache.py``),
reads the query features from the cached device matrix (or, when it is off
or over budget, block by block from `.kf` files: scaled by
FEATURES_SCALER, with the checkpoint's column mask), runs the forward pass
on the device and appends one row per query to classes.out in the JAX
package's format.

The blocks run as a pipeline, as in the JAX package: a thread parses block
z+1, and block z-1 is formatted and written while the device runs block z.
Each block's result comes back with a non-blocking copy into pinned host
memory behind a CUDA event. Phases (``utils/phases``): model_load, parse,
transfer, dispatch, fetch, format; one ``dispatches`` count per forward.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import defaults
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.kf import float_repr
from ..utils import phases
from ..utils.cancel import CancelFlag, writing
from ..utils.logging import close_logger, make_run_logger
from ..utils.prefetch import prefetch_iter
from ..utils.timing import hms
from .cache import cached_checkpoint, cached_query_matrix, read_kf_files_cached


def to_host_async(t: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """Start copying a device result to host memory: a CUDA tensor goes with
    a non-blocking copy into pinned memory, behind an event recorded on its
    stream; a CPU tensor is already there."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


def host_result(pending: tuple[torch.Tensor, torch.cuda.Event | None]) -> np.ndarray:
    """The numpy view of a ``to_host_async`` result, once its copy ended."""
    host, event = pending
    if event is not None:
        event.synchronize()
    return host.numpy()


def to_device(x, dev: torch.device) -> torch.Tensor:
    """A block as a tensor on ``dev`` (the cached matrix's blocks are
    there already)."""
    if isinstance(x, torch.Tensor):
        return x
    with phases.phase("transfer"):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def classify_func(
    features_folder: str,
    feature_files: list[str],
    model_dir: str,
    seed: int,
    output_dir: str,
    block_size: int = defaults.DEFAULT_BLOCK_SZ,
    device: str = DEFAULT_DEVICE,
    cancel: CancelFlag | None = None,
) -> str:
    dev = resolve_device(device)
    since = time.time()
    log = make_run_logger(output_dir, "classification.log", cancel)
    try:
        log.info("\n==> Input arguments...\n")
        log.info(f"Feature directory: {features_folder}")
        log.info(f"Model: {model_dir}")
        log.info(f"Seed: {seed}")
        log.info(f"Device: {dev}")
        log.info("\n==> Building model...\n")

        with phases.phase("model_load"):
            model_name, meta, model = cached_checkpoint(
                os.path.join(model_dir, "classifier_model.ckpt"), dev
            )
        if model_name != "NeuralNetClassifierOnly":
            raise ValueError(f"unexpected classifier model {model_name!r}")
        input_size = int(meta["model_input_size"])
        class_count = int(meta["model_class_count"])
        column_mask = None
        if meta.get("low_complexity_mask_k"):
            from ..kmer.vocab import low_complexity_mask

            column_mask = low_complexity_mask(int(meta["low_complexity_mask_k"]))

        # the features cross to the device once for classify and query
        qmat = cached_query_matrix(feature_files, dev)

        def _matrix_blocks():
            all_names, _, mat = qmat
            if column_mask is not None and mat.shape[1] == column_mask.size:
                mat = mat[:, torch.from_numpy(np.nonzero(column_mask)[0]).to(dev)]
            if mat.shape[1] != input_size:
                raise ValueError(f"feature width {mat.shape[1]} != model input {input_size}")
            for z in range(0, len(all_names), block_size):  # blocks of rows
                yield all_names[z : z + block_size], mat[z : z + block_size]

        def _file_blocks():
            for z in range(0, len(feature_files), block_size):  # blocks of files
                with phases.phase("parse"):
                    names, mat = read_kf_files_cached(feature_files[z : z + block_size])
                    if column_mask is not None and mat.shape[1] == column_mask.size:
                        mat = mat[:, column_mask]
                    if mat.shape[1] != input_size:
                        raise ValueError(
                            f"feature width {mat.shape[1]} != model input {input_size}"
                        )
                    x = mat * np.float32(defaults.FEATURES_SCALER)
                yield names, x

        classes_path = os.path.join(output_dir, "classes.out")
        header = ["genome", "top_class", "top_p"] + [str(x) for x in range(class_count)]

        def _write_out(f, pending):
            names, out = pending
            with phases.phase("fetch"):
                probs = np.exp(host_result(out))
            with phases.phase("format"):
                top = probs.argmax(axis=1)
                text = "".join(
                    "\t".join([name, float_repr(float(top[i])), float_repr(float(probs[i, top[i]]))]
                              + [float_repr(float(p)) for p in probs[i]]) + "\n"
                    for i, name in enumerate(names)
                )
            with writing(cancel, classes_path):
                f.write(text)
                f.flush()

        with writing(cancel, classes_path):
            f = open(classes_path, "w")
            f.write("\t".join(header) + "\n")
            f.flush()
        with f, torch.no_grad():
            pending = None
            blocks = _matrix_blocks() if qmat is not None else _file_blocks()
            for names, x in prefetch_iter(blocks):
                x = to_device(x, dev)
                with phases.phase("dispatch"):
                    out = to_host_async(model(x))
                phases.count("dispatches")
                if pending is not None:
                    _write_out(f, pending)
                pending = (names, out)
            if pending is not None:
                _write_out(f, pending)

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
