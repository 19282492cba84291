"""Checkpoint I/O in the JAX package's format.

A `.ckpt` file is a numpy .npz archive: a '__meta__' JSON entry (model_name,
hyperparameters, best epoch/loss) plus the flattened parameter arrays under
keys like ``fc1/w`` or ``fsw/slices`` in the JAX (in, out) layout, so a
checkpoint written by either package loads in the other. Parameters cross
this module as nested dicts of numpy arrays; ``models.mlp.params_from_jax``
turns them into a module.

A reference torch checkpoint (torch.save dict, utils.py:358-371) is also
read, through the same key map as the JAX package's import shim.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from ..parallel.mesh import is_coordinator

FLAT_SEP = "/"


def _flatten(params, prefix=""):
    out = {}
    for k, v in params.items():
        key = f"{prefix}{FLAT_SEP}{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split(FLAT_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def atomic_savez(path: str, meta: dict, arrays: dict) -> None:
    """Atomic npz write: a crash mid-save must not leave a truncated archive
    at the final path."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def save_checkpoint(path: str, model_name: str, meta: dict, params) -> None:
    """Written by the coordinator only: over ranks every rank holds the same
    params, and identical writes through one path + '.tmp' would race."""
    if not is_coordinator():
        return
    atomic_savez(path, {"model_name": model_name, **meta}, _flatten(params))


def fsw_k_from_meta(meta: dict) -> int:
    """The k an FSW checkpoint was trained at (shared by query + wrappers)."""
    return int(meta.get("fsw_k", meta["model_input_size"] - 1))


def fsw_ks(distance_model: str) -> list[int]:
    """The k of every FSW subtree model of a library, from checkpoint meta
    only (the weights are not read)."""
    ks = set()
    for ckpt in sorted(glob.glob(os.path.join(distance_model, "model_subtree_*.ckpt"))):
        try:
            model_name, meta = load_checkpoint_meta(ckpt)
            if model_name == "NeuralNetFSW":
                ks.add(fsw_k_from_meta(meta))
        except (OSError, ValueError, KeyError) as e:
            # as the JAX package: an unreadable model fails the query only
            # if a genome is classified into its subtree
            print(f"WARNING: could not inspect {ckpt}: {e}")
    return sorted(ks)


def load_checkpoint_meta(path: str):
    """Returns (model_name, meta dict) WITHOUT materializing the parameter
    arrays — np.load is lazy, so only the '__meta__' JSON entry is read.
    Falls back to a full load for reference torch checkpoints."""
    try:
        with open(path, "rb") as f:
            data = np.load(f, allow_pickle=False)
            meta = json.loads(str(data["__meta__"]))
        meta = dict(meta)
        return meta.pop("model_name"), meta
    except Exception:
        name, meta, _ = load_checkpoint(path)
        return name, meta


def load_checkpoint(path: str):
    """Returns (model_name, meta dict, params as nested numpy dicts).
    Transparently converts reference torch checkpoints when encountered."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    try:
        with open(path, "rb") as f:
            data = np.load(f, allow_pickle=False)
            flat = {k: data[k] for k in data.files if k != "__meta__"}
            meta = json.loads(str(data["__meta__"]))
    except Exception:
        # not our npz format: try the reference torch-checkpoint shim; chain
        # the original cause so a truncated/corrupt file is diagnosable
        try:
            return _load_torch_checkpoint(path)
        except Exception as torch_err:
            raise ValueError(
                f"{path} is neither a kf2vec-tpu checkpoint nor a readable "
                f"reference torch checkpoint ({torch_err})"
            ) from torch_err
    model_name = meta.pop("model_name")
    return model_name, meta, _unflatten(flat)


# -- reference torch-checkpoint shim -------------------------------------------

_TORCH_KEYMAP = {
    # torch Linear stores (out, in) weights; checkpoints here are (in, out)
    "fc1.weight": ("fc1", "w", True),
    "fc1.bias": ("fc1", "b", False),
    "fc2.weight": ("fc2", "w", True),
    "fc2.bias": ("fc2", "b", False),
    "fc3.weight": ("fc3", "w", True),
    "fc3.bias": ("fc3", "b", False),
    "lookup": ("lookup", None, False),
}


def _load_torch_checkpoint(path: str):
    """Best-effort import of a reference torch.save checkpoint
    (utils.py:358-371 / train_classifier_model.py:370-380)."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    sd = state["state_dict"]
    params: dict = {}
    for key, tensor in sd.items():
        key = key.removeprefix("module.")
        arr = tensor.detach().cpu().numpy()
        if key in _TORCH_KEYMAP:
            group, leaf, transpose = _TORCH_KEYMAP[key]
            if transpose:
                arr = arr.T
            if leaf is None:
                params[group] = arr
            else:
                params.setdefault(group, {})[leaf] = arr
    meta = {
        k: v
        for k, v in state.items()
        if k != "state_dict" and (np.isscalar(v) or isinstance(v, str))
    }
    # classifier checkpoints carry model_class_count (train_classifier_model.py:374)
    if "model_class_count" in state and "fc3" in params:
        model_name = "NeuralNetClassifierOnly"
    elif "lookup" in params:
        model_name = "NeuralNetFSW"
    else:
        model_name = "NeuralNet"
    meta.pop("model_name", None)
    return model_name, meta, params
