"""Training resume (crash recovery), in the JAX package's trainer-state
format (``train/resume.py`` there).

Trainers autosave the full trainer state every N epochs: params, Adam
state, best-so-far params, the epoch and the best epoch and loss. The
archive is an npz with keys ``params::fc1/w``, ``opt::count``,
``opt::mu/fc1/w``, ``opt::nu/fc1/w``, ``best::fc1/w`` (and so on) and the
``__meta__`` JSON, all in the JAX (in, out) layout, so a state
autosaved by either package resumes in the other
(``models.mlp.adam_state_from_jax`` / ``adam_state_to_jax`` carry the
optimizer across). ``resume=True`` continues from the last autosave.

On a grid with a model axis the state is written full size: every rank
gathers the params, Adam's moments and the best params
(``parallel.mesh.gather_module``, ``models.mlp.adam_state_to_jax``) and the
coordinator writes them; a resume cuts them again for the grid it runs on
(``kf2vecfsw_tpu/train/resume.py:92-148``). So a state resumes on any grid,
and in either package; Adam's step count stays one scalar.
"""

from __future__ import annotations

import copy
import json
import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from ..models.mlp import adam_state_from_jax, adam_state_to_jax, params_from_jax, params_to_jax
from ..parallel.mesh import DataMesh, gather_module, is_coordinator, rank_rows, shard_module
from .checkpoint import _flatten, _unflatten, atomic_savez
from .step import epoch_order, make_adam

_TAGS = ("params", "opt", "best")


def save_trainer_state(
    path: str,
    epoch: int,
    params: dict,
    opt: dict,
    best_params: dict,
    lowest: float,
    best_epoch: int,
    extra: dict | None = None,
) -> None:
    """All trees in the JAX layout (nested dicts of numpy arrays). ``extra``
    carries trainer-specific JSON-serializable scalars (e.g. the
    classifier's accuracy at the best epoch). Written by the coordinator
    only."""
    if not is_coordinator():
        return
    arrays = {}
    for tag, tree in zip(_TAGS, (params, opt, best_params)):
        for k, v in _flatten(tree).items():
            arrays[f"{tag}::{k}"] = v
    meta = {"epoch": epoch, "lowest": lowest, "best_epoch": best_epoch, **(extra or {})}
    atomic_savez(path, meta, arrays)


def load_trainer_state(path: str):
    """-> (epoch, params, opt, best_params, lowest, best_epoch, extra) or None."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = np.load(f, allow_pickle=False)
        meta = json.loads(str(data["__meta__"]))
        trees: dict[str, dict] = {tag: {} for tag in _TAGS}
        for key in data.files:
            if key == "__meta__":
                continue
            tag, _, rest = key.partition("::")
            trees[tag][rest] = data[key]
    extra = {k: v for k, v in meta.items() if k not in ("epoch", "lowest", "best_epoch")}
    return (
        int(meta["epoch"]),
        _unflatten(trees["params"]),
        _unflatten(trees["opt"]),
        _unflatten(trees["best"]),
        float(meta["lowest"]),
        int(meta["best_epoch"]),
        extra,
    )


def _shapes(tree: dict) -> dict:
    return {k: _shapes(v) if isinstance(v, dict) else tuple(np.shape(v)) for k, v in tree.items()}


def restore_trainer_state(state_path: str, params: dict, log=None,
                          mesh: DataMesh | None = None):
    """Load an autosave and guard its parameter shapes against the freshly
    built ``params`` (JAX layout); returns (start_epoch, params, opt,
    best_params, lowest, best_epoch, extra) as JAX-layout trees, or None when
    no autosave exists.

    Raises SystemExit on an architecture mismatch: silently training resumed
    params of a different shape under lying checkpoint metadata is the one
    failure mode worse than losing the run. Over ranks it raises SystemExit
    on every rank when the ranks do not all see the same autosave (one
    without a filesystem shared with rank 0 would start afresh)."""
    state = load_trainer_state(state_path)
    if mesh is not None and mesh.distributed:
        mine = torch.tensor([state is not None, state[0] if state is not None else -1],
                            dtype=torch.int64, device=mesh.device)
        views = rank_rows(mine, mesh).cpu()
        if not bool((views == views[0]).all()):
            raise SystemExit(
                f"cannot -resume: the ranks disagree on the autosaved state at {state_path} "
                f"(per-rank [has_state, epoch] = {views.tolist()}). Autosaves are written by "
                "rank 0 only; resuming over ranks needs the state path on a filesystem that "
                "every rank shares (or a copy on each host)"
            )
    if state is None:
        return None
    last_epoch, s_params, s_opt, s_best, lowest, best_epoch, extra = state
    want, got = _shapes(params), _shapes(s_params)
    if want != got:
        raise SystemExit(
            f"cannot -resume: autosaved state in {state_path} has parameter "
            f"shapes {got} but the current flags build {want} — rerun with "
            f"the original size/model-family flags, or delete the state file"
        )
    if log is not None:
        log.info(f"Resuming from epoch {last_epoch + 1} (autosaved state)")
    return last_epoch + 1, s_params, s_opt, s_best, lowest, best_epoch, extra


@dataclass
class TrainerState:
    """What a trainer carries from epoch to epoch besides the data."""

    model: nn.Module
    best: nn.Module  # a copy of the params at the lowest epoch loss so far
    opt: torch.optim.Adam
    start_epoch: int = 0
    lowest: float = math.inf
    best_epoch: int = -1
    extra: dict = field(default_factory=dict)

    def autosave(self, path: str, epoch: int, extra: dict | None = None) -> None:
        """Every rank gathers the state (a collective on a model axis); the
        coordinator writes it."""
        save_trainer_state(
            path, epoch, params_to_jax(gather_module(self.model)),
            adam_state_to_jax(self.opt, self.model), params_to_jax(gather_module(self.best)),
            self.lowest, self.best_epoch, extra,
        )

    @torch.no_grad()
    def keep_if_best(self, epoch: int, loss: float) -> bool:
        """Strict ``<``, as the JAX package's best-epoch tracking."""
        if not loss < self.lowest:
            return False
        self.lowest, self.best_epoch = loss, epoch
        for b, p in zip(self.best.parameters(), self.model.parameters()):
            b.copy_(p)
        return True


def start_or_resume(model: nn.Module, gen: torch.Generator, n_items: int, state_path: str,
                    resume: bool, log, lr: float, device: torch.device,
                    mesh: DataMesh | None = None, shard: bool = False) -> TrainerState:
    """``model`` is freshly drawn, full size, on the CPU from ``gen``. With
    ``resume`` and an autosave at ``state_path``, params, Adam state and
    best-so-far come from it and ``gen`` skips the item orders of the
    epochs already run, so the resumed run takes the batches an
    uninterrupted one would (on every rank alike). With ``shard`` the model
    and its state are cut over ``mesh``'s model axis (``shard_module``)."""
    state = (restore_trainer_state(state_path, params_to_jax(model), log, mesh) if resume
             else None)
    axis = mesh if shard else None
    if state is None:
        model = shard_module(model, axis).to(device)
        return TrainerState(model, copy.deepcopy(model), make_adam(model, lr))
    start, params, opt_state, best_params, lowest, best_epoch, extra = state
    model = shard_module(params_from_jax(params), axis).to(device)
    opt = make_adam(model, lr)
    adam_state_from_jax(opt, model, opt_state)
    for _ in range(start):
        epoch_order(gen, n_items)
    return TrainerState(model, shard_module(params_from_jax(best_params), axis).to(device), opt,
                        start, lowest, best_epoch, extra)
