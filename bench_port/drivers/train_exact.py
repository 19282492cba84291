"""Training window on the exact FSW route: the distance trainer's epochs back
to back on one subtree with ``-fsw_lazy_refresh 0``, as kf2vecFSW trains
NeuralNetFSW, every step sorting its items' projections afresh.

The traffic mix states the trainer's flag (``fsw_lazy_refresh``: 0); it
replaces the configuration's setting (``fsw_k7_exact`` states 0 itself,
``fsw_k10`` the lazy one it ``assumed``). ``Run`` takes the
route the trainer's own gate (``models/fsw.py`` ``shared_vocab_applicable``)
gives the configuration's clade, and each route class checks the gate again
on the data it made:
- shared-vocab exact (``SharedExact``): ``train_window``'s inputs, and the
  trainer's ``distance_epoch`` on the (n, V) vocab weights (one
  ``sort_rows`` of the (C, V) projections a step, ``SortShared``);
- per-genome exact (``PerGenomeExact``): ``train_pergenome``'s point sets
  padded by ``pad_point_sets``, and ``distance_epoch`` on the (n, N, k+1)
  point sets, with the model's own ``auto_slice_chunk`` (``SortPW`` per
  chunk of slices, each chunk recomputed in the backward).

The checked steps are ``train_window``'s (each sorts afresh), then the
rest of epoch 0. The window runs whole epochs, each with the trainer's
learning rate, item order and loss fetch, until the window's seconds have
passed (``train_window.Run.window``), inside ``utils.phases.collect()``, and
keeps the program's counter ``fsw.exact.slots`` in ``records["counters"]``
(absent from a program that does not count it).

The comparison is ``train_window``'s numbers against ``reference/exact.py``,
which sorts each item's own points at every step.
"""

from __future__ import annotations

import torch

from .. import counts_exact
from ..reference import exact as ref_exact
from ..reference import kmers as ref_kmers
from ..reference import models as ref_models
from . import train_pergenome, train_window

COUNTERS = ("fsw.exact.slots",)  # models/fsw.py


def Run(cfg: dict, mix: dict, seed: int, device: torch.device, tracer):
    """The route's run: shared where the trainer's gate admits the clade's
    vocabulary at all (its genomes then hold nearly all of it), else per
    genome."""
    from kf2vecfsw_tpu_torch.kmer.vocab import canonical_vocab_size
    from kf2vecfsw_tpu_torch.models.fsw import shared_vocab_applicable

    k, b = cfg["k"], cfg["batch_size"]
    shared = shared_vocab_applicable(k, canonical_vocab_size(k), b)
    return (SharedExact if shared else PerGenomeExact)(cfg, mix, seed, device, tracer)


class _Exact:
    """What both routes share: the trainer's flag from the mix, the window
    with the counter, the exact reference."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, tracer):
        super().__init__({**cfg, "fsw_lazy_refresh": mix["fsw_lazy_refresh"]}, mix, seed, device,
                         tracer)

    def _first_steps(self, order: torch.Tensor) -> None:
        train_window.Run._first_steps(self, order)

    def window(self, seconds: float) -> None:
        from kf2vecfsw_tpu_torch.utils import phases

        with phases.collect() as counters:
            train_window.Run.window(self, seconds)
        self.records["counters"] = {k: int(counters[k]) for k in COUNTERS if k in counters}

    def reference(self, dtype=torch.float64) -> dict:
        """The reference's checked steps from the same inputs, computed in
        ``dtype``, the parameters kept in float32."""
        cfg = self.cfg
        lrs = {e: ref_models.step_lr(e, cfg["lr"], cfg["lr_min"], cfg["lr_decay"])
               for e in self.lrs}
        exact = ref_exact.ExactFSW(self.items(), self.dev, dtype)  # (digits, weights) an item
        return {**ref_models.train_steps(self.params0, exact.embed, self.dist.to(dtype),
                                         self.batches, cfg["lr"], None, dtype), "lrs": lrs}

    def program(self) -> dict:
        return train_window.Run.program(self)

    @staticmethod
    def _numbers(prog: dict, ref: dict) -> dict[str, float]:
        return train_window.Run._numbers(prog, ref)


class SharedExact(_Exact, train_window.Run):
    """``train_window``'s epoch function, which at ``fsw_lazy_refresh`` 0
    is the trainer's ``distance_epoch`` on the vocab weights (and refuses a
    clade the shared gate refuses)."""

    def items(self):
        digits = torch.from_numpy(ref_kmers.vocab_digits(self.cfg["k"]))
        present = (self.counts > 0).cpu()
        return [(digits[m], c[m]) for c, m in zip(self.counts.cpu(), present)]

    def flops(self) -> float:
        """Operations of the window's exact shared steps (``counts_exact``)."""
        r, cfg, b = self.records, self.cfg, self.cfg["batch_size"]
        return (r["full_batches"] * counts_exact.shared_step_flops(cfg, self.vocab, b)
                + (r["epochs"] * counts_exact.shared_step_flops(cfg, self.vocab, r["last_batch"])
                   if r["last_batch"] else 0))


class PerGenomeExact(_Exact, train_pergenome.Run):
    def _epoch_fn(self, padded):
        """The trainer's ``distance_epoch`` on the padded point sets."""
        from kf2vecfsw_tpu_torch.models.fsw import shared_vocab_applicable
        from kf2vecfsw_tpu_torch.train.step import distance_epoch

        cfg, b = self.cfg, self.cfg["batch_size"]
        if shared_vocab_applicable(cfg["k"], padded.shape[1], b):
            raise NotImplementedError("the trainer takes this clade on the shared route")
        feats = torch.from_numpy(padded).to(self.dev)
        self.planes = None
        return lambda order: distance_epoch(self.model, self.opt, feats, self.dist, order, b)

    def items(self):
        return [(torch.from_numpy(m[:, :-1]).long(), torch.from_numpy(m[:, -1])) for m in self.mats]

    def flops(self) -> float:
        """Operations of the window's exact per-genome steps on the items'
        real points (``counts_exact``): every epoch embeds every item once."""
        r, cfg, b = self.records, self.cfg, self.cfg["batch_size"]
        per_epoch = counts_exact.pergenome_points_flops(cfg, sum(len(m) for m in self.mats))
        return (r["epochs"] * per_epoch
                + r["full_batches"] * counts_exact.pergenome_batch_flops(cfg, b)
                + (r["epochs"] * counts_exact.pergenome_batch_flops(cfg, r["last_batch"])
                   if r["last_batch"] else 0))

