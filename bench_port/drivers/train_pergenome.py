"""Training window on the per-genome lazy FSW route: the distance trainer's
epochs back to back on one subtree whose genomes each own their point set,
as ``train/distance.py:_train_all`` runs a clade that the shared-vocab
route refuses (at k = 10 the canonical vocabulary holds 524,800 k-mers,
past ``models/fsw.py`` ``FSW_SHARED_VOCAB_MAX``).

Set-up makes the subtree from the seed as ``train_window`` does (a random
backbone's patristic distances, k-mer counts of genomes along it) and turns
the counts into ``get_kmers``' point sets (``points.py``). It then takes
the trainer's own functions in its order: ``shared_vocab_applicable``
refuses the shared route, ``pad_point_sets`` pads the point sets,
``pick_refresh_group`` picks the group, ``LazyPlanes`` holds the planes and
``lazy_distance_epoch`` runs the epochs. The padded length N is printed to
standard error. The checked steps follow ``train_window``'s (the first one
refreshes); the set-up then runs the rest of the first refresh interval,
so that the window starts on a refresh.

The window runs whole epochs, each with the trainer's learning rate, item
order and loss fetch, and ends on the first epoch end after ``seconds`` at
which the next step would refresh: it holds whole refresh intervals (a
refresh takes seconds here, so a window cut anywhere else would move the
steps a second by where it fell). It runs inside ``utils.phases.collect()``
and keeps the program's counters (``fsw.refresh.items``, ``.points``,
``.slots``) in ``records["counters"]``.

The comparison adds ``plane_gap`` to ``train_window``'s numbers: the
largest relative norm of the first refresh's S and g2 of the checked items
against the reference's (``reference/pergenome.py``).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .. import compare, counts, counts_pergenome, inputs, points
from ..reference import models as ref_models
from ..reference import pergenome as ref_pergenome
from . import train_window
from .train_window import F32

COUNTERS = ("fsw.refresh.items", "fsw.refresh.points", "fsw.refresh.slots")  # train/fsw_lazy.py


class Run(train_window.Run):
    # -- set-up ------------------------------------------------------------------

    def setup(self) -> None:
        from kf2vecfsw_tpu_torch.train.distance import pad_point_sets
        from kf2vecfsw_tpu_torch.train.step import epoch_order, make_adam

        cfg, dev = self.cfg, self.dev
        rng, gen = inputs.generators(self.seed, dev)
        n, k = cfg["subtree_size"], cfg["k"]
        children, length, gc, leaves = inputs.random_tree(rng, n)
        self.dist = torch.from_numpy(inputs.patristic(children, length, leaves).astype(F32)).to(dev)
        lo, hi = self.mix["genome_length"]
        lengths = inputs.spread_lengths(rng, n, lo, hi)
        kmer_counts = inputs.genome_counts(gen, k, points.pinned_gc(gc, lengths), lengths, dev)
        self.vocab = kmer_counts.shape[1]
        self.mats = points.point_sets(kmer_counts, k)
        del kmer_counts
        self.params0 = inputs.model_params(gen, cfg, dev)
        self.model = self._program_model()
        self.opt = make_adam(self.model, cfg["lr"])
        padded = pad_point_sets(self.mats)
        print(f"train_pergenome: {n} point sets of {min(len(m) for m in self.mats)}-"
              f"{max(len(m) for m in self.mats)} points, padded to N = {padded.shape[1]}",
              file=sys.stderr)
        self.epoch_fn = self._epoch_fn(padded)
        del padded
        self.orders = torch.Generator().manual_seed(self.seed)  # the trainer's CPU generator
        self.n_batches = -(-n // cfg["batch_size"])
        self._first_steps(epoch_order(self.orders, n).to(dev))

    def _epoch_fn(self, padded: np.ndarray):
        """The trainer's epoch function on the per-genome lazy route."""
        from kf2vecfsw_tpu_torch.models.fsw import shared_vocab_applicable
        from kf2vecfsw_tpu_torch.train.fsw_lazy import (LazyPlanes, lazy_distance_epoch,
                                                        pick_refresh_group)

        cfg, b = self.cfg, self.cfg["batch_size"]
        n, npts, _ = padded.shape
        if shared_vocab_applicable(cfg["k"], npts, b):
            raise NotImplementedError("this driver runs the per-genome FSW route only")
        group = pick_refresh_group(cfg["fsw_out_dim"], npts, self.dev, 1,
                                   (cfg["k"], cfg["base_dim"]))
        if cfg["fsw_lazy_refresh"] <= 0 or group <= 0:
            raise NotImplementedError("this driver runs the lazy route only")
        feats = torch.from_numpy(padded).to(self.dev)
        self.planes = LazyPlanes(feats, False, cfg["fsw_lazy_refresh"], -(-n // b), group)
        planes = self.planes
        return lambda order: lazy_distance_epoch(self.model, self.opt, planes, self.dist, order, b)

    def _first_steps(self, order: torch.Tensor) -> None:
        """``train_window``'s checked steps and the rest of epoch 0, the first
        refresh's planes of the checked items, then whole epochs up to the
        next refresh."""
        from kf2vecfsw_tpu_torch.train.step import epoch_order

        super()._first_steps(order)
        items = torch.cat(self.batches)
        self.plane = (self.planes.s.index_select(0, items).double().cpu(),
                      self.planes.g2.index_select(0, items).double().cpu())
        n = self.cfg["subtree_size"]
        self.epoch = 1
        while self.planes.step % self.planes.interval:
            self._set_lr(self.epoch)
            float(self.epoch_fn(epoch_order(self.orders, n).to(self.dev)))
            self.epoch += 1
        if self.dev.type == "cuda":
            self.setup_peak = max(self.setup_peak, torch.cuda.max_memory_allocated(self.dev))

    # -- window --------------------------------------------------------------------

    def window(self, seconds: float) -> None:
        from kf2vecfsw_tpu_torch.train.step import epoch_order
        from kf2vecfsw_tpu_torch.utils import phases

        tr, planes = self.tracer, self.planes
        n = self.cfg["subtree_size"]
        if tr.enabled:
            self._trace_wrappers()
        refreshes0, epoch0 = planes.refreshes, self.epoch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        steps = failed = 0
        with phases.collect() as counters, tr.window():
            t0 = time.perf_counter()
            while True:
                self._set_lr(self.epoch)
                order = epoch_order(self.orders, n).to(self.dev)
                with tr.span("epoch"):
                    loss = self.epoch_fn(order)
                with tr.span("fetch"):
                    loss = float(loss)  # the epoch's one fetch, as the trainer's
                steps += self.n_batches
                failed += 0 if math.isfinite(loss) else self.n_batches
                self.epoch += 1
                if (time.perf_counter() - t0 >= seconds
                        and planes.step % planes.interval == 0):
                    break
        self.window_s = time.perf_counter() - t0
        self.window_peak = (torch.cuda.max_memory_allocated(self.dev)
                            if self.dev.type == "cuda" else 0)
        epochs = self.epoch - epoch0
        self.records.update(
            steps=steps, failed=failed, epochs=epochs, refreshes=planes.refreshes - refreshes0,
            full_batches=epochs * (n // self.cfg["batch_size"]),
            last_batch=n % self.cfg["batch_size"],
            counters={k: int(counters[k]) for k in COUNTERS if k in counters})

    # -- results -------------------------------------------------------------------

    def reference(self, dtype=torch.float64) -> dict:
        """The reference's checked steps from the same point sets, computed
        in ``dtype`` (parameters kept in float32), and the first refresh's
        planes of the checked items."""
        cfg = self.cfg
        lrs = {e: ref_models.step_lr(e, cfg["lr"], cfg["lr_min"], cfg["lr_decay"])
               for e in self.lrs}
        lazy = ref_pergenome.PerGenomeLazy([torch.from_numpy(m) for m in self.mats], self.dev,
                                           dtype)
        out = ref_models.train_steps(self.params0, lazy.embed, self.dist.to(dtype), self.batches,
                                     cfg["lr"], lazy.refresh, dtype)
        planes = [lazy.plane(int(i)) for i in torch.cat(self.batches)]
        out["plane"] = (torch.stack([s for s, _ in planes]).double().cpu(),
                        torch.stack([g for _, g in planes]).double().cpu())
        return {**out, "lrs": lrs}

    def program(self) -> dict:
        return {**super().program(), "plane": self.plane}

    @staticmethod
    def _numbers(prog: dict, ref: dict) -> dict[str, float]:
        out = train_window.Run._numbers(prog, ref)
        out["plane_gap"] = max(compare.rel_norm(p, r) for p, r in zip(prog["plane"], ref["plane"]))
        return out

    def flops(self) -> float:
        """Operations of the window's steps (``train_window``'s count) and of
        its per-genome refreshes, each on every item's real points."""
        r, cfg = self.records, self.cfg
        f = (r["full_batches"] * counts.train_step_flops(cfg, self.vocab, cfg["batch_size"])
             + r["epochs"] * (counts.train_step_flops(cfg, self.vocab, r["last_batch"])
                              if r["last_batch"] else 0))
        points = r["refreshes"] * sum(len(m) for m in self.mats)
        return f + counts_pergenome.refresh_flops(cfg, points)
