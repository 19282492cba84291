"""The lazy sort-refresh route of the FSW distance trainer (the JAX package's
``train/fsw_lazy.py``).

Instead of sorting the projections at every step, a refresh freezes the
sort order and precomputes, for every training item, the compact plane S
(n, C, k, 4) and the frequencies' gradient matrix g2 (n, C)
(``models/fsw.py``: ``fsw_lazy_refresh`` for shared-vocab weights,
``fsw_lazy_refresh_pergenome`` for padded point sets). A step gathers its
batch's rows and runs ``fsw_lazy_apply``: two small einsums and the MLP.
Between refreshes the model trains on the exact FSW of a slightly stale
order; at a refresh step value and gradient are the exact forward's, so
refresh_steps=1 is the exact route.

Cadence. With R refresh steps and n_batches = ceil(n/B) real batch steps
an epoch, a run refreshes before its first step (a resumed run too), then
every R steps when R < n_batches, else every R // n_batches epochs; the
steps are counted from the start of the run, and nothing else (a
``-test_set``, ``-save_interval``, an autosave) moves a refresh. That is the
flag's promise, "re-sort ... every N steps". The JAX runner refreshes on
another cadence in three cases, each an effect of its bucket padding or of
its device spans, TPU artefacts that the port does not port; so the port
keeps the real-step cadence rather than imitate them:
1. it counts the bucket's padded batches, ceil(bucket_items(n) / B)
   (kf2vecfsw_tpu/train/step.py:225-228): at n = 670 and B = 16 its epoch
   is 47 steps and the port's 42, so at R = 128 it refreshes every 2
   epochs and the port every 3;
2. with a ``-test_set`` it runs one epoch a call and refreshes once the
   plane has aged R steps, every ceil(R / n_batches) epochs, and for
   R < n_batches it counts the steps from each epoch's start
   (kf2vecfsw_tpu/train/fsw_lazy.py:333-368);
3. it refreshes at the start of every device span, and snaps the epoch
   interval to a divisor of the span (kf2vecfsw_tpu/train/fsw_lazy.py:
   410-417); spans are 512, 64, 8 or 1 epochs long and end at autosave and
   ``-save_interval`` epochs (kf2vecfsw_tpu/train/distance.py:513-518,
   kf2vecfsw_tpu/train/step.py:181-197).
``tests/test_torch_fsw_epochs.py`` pins the port's count beside the JAX
runner's in each case.

Memory: S is a few MB at any k, so the gate is the refresh's transients
for a group of G items (``refresh_transient_bytes``); ``pick_refresh_group``
halves G from 8 until they fit 3/8 of the device memory, and the route is
off (``lazy_applicable``) when not even G = 1 fits. Each route counts its
worst stage as the port's plain torch ops run it. On the shared route
(``shared_refresh_bytes``) the forward-mode pass for d delta / d xi holds
14 f32 buffers of the group's (G, C, V) rows, and 16 in every group after
the first, whose delta and d delta / d xi are still held; the JAX package's
(3G + 4) buffers of (C, V) count a third of that. On the card the shared
route's planes come from one kernel (``kernels.refresh.refresh_planes``)
that holds no (G, C, V) buffer, so there the count is an upper bound and
the gate admits the same clades as before. On the per-genome route
(``pergenome_refresh_bytes``) the same pass holds 16 f32 buffers of the
group's (G*C, N) rows, which outweighs the sort's outputs and, past
``CLUSTER_ELEMS``, its radix scratch. On the card the per-genome planes
come from a kernel of their own (``kernels.refresh.pergenome_planes``) that
holds nothing of size (G*C, N) beyond the sort's outputs, so there the
worst stage is the sort's and the count is an upper bound too: the gate
admits the same clades with the same G as the plain route's count does. On
a grid with a model axis C is the rank's d_out / n_model slices: each rank
refreshes the planes of its own slices
(``kf2vecfsw_tpu/train/fsw_lazy.py:87-114,147-190``), so a refresh too
large for one card may fit on a grid.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.sort import sort_transient_bytes
from ..kmer.vocab import canonical_vocab_size
from ..models.fsw import (
    FSWDistEmbed,
    fsw_lazy_apply,
    fsw_lazy_refresh,
    fsw_lazy_refresh_pergenome,
    lookup_points,
    vocab_digits,
)
from ..parallel.mesh import DataMesh
from ..utils.membudget import hbm_fraction
from ..utils.phases import count, phase
from .step import distance_steps

# items per refresh group; halved until one group's transients fit
REFRESH_GROUP = 8


def fsw_lazy_budget_bytes(device: str | torch.device) -> int:
    """Budget of one refresh group's transients: 3/8 of the device memory."""
    return hbm_fraction(3, 8, device)


def pergenome_refresh_bytes(d_out: int, n: int, group: int, k: int, base_dim: int) -> int:
    """The live set of the worst stage of one group of ``fsw_lazy_refresh_
    pergenome`` in plain torch ops (its CPU path; on the card, where the
    planes' kernel runs, an upper bound): G point sets of N k-mers, d_out
    slices. Its int64 digits (G, N, k) live through every stage; beside
    them, at most:
    - the points: the (G, N, k, 4) one-hot in int64 and in f32, then the
      (G, N, k * base_dim) points beside the f32 one-hot;
    - the projections: the points and the (G*C, N) product, twice while the
      product is copied row-major;
    - the sort: its keys and weight rows, its outputs and, past
      ``CLUSTER_ELEMS``, its radix scratch (``sort_transient_bytes``);
    - delta and d delta / d xi by ``torch.func.jvp``: 16 f32 buffers of
      (G*C, N), the sorted projections, weights and perm among them (the
      forward-mode pass through the sinc is the peak);
    - the unsort and the segment sum: delta, perm in int32 and in int64,
      the unsorted delta, and the one-hot in int64 and in f32."""
    e = 4 * group * d_out * n  # bytes of one f32 buffer of the group's rows
    gnk = group * n * k
    digits = 8 * gnk
    stages = (
        digits + max(48 * gnk, 16 * gnk + 4 * gnk * base_dim),
        digits + 4 * gnk * base_dim + 2 * e,
        digits + e + 4 * group * n + sort_transient_bytes(group * d_out, n, group),
        digits + 16 * e,
        digits + 5 * e + 48 * gnk,
    )
    return max(stages)


def shared_refresh_bytes(d_out: int, vocab: int, group: int, items: int) -> int:
    """The live set of the worst stage of one group of ``fsw_lazy_refresh``
    in plain torch ops (its CPU path; on the card, where the planes' kernel
    runs, an upper bound): ``items`` (n) weight rows over a canonical vocab
    of V k-mers, d_out slices, groups of G. Through every group it holds
    the normalised weights wn (n, V), the sorted projections ps and the
    sort's payload output (C, V) in f32, perm (C, V) in int64 and the
    (V, 4k) one-hot in f32; beside them, at most:
    - the sort: its (C, V) keys and what it allocates (``sort_transient_
      bytes``);
    - perm in int32 and in int64, while one is cast to the other;
    - the one-hot in int64 and in f32;
    - delta and d delta / d xi by ``torch.func.jvp``: the gathered (G, C, V)
      weights wsb and 13 f32 buffers of (G, C, V) for the primals and
      tangents through ``quantile_coefficients`` (the cos beside the sinc's
      is the peak), and in every group after the first the last group's
      delta and d delta / d xi, still bound while the next is computed, and
      the earlier groups' S and g2 rows, 4 (4k + 1) C B an item (at most
      n - G items precede a full group; a shorter last group's jvp is
      smaller by far more than its extra rows);
    - the row sums for g2 and the unsort, 4 buffers of (G, C, V) at most.
    k is the smallest whose canonical vocab holds V (exact for the vocabs
    the shared route runs on)."""
    k = 1
    while canonical_vocab_size(k) < vocab:
        k += 1
    g = min(group, items)
    e = 4 * g * d_out * vocab  # bytes of one f32 buffer of the group's rows
    cv = 4 * d_out * vocab
    wn = 4 * items * vocab
    onehot = 16 * k * vocab
    held = wn + 4 * cv + onehot
    stages = (
        wn + cv + sort_transient_bytes(d_out, vocab, 1),  # the sort
        wn + 5 * cv,  # perm cast to int64
        wn + 4 * cv + 32 * k * vocab + onehot,  # the one-hot cast to f32
        held + 4 * (items - g) * d_out * (4 * k + 1) + (16 if items > group else 14) * e,  # the jvp
    )
    return max(stages)


def refresh_transient_bytes(d_out: int, vocab: int, group: int,
                            points: tuple[int, int] | None = None,
                            items: int | None = None) -> int:
    """The worst-stage live set of one refresh group. On the shared route
    (``points`` None) ``shared_refresh_bytes`` of ``items`` training items;
    on the per-genome route, ``points`` = (k, base_dim) of the point sets
    and ``vocab`` their padded length N, ``pergenome_refresh_bytes``."""
    if points is not None:
        return pergenome_refresh_bytes(d_out, vocab, group, *points)
    if items is None:
        raise ValueError("the shared route's refresh count needs the number of items")
    return shared_refresh_bytes(d_out, vocab, group, items)


def pick_refresh_group(d_out: int, vocab: int, device: str | torch.device,
                       n_model: int = 1, points: tuple[int, int] | None = None,
                       items: int | None = None) -> int:
    """The largest group (<= REFRESH_GROUP, halving) whose transients over
    the rank's ceil(d_out / n_model) slices fit ``fsw_lazy_budget_bytes``;
    0 when not even one item's fit. ``points`` and ``items`` as
    ``refresh_transient_bytes``: the shared route (``points`` None) needs
    ``items``, the per-genome one (``points`` = (k, base_dim)) not."""
    d_local = -(-d_out // max(n_model, 1))
    g = REFRESH_GROUP
    while g >= 1:
        if refresh_transient_bytes(d_local, vocab, g, points, items) <= fsw_lazy_budget_bytes(device):
            return g
        g //= 2
    return 0


def lazy_applicable(d_out: int, vocab: int, device: str | torch.device, n_model: int = 1,
                    points: tuple[int, int] | None = None, items: int | None = None) -> bool:
    """Whether the lazy route fits: one item's refresh transients within the
    budget (``vocab`` is the features' minor length, V or N; ``points`` and
    ``items`` as ``refresh_transient_bytes``)."""
    return pick_refresh_group(d_out, vocab, device, n_model, points, items) > 0


class LazyPlanes:
    """S and g2 of every training item, refreshed on the model's current
    params before every ``interval``-th batch step of the run (see the
    module docstring): ``interval`` is R when R < n_batches, else
    (R // n_batches) * n_batches, so a refresh falls on an epoch's first
    step. ``feats`` are the train rows: (n, V) vocab weights when
    ``shared``, else (n, N, k+1) point sets.

    Every refresh counts into the active ``utils.phases`` collector
    ``fsw.refresh.items``, the items refreshed, and on the per-genome route
    ``fsw.refresh.points``, their real points (weight > 0), and
    ``fsw.refresh.slots``, the padded slots sorted (items x N). The real
    points are counted once, here."""

    def __init__(self, feats: torch.Tensor, shared: bool, refresh_steps: int, n_batches: int,
                 group: int):
        self.feats, self.shared, self.group = feats, shared, group
        self.points = None if shared else int((feats[..., -1] > 0).sum())
        r = max(1, refresh_steps)
        self.interval = r if r < n_batches else (r // n_batches) * n_batches
        self.step = 0  # batch steps since the start of the run
        self.refreshes = 0
        self.s = self.g2 = None

    def refresh(self, model: FSWDistEmbed) -> None:
        """New planes on the model's current params; the span
        ``fsw.refresh`` carries the run's step number that it precedes."""
        with phase("fsw.refresh", str(self.step)):
            if self.shared:
                digits = vocab_digits(model.k, self.feats.device)
                with torch.no_grad():
                    points = lookup_points(model.lookup, digits)
                self.s, self.g2 = fsw_lazy_refresh(model.slices, model.freqs, points, digits,
                                                   self.feats, self.group)
            else:
                self.s, self.g2 = fsw_lazy_refresh_pergenome(model.slices, model.freqs,
                                                             model.lookup, self.feats, self.group)
        count("fsw.refresh.items", self.feats.shape[0])
        if not self.shared:
            count("fsw.refresh.points", self.points)
            count("fsw.refresh.slots", self.feats.shape[0] * self.feats.shape[1])
        self.refreshes += 1

    def tick(self, model: FSWDistEmbed) -> None:
        """Before every batch step (on every rank): refresh when it is due."""
        if self.step % self.interval == 0:
            self.refresh(model)
        self.step += 1

    def rows(self, idx: torch.Tensor):
        """(S, g2) rows of ``idx``."""
        return self.s.index_select(0, idx), self.g2.index_select(0, idx)


def lazy_distance_epoch(model: nn.Module, opt: torch.optim.Optimizer, planes: LazyPlanes,
                        dist: torch.Tensor, order: torch.Tensor, batch_size: int,
                        weight_offset: float = 1e-6, mesh: DataMesh | None = None) -> torch.Tensor:
    """One epoch of the distance trainer on the lazy route; returns the epoch
    loss as a device scalar. Over ranks every rank refreshes the planes of
    every item for its own slices (all of them without a model axis, as the
    JAX package's data-only mesh does) and embeds its rows of each batch."""
    return distance_steps(lambda idx: fsw_lazy_apply(model, *planes.rows(idx)), model, opt, dist,
                          order, batch_size, weight_offset, mesh, lambda: planes.tick(model))
