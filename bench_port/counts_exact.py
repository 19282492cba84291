"""Operations of an exact FSW training step (``-fsw_lazy_refresh 0``),
counted from shapes as ``counts`` counts them: the FSW layer's forward,
the head and the pairwise distances, and a backward of twice the forward's
products, so three times the forward in all.

The FSW layer is counted on the points a step needs: per genome the
items' real points (weight > 0; padding is no work), whose count is linear
in the points, so an epoch's is that of every item's points once; on the
shared route the vocabulary's points and projections once a batch and E's
sums for each item. A slice chunk's recompute in the backward is the
program's way to bound its memory, not the step's work, and is not
counted.
"""

from __future__ import annotations

from . import counts


def pergenome_points_flops(cfg: dict, points: int) -> int:
    """The FSW layer's share of exact per-genome steps whose items hold
    ``points`` real points in all (``counts.fsw_point_set_flops``)."""
    return 3 * counts.fsw_point_set_flops(cfg, points)


def pergenome_batch_flops(cfg: dict, rows: int) -> int:
    """The head's and the pairwise distances' share of one step on
    ``rows`` items."""
    return 3 * (counts.fsw_head_flops(cfg, rows)
                + counts.pairwise_flops(rows, cfg["embedding_size"]))


def pergenome_step_flops(cfg: dict, rows: int, points: int) -> int:
    """One exact per-genome step on ``rows`` items of ``points`` real points."""
    return pergenome_points_flops(cfg, points) + pergenome_batch_flops(cfg, rows)


def shared_step_flops(cfg: dict, vocab: int, rows: int) -> int:
    """One exact shared-vocab step on ``rows`` items: the vocab's points and
    projections once, E's sums over the vocab for every item, the head and
    the pairwise distances."""
    c = cfg["fsw_out_dim"]
    fsw = counts.fsw_point_set_flops(cfg, vocab) + (rows - 1) * 2 * c * vocab
    return 3 * (fsw + counts.fsw_head_flops(cfg, rows)
                + counts.pairwise_flops(rows, cfg["embedding_size"]))
