"""Exact pairwise L2 distances.

The reference forces torch.cdist's non-matmul path
(compute_mode='donot_use_mm_for_euclid_dist', utils.py:240-247) for numerical
safety near zero. As in the JAX package (``ops/pairwise.py``), distances come
from explicit differences, so identical rows give exactly 0, and rows are
processed in blocks so memory stays at block * M * E floats. ``torch.cdist``
is not used: its default mode goes through a matmul.
"""

from __future__ import annotations

import torch


def _safe_sqrt(sq: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero (sub)gradient at 0, like torch.cdist's backward: the
    diagonal of a self-distance matrix (and any pair of equal rows) is
    exactly 0 and must not poison gradients with sqrt'(0) = inf. The inner
    ``where`` guards the argument, so the backward never evaluates
    sqrt'(0) either."""
    positive = sq > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def pairwise_l2_exact(x: torch.Tensor) -> torch.Tensor:
    """All-pairs exact L2 over rows of x: (B, E) -> (B, B), differentiable
    (the JAX package's ``ops/pairwise.py:pairwise_l2_exact``)."""
    diff = x[:, None, :] - x[None, :, :]
    return _safe_sqrt(torch.sum(diff * diff, dim=-1))


def cdist_exact_blocked(x: torch.Tensor, y: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Exact cdist (N, E) x (M, E) -> (N, M), row-blocked to bound memory at
    block*M*E floats."""
    out = torch.empty((x.shape[0], y.shape[0]), dtype=x.dtype, device=x.device)
    for start in range(0, x.shape[0], block):
        diff = x[start : start + block, None, :] - y[None, :, :]
        out[start : start + block] = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return out


def squared_clamped(dist: torch.Tensor, threshold: float = 1.0e-6) -> torch.Tensor:
    """square + clamp-below-threshold-to-0, matching the APPLES-compat export
    (train_model_set.py:624-628, query.py:171-176)."""
    sq = torch.square(dist)
    return torch.where(sq < threshold, torch.zeros_like(sq), sq)
