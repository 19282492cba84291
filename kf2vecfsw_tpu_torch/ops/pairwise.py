"""Exact pairwise L2 distances.

The reference forces torch.cdist's non-matmul path
(compute_mode='donot_use_mm_for_euclid_dist', utils.py:240-247) for numerical
safety near zero. As in the JAX package (``ops/pairwise.py``), distances come
from explicit differences, so identical rows give exactly 0, and rows are
processed in blocks so memory stays at block * M * E floats.
"""

from __future__ import annotations

import torch


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
