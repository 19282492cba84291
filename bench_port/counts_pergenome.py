"""Operations and least times of the per-genome lazy refresh
(``models/fsw.py`` ``fsw_lazy_refresh_pergenome``), counted on the real
points (weight > 0) of the items refreshed; padding is no work a refresh
needs. Every count is linear in the points, so the sum over a refresh's
items is the count of their total.

Per point, for C slices, k bases and ``base_dim``: the point from the
lookup (a one-hot product, 2 k 4 base_dim), its C projections
(2 C k base_dim), the segment sums of its coefficients into the planes
(2 C 4 k) and g2's row sums (2 C). The least time of an item of N points
is the sum of three stages, each at its own bound:
- the point and its projections at ``counts.H100_FP32_FLOPS``;
- one ``sort_rows`` of the C projection rows with one weight row
  (``counts.sort_rows_bound_s``);
- REFRESH_LANE_OPS lane instructions for each coefficient, its
  xi-derivative, g2's and the planes' share included, at LANE_OPS_PER_S
  (``lazy_refresh``'s count, ``PERF.md`` §6).
"""

from __future__ import annotations

from . import counts

REFRESH_LANE_OPS = 120  # lane instructions a coefficient (PERF.md §6, the lazy_refresh bound)
LANE_OPS_PER_S = 3.35e13  # 132 SMs x 128 FP32 lanes x 1.98 GHz (derived, PERF.md §6)


def projection_flops(cfg: dict, points: int) -> int:
    """The points from the lookup and their projections on every slice."""
    k, bd, c = cfg["k"], cfg["base_dim"], cfg["fsw_out_dim"]
    return 2 * points * k * 4 * bd + 2 * c * k * bd * points


def refresh_flops(cfg: dict, points: int) -> int:
    """A refresh's products on ``points`` real points: the FSW layer's on
    those points (``counts.fsw_point_set_flops``, g2's row sums in place of
    E's) and the segment sums into the (C, k, 4) planes."""
    k, c = cfg["k"], cfg["fsw_out_dim"]
    return counts.fsw_point_set_flops(cfg, points) + 2 * c * 4 * k * points


def refresh_least_s(cfg: dict, points: int) -> float:
    """The least time of refreshing items of ``points`` real points in all."""
    c = cfg["fsw_out_dim"]
    return (projection_flops(cfg, points) / counts.H100_FP32_FLOPS
            + counts.sort_rows_bound_s(c, points, 1)
            + REFRESH_LANE_OPS * c * points / LANE_OPS_PER_S)
