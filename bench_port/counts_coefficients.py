"""Least times of the exact forwards' coefficient kernels
(``kernels/refresh.py`` ``exact_coefficients`` and its shared and backward
entry points, ``csrc/lazy_refresh.cu``) from the coefficients the program
counts (``models/fsw.py``: ``fsw.exact.coefficients.forward`` and
``.backward``, a chunk's recompute in the forward's), at the bounds of
``PERF.md`` §6:

- shared vocab (``exact_shared_kernel``): lane work, SHARED_FORWARD_LANE_OPS
  lane instructions a coefficient forward (delta alone, its share of E's
  sums included) and SHARED_BACKWARD_LANE_OPS backward (delta and its
  xi-derivative, d_ps and d xi's sums), at ``counts_pergenome.LANE_OPS_PER_S``;
- per genome (``exact_rows_kernel`` with its tile sums): bytes,
  PERGENOME_BYTES a position each way (forward: ps and ws, ws again for
  the tile sums; backward: ws and ps read, d_ps written), at
  ``counts.H100_BYTES_PER_S``.
"""

from __future__ import annotations

from . import counts, counts_pergenome

SHARED_FORWARD_LANE_OPS = 60
SHARED_BACKWARD_LANE_OPS = 120
PERGENOME_BYTES = 12


def shared_least_s(forward: int, backward: int) -> float:
    """The least time of the shared route's ``forward`` and ``backward``
    coefficients."""
    return ((SHARED_FORWARD_LANE_OPS * forward + SHARED_BACKWARD_LANE_OPS * backward)
            / counts_pergenome.LANE_OPS_PER_S)


def pergenome_least_s(forward: int, backward: int) -> float:
    """The least time of the per-genome route's ``forward`` and ``backward``
    positions."""
    return PERGENOME_BYTES * (forward + backward) / counts.H100_BYTES_PER_S
