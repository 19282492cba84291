"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the reference works out from the same inputs.

Each cell's limits are in ``limits/<cell>.json``; ``PERF.md`` gives the
readings each limit was set from. A number that is not finite fails.
"""

from __future__ import annotations

import math

import torch

DEAD_LEAF = 1e-3  # a leaf whose reference gradient is under this share of the median's


def loss_gap(prog: list[float], ref: list[float]) -> float:
    """The largest gap of a step's loss, relative to the reference's."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def _norms(leaves: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def _median(values: list[float]) -> float:
    s = sorted(values)
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2


def live_leaves(ref_grad: dict[str, torch.Tensor]) -> list[str]:
    """Leaves whose reference gradient is not nought to rounding: at least
    DEAD_LEAF of the median leaf's norm (a bias that the loss cancels, as
    the output layer's under a loss of differences, moves under Adam by
    round-off alone)."""
    norms = _norms(ref_grad)
    med = _median(list(norms.values()))
    return [k for k, n in norms.items() if n >= DEAD_LEAF * med]


def live_entries(ref_grad: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Of each live leaf, the entries whose reference gradient is at least
    DEAD_LEAF of the median leaf's root mean square: the same rule on single
    entries. A hidden unit that is on for every row of a batch gets a bias
    gradient of exactly 0 under a loss of differences (the embeddings'
    gradients sum to 0 over the batch), which Adam's first steps turn into
    full steps of either sign from the round-off alone."""
    norms = _norms(ref_grad)
    med_leaf = min(norms, key=lambda k: abs(norms[k] - _median(list(norms.values()))))
    rms = norms[med_leaf] / math.sqrt(ref_grad[med_leaf].numel())
    return {k: ref_grad[k].abs() >= DEAD_LEAF * rms for k in live_leaves(ref_grad)}


def leaf_gaps(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
              leaves: list[str]) -> dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    pn, rn = _norms({k: prog[k] for k in leaves}), _norms({k: ref[k] for k in leaves})
    med = _median(list(rn.values()))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in leaves}


def norm_gap(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
             leaves: list[str]) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, leaves).values())


def max_rel(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest gap of any entry, over the largest reference entry."""
    prog, ref = prog.double(), ref.double()
    if prog.shape != ref.shape:
        return math.inf
    scale = float(ref.abs().max()) or 1.0
    return float((prog - ref).abs().max()) / scale


def rel_norm(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The norm of the difference over the reference's norm."""
    prog, ref = prog.double(), ref.double()
    if prog.shape != ref.shape:
        return math.inf
    return float(torch.linalg.vector_norm(prog - ref) / torch.linalg.vector_norm(ref))


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every number finite and within its limit, the numbers beside their
    limits)."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, checks
