"""Inputs and a float64 reference for the shared lazy refresh's planes
(``kernels.refresh.refresh_planes``), shared by the CPU tests and the card's.

``planes_float64`` is written from the formulas, not from the port's
functions: per item, along each slice's sorted order p,
    cbar_p = sum_{q <= p} w_q - w_p / 2,  u = xi w_p / 2,
    delta_p = sqrt(2) w_p cos(pi xi cbar_p) sinc(u),
    d delta_p / d xi = sqrt(2) w_p [-pi cbar_p sin(pi xi cbar_p) sinc(u)
                                    + cos(pi xi cbar_p) sinc'(u) w_p / 2],
with sinc'(u) = (cos(pi u) - sinc(u)) / u in closed form and, for
|u| < 1e-2, from its series; g2 = sum_p ps_p d delta_p / d xi and
S[j, a] = sum_p delta_p [digit j of the column at p == a]. No JAX here: the
card's machine has none.

The per-genome route's planes (``kernels.refresh.pergenome_planes``) take
the same formulas over each (item, slice) row of a sort whose weights are
each item's own: ``pergenome_inputs`` and ``pergenome_planes_float64``."""

import math

import torch

from kf2vecfsw_tpu_torch.kernels.sort import sort_rows
from kf2vecfsw_tpu_torch.models import fsw


def refresh_inputs(k: int, c: int, n: int, seed: int, device, vocab: int | None = None):
    """(ps, perm, wn, freqs, digits) of a shared refresh: the canonical vocab
    at k (or ``vocab`` entries of random digits), c slices, n items. Item 0
    draws uniform weights with about 20% absent k-mers, item 1 (when n > 2)
    holds a third of its mass on three k-mers (u = xi w / 2 far past the
    sinc's series), the last item is all zero, the rest as item 0; the
    frequencies are the initial 0..c-1."""
    gen = torch.Generator().manual_seed(seed)
    if vocab is None:
        digits = fsw.vocab_digits(k, torch.device("cpu"))
    else:
        digits = torch.randint(0, 4, (vocab, k), generator=gen)
    v = digits.shape[0]
    w = torch.rand(n, v, generator=gen)
    w[w < 0.2] = 0.0
    if n > 2:
        w[1, :3] = w[1].sum() / 6.0
    w[-1] = 0.0
    wn = fsw._normalized(w)
    keys = torch.randn(c, v, generator=gen)
    freqs = torch.arange(c, dtype=torch.float32)
    wn, keys, freqs, digits = (t.to(device) for t in (wn, keys, freqs, digits))
    ps, _, perm = sort_rows(keys, wn[:1])
    return ps, perm, wn, freqs, digits.contiguous()


def _sinc_slope(u: torch.Tensor) -> torch.Tensor:
    pu = math.pi * u
    z = pu * pu
    series = -(math.pi * pu / 3) * (
        1 - z * (1 / 10 - z * (1 / 280 - z * (1 / 15120 - z / 1330560))))
    small = u.abs() < 1e-2
    closed = (torch.cos(pu) - torch.sinc(u)) / torch.where(small, torch.ones_like(u), u)
    return torch.where(small, series, closed)


def _coefficients64(w: torch.Tensor, xi: torch.Tensor):
    """delta and d delta / d xi in float64 of sorted weight rows w (..., N)
    and their frequencies xi, broadcast against them."""
    cbar = torch.cumsum(w, dim=-1) - w / 2
    u = xi * w / 2
    phase = math.pi * xi * cbar
    sinc = torch.sinc(u)
    delta = math.sqrt(2) * w * torch.cos(phase) * sinc
    ddelta = math.sqrt(2) * w * (-math.pi * cbar * torch.sin(phase) * sinc
                                 + torch.cos(phase) * _sinc_slope(u) * w / 2)
    return delta, ddelta


def planes_float64(ps, perm, wn, freqs, digits):
    """(S (n, C, k, 4), g2 (n, C)) in float64, one item at a time."""
    n = wn.shape[0]
    c, k = ps.shape[0], digits.shape[1]
    ps64, xi = ps.double(), freqs.double()[:, None]
    perm = perm.long()
    sorted_digits = digits[perm]  # (C, V, k): the bases at each sorted position
    s = torch.empty(n, c, k, 4, dtype=torch.float64, device=ps.device)
    g2 = torch.empty(n, c, dtype=torch.float64, device=ps.device)
    for i in range(n):
        delta, ddelta = _coefficients64(wn[i].double()[perm], xi)  # each slice's sorted order
        g2[i] = (ps64 * ddelta).sum(-1)
        for j in range(k):
            s[i, :, j] = torch.zeros(c, 4, dtype=torch.float64, device=ps.device).scatter_add_(
                1, sorted_digits[:, :, j], delta)
    return s, g2


def pergenome_inputs(g: int, c: int, n: int, k: int, seed: int, device, real: int | None = None):
    """(ps, ws, perm, digits, freqs) of a per-genome refresh group: g items
    of n points each (``real`` of them with weights, the rest zero-weight
    padding rows of digits 0, as ``train.distance.pad_point_sets`` pads),
    random bases, c slices, keys drawn at random (the padding rows' equal,
    being one point) and sorted by ``sort_rows`` with the items' normalised
    weight rows. Item 1 (when g > 2) holds a
    third of its mass on three points (u = xi w / 2 past the sinc's series),
    the last item (when g > 1) is all padding; the frequencies are the
    initial 0..c-1."""
    gen = torch.Generator().manual_seed(seed)
    real = n if real is None else real
    digits = torch.randint(0, 4, (g, n, k), generator=gen)
    w = torch.rand(g, n, generator=gen)
    keys = torch.randn(g * c, n, generator=gen)
    if g > 2 and real >= 3:
        w[1, :3] = w[1].sum() / 6.0
    digits[:, real:], w[:, real:] = 0, 0.0
    keys[:, real:] = keys[:, :1]  # the padding rows are one point: they sort together
    if g > 1:
        digits[-1], w[-1] = 0, 0.0
        keys[-c:] = keys[-c:, :1]
    freqs = torch.arange(c, dtype=torch.float32)
    w, keys, freqs, digits = (t.to(device) for t in (w, keys, freqs, digits))
    ps, ws, perm = sort_rows(keys, fsw._normalized(w))
    return ps, ws, perm, digits.contiguous(), freqs


def pergenome_planes_float64(ps, ws, perm, digits, freqs):
    """(S (G, C, k, 4), g2 (G, C)) in float64, one item and one base at a
    time (the card's cases reach 512 x 646,000)."""
    g, n, k = digits.shape
    c = freqs.shape[0]
    xi = freqs.double()[:, None]
    s = torch.empty(g, c, k, 4, dtype=torch.float64, device=ps.device)
    g2 = torch.empty(g, c, dtype=torch.float64, device=ps.device)
    for i in range(g):
        rows = slice(i * c, (i + 1) * c)
        delta, ddelta = _coefficients64(ws[rows].double(), xi)
        g2[i] = (ps[rows].double() * ddelta).sum(-1)
        del ddelta
        cols = perm[rows].long()
        for j in range(k):
            s[i, :, j] = torch.zeros(c, 4, dtype=torch.float64, device=ps.device).scatter_add_(
                1, digits[i, :, j][cols], delta)
    return s, g2


def plane_tolerance(c: int) -> float:
    """Relative (norm) error allowed against float64 for an item's planes:
    the float32 prefix sums and the phase's product round, and the phase
    pi xi cbar multiplies that by xi, up to C - 1. On the CPU the plain
    version reads 6e-7 at C = 16, 2.8e-6 at 128 and 8.3e-6 at 512 (torch
    sums the prefix in double there); on an H100 the kernel reads 5.7e-7 at
    C = 16 and 9.7e-6 at 512 (its prefix compensated), under a sixth of
    this, and the plain version up to 6.8e-5 at 512 (torch's float32 scan),
    which the kernel is held to within twice this."""
    return 1e-5 + 1e-7 * c


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Norm of the difference over the norm of ``want``."""
    return (torch.linalg.vector_norm(got.double() - want.double())
            / torch.linalg.vector_norm(want.double())).item()
