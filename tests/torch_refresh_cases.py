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
card's machine has none."""

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
        w = wn[i].double()[perm]  # (C, V), each slice's sorted order
        cbar = torch.cumsum(w, dim=-1) - w / 2
        u = xi * w / 2
        phase = math.pi * xi * cbar
        sinc = torch.sinc(u)
        delta = math.sqrt(2) * w * torch.cos(phase) * sinc
        ddelta = math.sqrt(2) * w * (-math.pi * cbar * torch.sin(phase) * sinc
                                     + torch.cos(phase) * _sinc_slope(u) * w / 2)
        g2[i] = (ps64 * ddelta).sum(-1)
        for j in range(k):
            s[i, :, j] = torch.zeros(c, 4, dtype=torch.float64, device=ps.device).scatter_add_(
                1, sorted_digits[:, :, j], delta)
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
