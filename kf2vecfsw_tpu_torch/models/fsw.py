"""Fourier Sliced-Wasserstein (FSW) embedding and distance model: the forward
half of the JAX package's ``models/fsw.py`` (NeuralNetFSW, reference
models.py:51-68).

A learnable (4, base_dim) lookup maps each k-mer of a (N, k+1) point-set
matrix from get_kmers to a point in R^{k*base_dim}; the weighted point set
is embedded by the FSW layer, and a two-layer MLP maps the embedding to the
output. For slice direction v_c and frequency xi_c, the projections
p_j = <v_c, x_j> are sorted with their normalized weights, and

    E_c = sum_i p_(i) * sqrt(2) w_(i) cos(pi xi_c cbar_i) sinc(xi_c w_(i) / 2)

where cbar_i is the midpoint of the i-th cumulative-weight step and sinc is
the normalized sinc. Zero-weight (padding) points leave E unchanged.

The sort is ``kernels.sort.sort_rows``: the hand-written CUDA kernel on the
card, its plain version on the CPU. The weights are passed once per genome
and gathered by the kernel for each of the genome's slice rows. The cumsum,
the cos/sinc coefficients and the row sums stay torch ops: the JAX
package's ``_cumsum_minor_matmul`` is a workaround for the TPU's matrix unit
and ``torch.cumsum`` in fp32 computes the same prefix sums. The shared-vocab
and lazy paths serve only the trainers and arrive with the training slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.sort import f2i_keys, i2f_keys, sort_rows  # noqa: F401  (the JAX module's names)
from ..utils.membudget import hbm_fraction
from .mlp import init_params_

_SQRT2 = math.sqrt(2.0)


@torch.no_grad()
def init_fsw_params_(slices: torch.Tensor, freqs: torch.Tensor,
                     generator: torch.Generator) -> None:
    """Slices (d_out, d_in) as stacked orthonormal blocks (rows of the Q of
    a Gaussian d_in x d_in matrix) and even frequencies 0..d_out-1, in
    place (the JAX package's ``init_fsw_params``). The generator must live
    on the tensors' device."""
    d_out, d_in = slices.shape
    for start in range(0, d_out, d_in):
        g = torch.randn(d_in, d_in, generator=generator, device=slices.device)
        q, _ = torch.linalg.qr(g)
        slices[start : start + d_in] = q[: min(d_out - start, d_in)]
    freqs.copy_(torch.arange(d_out, dtype=freqs.dtype, device=freqs.device))


def fsw_embed(slices: torch.Tensor, freqs: torch.Tensor, points: torch.Tensor,
              weights: torch.Tensor, slice_chunk: int = 0) -> torch.Tensor:
    """FSW embeddings (B, C) of B weighted point sets: points (B, N, d_in),
    weights (B, N) nonnegative (zeros = padding). slice_chunk > 0 bounds the
    sort's transients to that many slices at a time; 0 sorts all C slices
    of the batch in one call."""
    b, n, _ = points.shape
    d_out = slices.shape[0]
    total = torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-30)
    wn = (weights / total).contiguous()
    chunk = d_out if slice_chunk <= 0 else slice_chunk
    out = []
    for c0 in range(0, d_out, chunk):
        v, xi = slices[c0 : c0 + chunk], freqs[c0 : c0 + chunk]
        c = v.shape[0]
        p = torch.einsum("cd,bnd->bcn", v, points).reshape(b * c, n).contiguous()
        ps, ws, _ = sort_rows(p, wn)  # row b*c + j carries wn[b]
        ps, ws = ps.view(b, c, n), ws.view(b, c, n)
        cbar = torch.cumsum(ws, dim=-1) - ws / 2.0
        x = xi[None, :, None]
        delta = _SQRT2 * ws * torch.cos(math.pi * x * cbar) * torch.sinc(x * ws / 2.0)
        out.append(torch.sum(ps * delta, dim=-1))
    return torch.cat(out, dim=1)


def fsw_sort_budget_bytes(device: str | torch.device) -> int:
    """Transient budget of the batched FSW sort: 1/8 of the device memory."""
    return hbm_fraction(1, 8, device)


def auto_slice_chunk(b: int, n: int, d_out: int, device: str | torch.device) -> int:
    """The largest power-of-two slice chunk (at least 8) whose four
    (B, chunk, N) f32 sort transients fit ``fsw_sort_budget_bytes``; 0 when
    all d_out slices fit (the JAX package's ``_auto_slice_chunk``)."""
    per_slice = 4 * b * n * 4
    chunk = max(8, fsw_sort_budget_bytes(device) // max(per_slice, 1))
    if chunk >= d_out:
        return 0
    p = 8
    while p * 2 <= chunk:
        p *= 2
    return p


class FSWDistEmbed(nn.Module):
    """NeuralNetFSW: lookup -> FSW layer -> Linear -> ReLU -> Linear."""

    def __init__(self, k: int, base_dim: int, d_out: int, hidden_size: int, embedding_size: int):
        super().__init__()
        self.lookup = nn.Parameter(torch.zeros(4, base_dim))
        self.slices = nn.Parameter(torch.zeros(d_out, k * base_dim))
        self.freqs = nn.Parameter(torch.zeros(d_out))
        self.fc1 = nn.Linear(d_out, hidden_size)
        self.fc2 = nn.Linear(hidden_size, embedding_size)

    def forward(self, x: torch.Tensor, slice_chunk: int | None = None) -> torch.Tensor:
        """x: (B, N, k+1) — reference-coded bases (A=0,T=1,C=2,G=3) in the
        first k columns, frequency weight in the last (the JAX package's
        ``fsw_dist_embed_apply``). slice_chunk=None picks
        ``auto_slice_chunk`` for x's device."""
        kmers = x[..., :-1].long()
        weights = x[..., -1]
        b, n, _ = kmers.shape
        points = self.lookup[kmers].reshape(b, n, -1)
        if slice_chunk is None:
            slice_chunk = auto_slice_chunk(b, n, self.slices.shape[0], x.device)
        e = fsw_embed(self.slices, self.freqs, points, weights, slice_chunk)
        return self.fc2(F.relu(self.fc1(e)))


@torch.no_grad()
def init_fsw_dist_embed_(module: FSWDistEmbed, generator: torch.Generator) -> FSWDistEmbed:
    """Draw every parameter from ``generator`` (on the module's device): the
    lookup standard normal, the FSW slices and freqs as
    ``init_fsw_params_``, the Linear layers with torch.nn.Linear's bounds
    (the JAX package's ``init_fsw_dist_embed``)."""
    module.lookup.normal_(generator=generator)
    init_fsw_params_(module.slices, module.freqs, generator)
    return init_params_(module, generator)
