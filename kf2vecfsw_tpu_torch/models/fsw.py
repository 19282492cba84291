"""Fourier Sliced-Wasserstein (FSW) embedding and distance model (the JAX
package's ``models/fsw.py``; NeuralNetFSW, reference models.py:51-68).

A learnable (4, base_dim) lookup maps each k-mer of a (N, k+1) point-set
matrix from get_kmers to a point in R^{k*base_dim}; the weighted point set
is embedded by the FSW layer, and a two-layer MLP maps the embedding to the
output. For slice direction v_c and frequency xi_c, the projections
p_j = <v_c, x_j> are sorted with their normalized weights, and

    E_c = sum_i p_(i) * sqrt(2) w_(i) cos(pi xi_c cbar_i) sinc(xi_c w_(i) / 2)

where cbar_i is the midpoint of the i-th cumulative-weight step and sinc is
the normalized sinc. Zero-weight (padding) points leave E unchanged.

The sort is ``kernels.sort.sort_rows``: the hand-written CUDA kernel on the
card, its plain version on the CPU. ``SortPW`` and ``SortShared`` put it
under autograd: the gradient reaches the projections (and so the slices and
the lookup) through the transpose of the permutation, an unsort by the
kernel's ``perm``; the weights are data and get none. The port's sort is
stable, so ``perm`` and the sorted weights always come from one sort. The
cumsum, the cos/sinc coefficients and the row sums stay torch ops: the JAX
package's ``_cumsum_minor_matmul`` is a workaround for the TPU's matrix unit
and ``torch.cumsum`` in fp32 computes the same prefix sums.

Three forwards train the model:
- per genome (``fsw_embed``, ``FSWDistEmbed.forward`` on (B, N, k+1) point
  sets): one sort of the B*C projection rows;
- shared vocab (``fsw_embed_shared``, ``forward_shared`` on (B, V) weights
  over the canonical vocab): the points are the vocab's, the same for every
  genome, so one sort of the C rows serves the batch;
- lazy (``fsw_lazy_refresh`` / ``fsw_lazy_refresh_pergenome`` then
  ``fsw_lazy_apply``): the sort order is frozen at a refresh. Everything the
  sort produces besides the order depends on data only, so the per-point
  coefficient delta is fixed between refreshes; since every point is a
  concatenation of lookup rows, E[i,c] = sum_{j,a} S[i,c,j,a] <v_c[j],
  lookup[a]> with S the coefficients summed over the points whose j-th base
  is a: an (n, C, k, 4) plane, whatever the vocab. The frequencies train
  through (xi - xi.detach()) * g2, zero in value, where g2 = dE/dxi at the
  refresh. At a fresh order the value and every gradient equal the exact
  forward's.

On a grid with a model axis (``parallel.mesh.shard_module``) each rank
holds d_out / n_model of the slices and frequencies and the matching input
columns of fc1, which is row-parallel (``mlp.row_parallel``); the lookup,
fc1's bias and fc2 stay whole. Every forward then sorts only the rank's
slices, and the lazy planes hold only the rank's (the JAX package's
``P(None, MODEL_AXIS)`` planes). The lookup feeds every rank's slices, so
it enters through ``mlp.enter_model_axis``: the backward sums its gradient
over the model group, and every rank's copy takes the true gradient and
stays bit-equal. (The JAX package's FSW apply functions do not sum it: each
model rank's ``lookup`` gradient is n_model times its own slices' part, and
its replicated copies drift apart.)
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.sort import (  # noqa: F401  (f2i_keys, i2f_keys: the JAX module's names)
    f2i_keys,
    i2f_keys,
    sort_rows,
    sort_transient_bytes,
)
from ..kmer.vocab import (
    FSW_BASE_MAP,
    MAX_DENSE_K,
    canonical_vocab_codes,
    canonical_vocab_size,
    codes_to_digit_matrix,
)
from ..utils.membudget import hbm_fraction
from ..utils.phases import phase
from .mlp import enter_model_axis, init_params_, row_parallel

_SQRT2 = math.sqrt(2.0)

# shared-vocab gate: V beyond this would blow the sort transients; a batch
# beyond this is not the reference's (its FSW batch is 16)
FSW_SHARED_VOCAB_MAX = 1 << 18
FSW_SHARED_BATCH_MAX = 64


def unsort(d: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The transpose of a row permutation: out[..., perm[..., j]] = d[..., j]."""
    return torch.empty_like(d).scatter_(-1, perm.long().expand(d.shape), d)


class SortPW(torch.autograd.Function):
    """(ps, ws) = ``sort_rows(p, w)``: the projections p (R, N) sorted per
    row, carrying weight row w[r // (R // P)] of w (P, N) (the JAX package's
    ``_sort_pw``). Differentiable in p only: the weights are normalized
    k-mer frequencies, data in every caller, so their cotangent is dropped.
    The backward unsorts d_ps by the forward's ``perm``."""

    @staticmethod
    def forward(ctx, p, w):
        ps, ws, perm = sort_rows(p, w)
        ctx.save_for_backward(perm)
        ctx.mark_non_differentiable(ws)
        return ps, ws

    @staticmethod
    def backward(ctx, d_ps, _d_ws):
        (perm,) = ctx.saved_tensors
        return unsort(d_ps, perm), None


class SortShared(torch.autograd.Function):
    """(ps (C, V), wsb (B, C, V)): the shared projections p (C, V) sorted
    once, and every genome's weights wn (B, V) gathered by that order,
    ``wsb[b] = wn[b, perm]`` (the JAX package's ``_sort_shared``). Every
    genome reads the same ps, so autograd hands the backward one
    batch-summed cotangent: one unsort. The weights get no gradient."""

    @staticmethod
    def forward(ctx, p, wn):
        ps, _, perm = sort_rows(p, wn[:1])
        ctx.save_for_backward(perm)
        wsb = wn[:, perm.long()]
        ctx.mark_non_differentiable(wsb)
        return ps, wsb

    @staticmethod
    def backward(ctx, d_ps, _d_wsb):
        (perm,) = ctx.saved_tensors
        return unsort(d_ps, perm), None


def quantile_coefficients(ws: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """delta = sqrt(2) w cos(pi xi cbar) sinc(xi w / 2) of sorted weights ws
    (..., N), xi broadcast against them; E = sum(ps * delta, -1). Evaluated
    so that at most three buffers of ws's size live beside ws at a time
    (cbar is dropped before the sinc; ws (xi / 2) equals (xi ws) / 2 bit for
    bit), which keeps the sliced forward's peak at its sort."""
    cos = torch.cos(math.pi * xi * (torch.cumsum(ws, dim=-1) - ws / 2.0))
    head = _SQRT2 * ws * cos
    del cos
    return head * torch.sinc(ws * (xi / 2.0))


def _normalized(weights: torch.Tensor) -> torch.Tensor:
    total = torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-30)
    return (weights / total).contiguous()


def _by_slice_chunks(fn, slices: torch.Tensor, freqs: torch.Tensor,
                     slice_chunk: int) -> torch.Tensor:
    """fn(slices, freqs) -> (B, C) over chunks of slice_chunk slices (0: all
    at once), concatenated. Under autograd each chunk is recomputed in the
    backward rather than kept (the JAX package's ``jax.checkpoint`` per
    chunk), so the chunk bounds the backward's memory too."""
    d_out = slices.shape[0]
    if slice_chunk <= 0 or d_out <= slice_chunk:
        return fn(slices, freqs)
    out = []
    for c0 in range(0, d_out, slice_chunk):
        v, xi = slices[c0 : c0 + slice_chunk], freqs[c0 : c0 + slice_chunk]
        out.append(checkpoint(fn, v, xi, use_reentrant=False)
                   if torch.is_grad_enabled() else fn(v, xi))
    return torch.cat(out, dim=1)


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
    wn = _normalized(weights)

    def chunk(v, xi):
        c = v.shape[0]
        p = torch.einsum("cd,bnd->bcn", v, points).reshape(b * c, n).contiguous()
        ps, ws = SortPW.apply(p, wn)  # row b*c + j carries wn[b]
        del p  # the keys die here: the sort holds the chunk's peak (auto_slice_chunk)
        ps, ws = ps.view(b, c, n), ws.view(b, c, n)
        return torch.sum(ps * quantile_coefficients(ws, xi[None, :, None]), dim=-1)

    return _by_slice_chunks(chunk, slices, freqs, slice_chunk)


def fsw_embed_shared(slices: torch.Tensor, freqs: torch.Tensor, points: torch.Tensor,
                     weights: torch.Tensor, slice_chunk: int = 0) -> torch.Tensor:
    """FSW embeddings (B, C) of B weighted point sets sharing one point
    matrix: points (V, d_in), the canonical vocab under the lookup; weights
    (B, V), zero for absent k-mers. Equal, up to float summation order, to
    ``fsw_embed`` of the per-genome point sets: zero-weight points are
    no-ops, so padding every set out to the vocab changes nothing, and the
    projections become one (C, V) matrix for the whole batch."""
    wn = _normalized(weights)

    def chunk(v, xi):
        p = (v @ points.T).contiguous()  # (C, V), shared across the batch
        ps, wsb = SortShared.apply(p, wn)
        return torch.sum(ps[None] * quantile_coefficients(wsb, xi[None, :, None]), dim=-1)

    return _by_slice_chunks(chunk, slices, freqs, slice_chunk)


def fsw_sort_budget_bytes(device: str | torch.device) -> int:
    """Transient budget of the batched FSW sort: 1/8 of the device memory."""
    return hbm_fraction(1, 8, device)


def slice_sort_bytes(b: int, n: int) -> int:
    """Bytes one slice adds to the sliced forward's sort: its B key rows of
    N and what ``sort_rows`` allocates for them (``sort_transient_bytes``).
    16 B an element up to ``CLUSTER_ELEMS``, the JAX package's four f32
    buffers; past it the radix path's scratch adds 8 B an element and 1 KiB
    a row per tile of 16,384 of digit counts."""
    return 4 * b * n + sort_transient_bytes(b, n, b)


def auto_slice_chunk(b: int, n: int, d_out: int, device: str | torch.device) -> int:
    """The largest power-of-two slice chunk (at least 8) whose sort,
    ``slice_sort_bytes`` a slice, fits ``fsw_sort_budget_bytes``; 0 when all
    d_out slices fit. Equal to the JAX package's ``_auto_slice_chunk`` up to
    N = ``CLUSTER_ELEMS``, never larger beyond it (that one sizes XLA's sort,
    which has no radix scratch)."""
    if b < 1 or n < 1:
        return 0
    chunk = max(8, fsw_sort_budget_bytes(device) // slice_sort_bytes(b, n))
    if chunk >= d_out:
        return 0
    p = 8
    while p * 2 <= chunk:
        p *= 2
    return p


def shared_vocab_applicable(k: int, n_points_bucket: int, batch: int) -> bool:
    """Whether a clade trains on the shared-vocab path: the vocab is small
    enough to carry and the padded point sets cover at least a third of it
    (the shared sort moves ~(B+2) V floats against ~3 B N per genome and
    pays its comparisons once; full genomes at k <= 9 hold nearly every
    canonical k-mer, short contigs stay per genome)."""
    if not 1 <= k <= MAX_DENSE_K:
        return False
    v = canonical_vocab_size(k)
    if v > FSW_SHARED_VOCAB_MAX or batch > FSW_SHARED_BATCH_MAX:
        return False
    return v <= 3 * n_points_bucket


@functools.cache
def vocab_digits(k: int, device: torch.device) -> torch.Tensor:
    """(V, k) int64 reference-coded bases (A=0,T=1,C=2,G=3) of the canonical
    vocab at k, on ``device``."""
    digits = codes_to_digit_matrix(canonical_vocab_codes(k), k, FSW_BASE_MAP)
    return torch.from_numpy(digits.astype(np.int64)).to(device)


def lookup_points(lookup: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """(..., k * base_dim) points of (..., k) int64 digits: the lookup rows
    of each k-mer's bases, concatenated. Made as a one-hot product, whose
    values equal the gather ``lookup[digits]``: the gather's backward
    accumulates every digit into the 4-row table one after another on the
    card (27 ms of a 32 ms per-genome training step at full width on an
    H100, PERF.md §6), the product's is one matrix product."""
    return (F.one_hot(digits, 4).to(lookup.dtype) @ lookup).flatten(-2)


class FSWDistEmbed(nn.Module):
    """NeuralNetFSW: lookup -> FSW layer -> Linear -> ReLU -> Linear."""

    model_axis = None  # set by parallel.mesh.shard_module

    def __init__(self, k: int, base_dim: int, d_out: int, hidden_size: int, embedding_size: int):
        super().__init__()
        self.k = k
        self.lookup = nn.Parameter(torch.zeros(4, base_dim))
        self.slices = nn.Parameter(torch.zeros(d_out, k * base_dim))
        self.freqs = nn.Parameter(torch.zeros(d_out))
        self.fc1 = nn.Linear(d_out, hidden_size)
        self.fc2 = nn.Linear(hidden_size, embedding_size)

    def forward(self, x: torch.Tensor, slice_chunk: int | None = None) -> torch.Tensor:
        """x: (B, N, k+1) point sets — reference-coded bases (A=0,T=1,C=2,G=3)
        in the first k columns, frequency weight in the last (the JAX
        package's ``fsw_dist_embed_apply``) — or (B, V) weights over the
        canonical vocab at k (``forward_shared``). slice_chunk=None picks
        ``auto_slice_chunk`` for x's device."""
        if x.dim() == 2:
            return self.forward_shared(x, vocab_digits(self.k, x.device), slice_chunk)
        kmers = x[..., :-1].long()
        weights = x[..., -1]
        b, n, _ = kmers.shape
        points = lookup_points(enter_model_axis(self.lookup, self.model_axis), kmers)
        if slice_chunk is None:
            slice_chunk = auto_slice_chunk(b, n, self.slices.shape[0], x.device)
        return self.head(fsw_embed(self.slices, self.freqs, points, weights, slice_chunk))

    def forward_shared(self, w: torch.Tensor, digits: torch.Tensor,
                       slice_chunk: int | None = None) -> torch.Tensor:
        """w: (B, V) vocab-aligned weights, digits: (V, k) int64 reference-coded
        bases of the vocab (the JAX package's ``fsw_dist_embed_apply_shared``)."""
        b, v = w.shape
        points = lookup_points(enter_model_axis(self.lookup, self.model_axis), digits)
        if slice_chunk is None:
            slice_chunk = auto_slice_chunk(b, v, self.slices.shape[0], w.device)
        return self.head(fsw_embed_shared(self.slices, self.freqs, points, w, slice_chunk))

    def head(self, e: torch.Tensor) -> torch.Tensor:
        """The MLP on FSW embeddings e (B, C): fc1 row-parallel over a model
        axis, its sum whole on every rank before the bias and the ReLU."""
        return self.fc2(F.relu(row_parallel(self.fc1, e, self.model_axis)))


def _delta_and_gdelta(ws: torch.Tensor, freqs: torch.Tensor, xi_shape):
    """delta = quantile_coefficients(ws, xi) and d delta / d xi, by jvp."""
    return torch.func.jvp(lambda xi: quantile_coefficients(ws, xi.view(xi_shape)),
                          (freqs.detach(),), (torch.ones_like(freqs),))


def _refresh_groups(n: int, group: int):
    return (slice(g0, min(g0 + max(group, 1), n)) for g0 in range(0, n, max(group, 1)))


@torch.no_grad()
def fsw_lazy_refresh(slices: torch.Tensor, freqs: torch.Tensor, points: torch.Tensor,
                     digits: torch.Tensor, w: torch.Tensor, group: int = 8):
    """(S (n, C, k, 4), g2 (n, C)) of the shared-vocab lazy path.

    points: (V, d_in) vocab points under the current lookup; digits: (V, k)
    int64 codes of the vocab (points[v] = concat_j lookup[digits[v, j]]);
    w: (n, V) nonnegative weights (all-zero rows give S = 0).
    S[i,c,j,a] sums delta over the vocab entries whose j-th base is a;
    g2[i,c] = sum_v ps[c,v] d delta[i,c,v] / d xi_c, contracted in sorted
    order. One ``sort_rows`` of the shared (C, V) projections serves every
    item; per group of ``group`` items the sorted weights are gathered by its
    ``perm``, delta and d delta / d xi computed, delta unsorted and
    segment-summed by one matmul with the (V, 4k) one-hot digit matrix.
    Spans: ``fsw.refresh.sort`` once, ``.gather``, ``.jvp`` and ``.reduce``
    per group."""
    n, v = w.shape
    k = digits.shape[1]
    wn = _normalized(w)
    with phase("fsw.refresh.sort"):
        ps, _, perm = sort_rows((slices @ points.T).contiguous(), wn[:1])
        perm = perm.long()
        onehot = F.one_hot(digits, 4).reshape(v, 4 * k).to(torch.float32)
    s_out, g2_out = [], []
    for rows in _refresh_groups(n, group):
        with phase("fsw.refresh.gather"):
            wsb = wn[rows][:, perm]  # (G, C, V) sorted weights
        with phase("fsw.refresh.jvp"):
            delta, gdelta = _delta_and_gdelta(wsb, freqs, (1, -1, 1))
        with phase("fsw.refresh.reduce"):
            g2_out.append(torch.sum(ps[None] * gdelta, dim=-1))
            s_out.append(unsort(delta, perm) @ onehot)
    c = slices.shape[0]
    return torch.cat(s_out).reshape(n, c, k, 4), torch.cat(g2_out)


@torch.no_grad()
def fsw_lazy_refresh_pergenome(slices: torch.Tensor, freqs: torch.Tensor, lookup: torch.Tensor,
                               x: torch.Tensor, group: int = 4):
    """(S (n, C, k, 4), g2 (n, C)) of the per-genome lazy path, from padded
    point sets x (n, N, k+1) whose genomes each own their points (short
    contigs, sparse clades, k > 9). Per group of ``group`` items: one
    ``sort_rows`` of the G*C projection rows carrying the G weight rows,
    delta and d delta / d xi, the unsort, and each item's own one-hot digit
    matrix. Zero-weight padding rows add nothing to S or g2. Only one
    group's buffers live at a time, each dropped once spent
    (``train.fsw_lazy.refresh_transient_bytes`` counts the worst stage).
    Spans per group: ``fsw.refresh.sort``, ``.jvp`` and ``.reduce``."""
    n, npts, kp1 = x.shape
    k = kp1 - 1
    c = slices.shape[0]
    s_out, g2_out = [], []
    for rows in _refresh_groups(n, group):
        with phase("fsw.refresh.sort"):
            km = x[rows, :, :k].long()
            g = km.shape[0]
            keys = torch.einsum("cd,gnd->gcn", slices,
                                lookup_points(lookup, km)).reshape(g * c, npts)
            ps, ws, perm = sort_rows(keys.contiguous(), _normalized(x[rows, :, -1]))
            del keys
            ps, ws, perm = ps.view(g, c, npts), ws.view(g, c, npts), perm.view(g, c, npts)
        with phase("fsw.refresh.jvp"):
            delta, gdelta = _delta_and_gdelta(ws, freqs, (1, -1, 1))
        del ws
        with phase("fsw.refresh.reduce"):
            g2_out.append(torch.sum(ps * gdelta, dim=-1))
            del ps, gdelta
            onehot = F.one_hot(km, 4).reshape(g, npts, 4 * k).to(torch.float32)
            s_out.append(torch.bmm(unsort(delta, perm), onehot))
    return torch.cat(s_out).reshape(n, c, k, 4), torch.cat(g2_out)


def fsw_lazy_apply(model: FSWDistEmbed, s: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """Embeddings (B, E) from rows of a refresh's S (B, C, k, 4) and g2
    (B, C), C the model's own slices (a rank's share on a model axis).
    Gradients reach the slices and the lookup through the (C, k, 4)
    projections of the slice blocks on the lookup rows, the frequencies
    through (xi - xi.detach()) * g2, which is zero in value."""
    c, k = s.shape[1], s.shape[2]
    vblocks = model.slices.reshape(c, k, -1)
    proj = torch.einsum("ckd,ad->cka", vblocks, enter_model_axis(model.lookup, model.model_axis))
    e = torch.einsum("bcka,cka->bc", s, proj)
    e = e + (model.freqs - model.freqs.detach())[None, :] * g2
    return model.head(e)


@torch.no_grad()
def init_fsw_dist_embed_(module: FSWDistEmbed, generator: torch.Generator) -> FSWDistEmbed:
    """Draw every parameter from ``generator`` (on the module's device): the
    lookup standard normal, the FSW slices and freqs as
    ``init_fsw_params_``, the Linear layers with torch.nn.Linear's bounds
    (the JAX package's ``init_fsw_dist_embed``)."""
    module.lookup.normal_(generator=generator)
    init_fsw_params_(module.slices, module.freqs, generator)
    return init_params_(module, generator)
