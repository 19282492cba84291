"""The per-genome lazy route of NeuralNetFSW's training, in plain PyTorch.

Each training item is its own point set, as ``get_kmers`` writes it: an
(N_i, k+1) matrix of a genome's present canonical k-mers, their bases coded
A=0, T=1, C=2, G=3 in the first k columns and the k-mer's frequency last
(kf2vecFSW ``main.py:112-184``). The model is ``models.fsw_forward``'s; the
route is kf2vecFSW's ``-fsw_lazy_refresh`` on such items:

- at a refresh, each item's own projections (N_i, C) on the parameters of
  that moment are sorted stably per slice, and that order is frozen, with
  the coefficients delta it gives (``models.quantile_delta``) and
  g2 = d E / d xi there;
- between refreshes, the item's embedding is its current projections
  against the frozen coefficients, sum_j proj[j, c] delta[j, c]: the
  frequencies stay as the refresh froze them in delta, and take g2 as
  their gradient (a term xi g2 - its value, which adds 0; ``models.LazyFSW``
  of the shared route adds (xi - xi at the refresh) g2 to the value too, a
  first-order step the program does not take).

Departures from upstream, none of them in the mathematics:
- upstream sorts exactly at every step; the lazy route is the program's
  default (``configs/fsw_k10.json`` ``assumed``), and this file is that
  route's reference;
- the frozen coefficients are recomputed from the refresh's parameters
  for each batch that needs them, one item at a time, held until the
  batch's backward, and dropped there (at k = 10 one item's (N_i, C) take
  2 GB in float64, so no more than a batch's are held); the embeddings are
  taken without gradient, then each item's backward recomputes its
  projections under autograd;
- the points are the one-hot bases times the lookup, whose values equal
  the gather ``models.points`` takes (its backward would add N_i k rows into
  4 one after another);
- zero-weight rows (padding) are allowed and add nothing: their delta is 0,
  and they move no other row's cumulative weight;
- ``plane(i)``, the coefficients summed over the rows whose j-th base is a,
  (C, k, 4), exists only to be compared with the program's refresh.

Every product goes through ``models.product``, so ``models.tf32_products``
rounds it as the card's TF32 would (the control). Imports nothing of the
program or of JAX; TF32 is off for every product it computes otherwise.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import models
from .models import head, matmul, points, product, quantile_delta

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class PerGenomeLazy:
    """The embedding of the per-genome lazy route over items given as
    (N_i, k+1) point-set matrices ``mats`` (tensors on any device; moved to
    ``device`` in ``dtype`` one item at a time)."""

    def __init__(self, mats, device: torch.device, dtype: torch.dtype = torch.float64):
        self.mats, self.dev, self.dtype = mats, device, dtype
        self.frozen = None
        self.planes: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def item(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(digits (N_i, k) int64, normalised weights (N_i,)) of item ``i``."""
        m = torch.as_tensor(self.mats[i]).to(self.dev)
        k = m.shape[1] - 1
        w = m[:, k].to(self.dtype)
        return m[:, :k].long(), w / w.sum()

    def refresh(self, p: dict) -> None:
        """Freeze the order and coefficients of the parameters ``p``."""
        self.frozen = {k: p[k].detach().clone() for k in ("lookup", "fsw/slices", "fsw/freqs")}
        self.planes = {}

    def coefficients(self, i: int, digits: torch.Tensor, wn: torch.Tensor):
        """(delta (N_i, C) in the item's row order, g2 (C,)) frozen at the
        last refresh."""
        f = self.frozen
        with torch.no_grad():
            proj = matmul(points(f, digits), f["fsw/slices"].T)  # (N_i, C)
            ps, order = torch.sort(proj, dim=0, stable=True)
            del proj
            ws = wn[order]  # each slice's weights in its sorted order
            xi = f["fsw/freqs"]
            delta, gdelta = torch.func.jvp(lambda x: quantile_delta(ws, x[None, :], 0),
                                           (xi,), (torch.ones_like(xi),))
            del ws
            g2 = torch.sum(ps * gdelta, dim=0)
            del ps, gdelta
            d = torch.empty_like(delta).scatter_(0, order, delta)
            if i not in self.planes:
                onehot = F.one_hot(digits, 4).to(d.dtype).flatten(1)  # (N_i, 4k)
                plane = product(lambda a, b: a.T @ b, d, onehot)
                self.planes[i] = (plane.view(-1, digits.shape[1], 4), g2)
        return d, g2

    def item_embedding(self, i: int, lookup, slices, freqs, frozen=None) -> torch.Tensor:
        """(C,) FSW embedding of item ``i`` on the current parameters;
        ``frozen``: its (delta, g2), when already computed."""
        digits, wn = self.item(i)
        d, g2 = frozen if frozen is not None else self.coefficients(i, digits, wn)
        # the points as a product with the one-hot bases, whose values are the
        # gather's: the gather's backward would add N_i k rows into 4, one by one
        pts = matmul(F.one_hot(digits, 4).to(lookup.dtype), lookup).flatten(-2)
        proj = matmul(pts, slices.T)  # (N_i, C), current
        e = product(lambda a, b: torch.einsum("nc,nc->c", a, b), d, proj)
        return e + (freqs - freqs.detach()) * g2

    def embed(self, p: dict, idx: torch.Tensor) -> torch.Tensor:
        """(B, E) embeddings of items ``idx`` on the parameters ``p``."""
        e = _Items.apply(self, idx.tolist(), p["lookup"], p["fsw/slices"], p["fsw/freqs"])
        return head(p, e)

    def plane(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(S (C, k, 4), g2 (C,)) of item ``i`` at the last refresh."""
        if i not in self.planes:
            self.coefficients(i, *self.item(i))
        return self.planes[i]


class _Items(torch.autograd.Function):
    """The FSW embeddings (B, C) of a batch's items, taken without gradient
    one item at a time; the backward recomputes each item's embedding under
    autograd and takes its vector-Jacobian product, one item at a time."""

    @staticmethod
    def forward(ctx, lazy, items, lookup, slices, freqs):
        ctx.lazy, ctx.items, ctx.tf32 = lazy, items, models._TF32.get()
        ctx.save_for_backward(lookup, slices, freqs)
        ctx.frozen = {i: lazy.coefficients(i, *lazy.item(i)) for i in items}
        return torch.stack([lazy.item_embedding(i, lookup, slices, freqs, ctx.frozen[i])
                            for i in items])

    @staticmethod
    def backward(ctx, g):
        params = ctx.saved_tensors
        grads = [torch.zeros_like(t) for t in params]
        tf32 = models.tf32_products() if ctx.tf32 else contextlib.nullcontext()
        with tf32, torch.enable_grad():
            for row, i in enumerate(ctx.items):
                leaves = [t.detach().requires_grad_(True) for t in params]
                e = ctx.lazy.item_embedding(i, *leaves, ctx.frozen.pop(i))
                for acc, gi in zip(grads, torch.autograd.grad(e, leaves, g[row])):
                    acc += gi
        return None, None, *grads
