"""NeuralNetFSW trained as kf2vecFSW trains it, in plain PyTorch: the exact
sort at every step.

Each training item is its own weighted point set: the (N_i, k) bases of
the canonical k-mers present in a genome, coded A=0, T=1, C=2, G=3, and
their frequencies (kf2vecFSW ``main.py:112-184``, get_kmers). At every
step, for every item of the batch, the item's projections (N_i, C) on the
current parameters are sorted stably per slice (``torch.sort``), its
normalised weights follow that order, and E_c = sum_i p_(i) delta_(i),
delta the coefficients of ``models.quantile_delta``; the gradient reaches
the slices and the lookup through the sorted values, and the frequencies
through delta (kf2vecFSW ``models.py:51-68`` with fswlib's ``FSWEmbedding``,
``train_model_set.py:72-90`` for the batches). The head, the loss, Adam and
the learning rate are ``models``'.

Departures from upstream, none of them in the mathematics:
- the items are unpadded: upstream pads a batch's point sets with
  zero-weight rows (``pad_collate``), which add nothing to E (their delta is
  0 and they move no other row's cumulative weight);
- one item at a time, each item's embedding taken without gradient in the
  forward and recomputed under autograd in its backward (at k = 10 one
  item's (N_i, C) take 2 GB in float64, and a batch holds 16), as
  ``pergenome.py`` does;
- the points are the one-hot bases times the lookup, whose values equal
  the gather upstream takes, so that ``models.tf32_products`` rounds the
  lookup as the card's TF32 would (the control);
- a shared-vocab clade's items are its genomes' present vocabulary
  k-mers: what the program sorts as one (C, V) matrix with zero weights for
  the absent ones is, per genome, this.

Every product goes through ``models.product``. Imports nothing of the
program or of JAX; TF32 is off for every product it computes otherwise.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import models
from .models import head, matmul, quantile_delta

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class ExactFSW:
    """The exact embedding over items given as (digits (N_i, k) int64,
    weights (N_i,)) pairs (tensors on any device; moved to ``device`` in
    ``dtype`` one item at a time)."""

    def __init__(self, items, device: torch.device, dtype: torch.dtype = torch.float64):
        self.items, self.dev, self.dtype = items, device, dtype

    def item(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(digits (N_i, k) int64, normalised weights (N_i,)) of item ``i``."""
        digits, w = self.items[i]
        w = w.to(self.dev, self.dtype)
        return digits.to(self.dev), w / w.sum()

    def item_embedding(self, i: int, lookup, slices, freqs) -> torch.Tensor:
        """(C,) FSW embedding of item ``i``: its projections sorted per slice."""
        digits, wn = self.item(i)
        pts = matmul(F.one_hot(digits, 4).to(lookup.dtype), lookup).flatten(-2)
        proj = matmul(pts, slices.T)  # (N_i, C)
        ps, order = torch.sort(proj, dim=0, stable=True)
        del proj
        delta = quantile_delta(wn[order], freqs[None, :], 0)
        return torch.sum(ps * delta, dim=0)

    def embed(self, p: dict, idx: torch.Tensor) -> torch.Tensor:
        """(B, E) embeddings of items ``idx`` on the parameters ``p``."""
        e = _Items.apply(self, idx.tolist(), p["lookup"], p["fsw/slices"], p["fsw/freqs"])
        return head(p, e)


class _Items(torch.autograd.Function):
    """The FSW embeddings (B, C) of a batch's items, taken without gradient
    one item at a time; the backward recomputes each item's embedding under
    autograd and takes its vector-Jacobian product, one item at a time."""

    @staticmethod
    def forward(ctx, exact, items, lookup, slices, freqs):
        ctx.exact, ctx.items, ctx.tf32 = exact, items, models._TF32.get()
        ctx.save_for_backward(lookup, slices, freqs)
        return torch.stack([exact.item_embedding(i, lookup, slices, freqs) for i in items])

    @staticmethod
    def backward(ctx, g):
        params = ctx.saved_tensors
        grads = [torch.zeros_like(t) for t in params]
        tf32 = models.tf32_products() if ctx.tf32 else contextlib.nullcontext()
        with tf32, torch.enable_grad():
            for row, i in enumerate(ctx.items):
                leaves = [t.detach().requires_grad_(True) for t in params]
                e = ctx.exact.item_embedding(i, *leaves)
                for acc, gi in zip(grads, torch.autograd.grad(e, leaves, g[row])):
                    acc += gi
        return None, None, *grads
