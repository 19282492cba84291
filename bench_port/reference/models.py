"""The models of kf2vec and its FSW fork, their loss and Adam, in plain
PyTorch.

Parameters are a flat dict in the checkpoints' layout: ``fc1/w`` (in, out),
``fc1/b``, ``fc2/w``, ``fc2/b`` and for FSW
``lookup`` (4, base_dim), ``fsw/slices`` (C, k * base_dim), ``fsw/freqs``
(C,). Every function computes in the dtype of its inputs: float64 for the
reference, float32 for the control (below); training keeps the parameters
in the configurations' float32 between steps.

- NeuralNet: Linear -> ReLU -> Linear.
- NeuralNetFSW: each k-mer of a point set is the concatenation of its
  bases' lookup rows; for slice c with direction v_c and frequency xi_c the
  projections <v_c, x_j> are sorted, carrying the normalised weights, and
  E_c = sum_i p_(i) sqrt(2) w_(i) cos(pi xi_c cbar_i) sinc(xi_c w_(i) / 2),
  cbar_i the midpoint of the i-th step of the cumulative weights; the MLP
  maps E to the embedding.
- The lazy sort-refresh route of training (kf2vecFSW's
  ``-fsw_lazy_refresh``): at a refresh the sort order, and so every
  coefficient delta above, is frozen from the parameters of that moment;
  until the next, E_c is the sum of the current projections of the
  vocabulary's k-mers against those coefficients, and the frequencies take
  as gradient the coefficients' derivative in xi at the refresh.
- The loss: the mean over a batch's pairs of (d - sqrt(t))^2 / (t + 1e-6),
  d the L2 distance of two embeddings (0 for a pair of equal rows, with a
  zero gradient), t the true distance.
- The learning rate steps down every 100 epochs (``step_lr``).
- Adam as in ``torch.optim.Adam``: betas 0.9, 0.999, eps 1e-8 outside the
  square root, bias corrections on both moments.

Under ``tf32_products()`` every matrix product, forward and backward, takes
its operands rounded to TF32 (10 mantissa bits, to nearest even) and sums
in float32, as the card's tensor cores do with TF32 on: the control's
precision, the one below the configurations' float32 with TF32 off. The
rounding is explicit, so it holds on the CPU and for products of one row,
which cuBLAS runs without tensor cores.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
LOSS_OFFSET = 1e-6


_TF32 = contextvars.ContextVar("tf32_products", default=False)


@contextlib.contextmanager
def tf32_products():
    token = _TF32.set(True)
    try:
        yield
    finally:
        _TF32.reset(token)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


class _RoundValue(torch.autograd.Function):
    """An operand entering a product: rounded; its gradient passes as is."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """A product's result: as is; the gradient entering the backward
    products rounded."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def product(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``op(a, b)`` of a matrix product, in TF32 under ``tf32_products``."""
    if not _TF32.get():
        return op(a, b)
    return _RoundGrad.apply(op(_RoundValue.apply(a), _RoundValue.apply(b)))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return product(torch.matmul, a, b)


def linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return matmul(x, p[f"{name}/w"]) + p[f"{name}/b"]


def head(p: dict, e: torch.Tensor) -> torch.Tensor:
    return linear(p, "fc2", F.relu(linear(p, "fc1", e)))


def quantile_delta(ws: torch.Tensor, xi: torch.Tensor, dim: int) -> torch.Tensor:
    """sqrt(2) w cos(pi xi cbar) sinc(xi w / 2) of weights ``ws`` sorted
    along ``dim``, xi broadcast against them."""
    cbar = torch.cumsum(ws, dim=dim) - ws / 2
    return math.sqrt(2.0) * ws * torch.cos(math.pi * xi * cbar) * torch.sinc(xi * ws / 2)


def points(p: dict, digits: torch.Tensor) -> torch.Tensor:
    """(..., k * base_dim) points of (..., k) base digits."""
    return p["lookup"][digits].flatten(-2)


def fsw_embed(p: dict, digits: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(C,) FSW embedding of one point set: digits (N, k), weights (N,)."""
    proj = matmul(points(p, digits), p["fsw/slices"].T)  # (N, C)
    wn = weights / weights.sum()
    ps, order = torch.sort(proj, dim=0, stable=True)
    ws = wn[order]
    return torch.sum(ps * quantile_delta(ws, p["fsw/freqs"][None, :], 0), dim=0)


def fsw_forward(p: dict, digits: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(E,) embedding of one point set by NeuralNetFSW."""
    return head(p, fsw_embed(p, digits, weights)[None])[0]


def sq_pairwise(emb: torch.Tensor) -> torch.Tensor:
    diff = emb[:, None, :] - emb[None, :, :]
    return torch.sum(diff * diff, dim=-1)


def pairwise_l2(emb: torch.Tensor) -> torch.Tensor:
    """Pairwise L2 of rows, 0 with a zero gradient where rows are equal."""
    sq = sq_pairwise(emb)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def distance_loss(emb: torch.Tensor, true_dist: torch.Tensor) -> torch.Tensor:
    d = pairwise_l2(emb)
    return torch.mean((d - torch.sqrt(true_dist)) ** 2 / (true_dist + LOSS_OFFSET))


class Adam:
    """torch.optim.Adam's update on a dict of leaves."""

    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        b1, b2 = ADAM_BETAS
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            denom = torch.sqrt(self.v[k]) / math.sqrt(1 - b2**self.t) + ADAM_EPS
            out[k] = p - self.lr / (1 - b1**self.t) * self.m[k] / denom
        return out


def step_lr(epoch: int, lr0: float, lr_min: float, decay: float) -> float:
    """The learning rate of epoch ``epoch`` (0-based) in kf2vec's trainer:
    it starts at ``lr0``; at the end of every epoch u divisible by 100
    (0 included) Adam's rate becomes lr_min + lr0 * 0.1^(u / decay)."""
    if epoch == 0:
        return lr0
    u = (epoch - 1) - (epoch - 1) % 100
    return lr_min + lr0 * 0.1 ** (u / decay)


class LazyFSW:
    """The embedding of the lazy route between two refreshes, over items
    given as (n, V) weights on the canonical vocabulary (``vocab_digits``
    (V, k) their k-mers)."""

    def __init__(self, vocab_digits: torch.Tensor, weights: torch.Tensor):
        self.digits = vocab_digits
        self.wn = weights / weights.sum(dim=1, keepdim=True)

    def refresh(self, p: dict) -> None:
        with torch.no_grad():
            proj = matmul(points(p, self.digits), p["fsw/slices"].T)  # (V, C)
            self.ps, self.order = torch.sort(proj, dim=0, stable=True)
            self.xi = p["fsw/freqs"].clone()

    def coefficients(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(D (b, V, C), g2 (b, C)) of items ``idx``: the frozen coefficients
        of each vocab k-mer, and d E / d xi at the refresh."""
        with torch.no_grad():
            ws = self.wn[idx][:, self.order]  # (b, V, C) sorted by the frozen order
            xi = self.xi.clone().requires_grad_(False)
            delta, gdelta = torch.func.jvp(lambda x: quantile_delta(ws, x[None, None, :], 1),
                                           (xi,), (torch.ones_like(xi),))
            g2 = torch.sum(self.ps[None] * gdelta, dim=1)
            d = torch.empty_like(delta).scatter_(1, self.order.expand_as(delta), delta)
        return d, g2

    def embed(self, p: dict, idx: torch.Tensor) -> torch.Tensor:
        d, g2 = self.coefficients(idx)
        proj = matmul(points(p, self.digits), p["fsw/slices"].T)  # (V, C), current parameters
        e = (product(lambda a, b: torch.einsum("bvc,vc->bc", a, b), d, proj)
             + (p["fsw/freqs"] - self.xi)[None, :] * g2)
        return head(p, e)


def train_steps(params0: dict, embed, dist: torch.Tensor, batches: list[torch.Tensor],
                lr: float, refresh=None, compute: torch.dtype = torch.float64) -> dict:
    """Steps of Adam on ``batches`` from ``params0``: ``embed(params, idx)``
    the batch's embeddings, ``refresh(params)`` called before the first.
    The parameters are kept in their own dtype (the configuration's
    float32: an update below half a unit in the last place leaves a value
    as it is) and every step computes in ``compute``. Returns each step's
    loss and embeddings, the first step's gradients and the change of
    every leaf after the last step."""
    store = {k: v.dtype for k, v in params0.items()}
    params = {k: v.to(compute) for k, v in params0.items()}
    opt = Adam(params, lr)
    losses, embs, grad1 = [], [], None
    for i, idx in enumerate(batches):
        if i == 0 and refresh is not None:
            refresh(params)
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        emb = embed(leaves, idx)
        embs.append(emb.detach().double().cpu())
        loss = distance_loss(emb, dist[idx][:, idx])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                     allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
        if grad1 is None:
            grad1 = {k: g.detach() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        params = {k: v.to(store[k]).to(compute) for k, v in opt.step(params, grads).items()}
    return {"losses": losses, "grad1": grad1, "embs": embs,
            "change": {k: params[k] - params0[k].to(compute) for k in params}}
