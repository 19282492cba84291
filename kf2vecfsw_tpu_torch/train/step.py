"""Training epochs and the optimizer (the port's counterpart of the JAX
package's ``train/step.py``).

Adam is ``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8 added outside the
square root): the semantics of the JAX package's ``adam_update``. The
learning rate is set per epoch through ``param_groups``.

An epoch takes its item order as an argument (the trainers draw it from a
CPU ``torch.Generator``; the tests feed the JAX runner's own order). The
items are taken in that order in ceil(n/B) batches, the last one partial,
with one Adam step per batch, as in the JAX package's batch plan. The TPU's
bucket padding, all-fake batches and the ``active`` gate exist only so that
XLA does not recompile, and are not ported; nor are the multi-epoch device
spans, a remedy for the TPU's dispatch cost. A batch's loss is the mean over
its pairs (distance) or items (classifier); the epoch loss is
sum(loss * items) / sum(items). Losses stay on the device within an epoch:
the caller fetches them once per epoch.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.losses import nll_loss, weighted_sqrt_mse
from ..ops.pairwise import pairwise_l2_exact

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def bucket_items(n_items: int, floor: int = 8) -> int:
    """Pad the item dimension to a geometric bucket (ratio 1.25, multiples
    of 8), as the JAX package does, so padded shapes depend only on the
    bucket and not on the exact count."""
    b = floor
    while b < n_items:
        b = -(-int(b * 1.25) // 8) * 8
    return b


def epoch_order(gen: torch.Generator, n_items: int) -> torch.Tensor:
    """The random item order of one epoch, drawn from the trainer's CPU
    generator (so a run on the card and one on the CPU take the same
    batches)."""
    return torch.randperm(n_items, generator=gen)


def make_adam(module: nn.Module, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def _distance_batch_loss(emb, dist, idx, weight_offset):
    true_dist = dist.index_select(0, idx).index_select(1, idx)
    return weighted_sqrt_mse(pairwise_l2_exact(emb), true_dist, None, weight_offset)


def distance_steps(embed, model: nn.Module, opt: torch.optim.Optimizer, dist: torch.Tensor,
                   order: torch.Tensor, batch_size: int, weight_offset: float = 1e-6) -> torch.Tensor:
    """One epoch of the distance-embedding trainer over ``order`` (item
    indices into ``dist`` rows/cols, on its device), with ``embed(idx)``
    the embeddings of a batch; returns the epoch loss as a device scalar."""
    model.train()
    total = torch.zeros((), dtype=torch.float32, device=dist.device)
    for idx in torch.split(order, batch_size):
        loss = _distance_batch_loss(embed(idx), dist, idx, weight_offset)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        total += loss.detach() * idx.numel()
    return total / max(order.numel(), 1)


def distance_epoch(model: nn.Module, opt: torch.optim.Optimizer, feats: torch.Tensor,
                   dist: torch.Tensor, order: torch.Tensor, batch_size: int,
                   weight_offset: float = 1e-6) -> torch.Tensor:
    """``distance_steps`` with the model's forward of ``feats`` rows: dense
    (n, V) vectors, FSW (n, N, k+1) point sets or (n, V) vocab weights."""
    return distance_steps(lambda idx: model(feats.index_select(0, idx)), model, opt, dist,
                          order, batch_size, weight_offset)


def classifier_epoch(model: nn.Module, opt: torch.optim.Optimizer, feats: torch.Tensor,
                     labels: torch.Tensor, order: torch.Tensor,
                     batch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One epoch of the classifier trainer over ``order``; returns the epoch
    NLL and top-1 accuracy (taken before each batch's step, as the JAX
    runner does) as device scalars."""
    model.train()
    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    correct = torch.zeros((), dtype=torch.int64, device=feats.device)
    for idx in torch.split(order, batch_size):
        log_probs = model(feats.index_select(0, idx))
        y = labels.index_select(0, idx)
        loss = nll_loss(log_probs, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        total += loss.detach() * idx.numel()
        correct += (log_probs.detach().argmax(dim=1) == y).sum()
    n = max(order.numel(), 1)
    return total / n, correct.to(torch.float32) / n


@torch.no_grad()
def eval_loss(model: nn.Module, feats: torch.Tensor, dist: torch.Tensor,
              indices: list[int], batch_size: int, weight_offset: float = 1e-6) -> float:
    """Distance loss of ``indices`` in their order, in batches, weighted by
    batch size (the JAX runner's ``eval_loss``); NaN when empty."""
    if not indices:
        return float("nan")
    model.eval()
    order = torch.tensor(indices, dtype=torch.int64, device=feats.device)
    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    for idx in torch.split(order, batch_size):
        emb = model(feats.index_select(0, idx))
        total += _distance_batch_loss(emb, dist, idx, weight_offset) * idx.numel()
    return float(total / len(indices))
