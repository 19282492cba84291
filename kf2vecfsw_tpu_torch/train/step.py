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

Every epoch takes the JAX runners' sharded batch plan
(``kf2vecfsw_tpu/train/step.py:227,267-292,417,445-470``) over the data
axis of the trainer's grid (``parallel.mesh.DataMesh``, R = n_data data
indices): a batch is padded to batch_pad = ceil(B / R) * R rows and data
index d holds rows [d * local_b, (d + 1) * local_b), local_b = batch_pad /
R, so the padding falls at the end and a data index may hold only padding
(``local_rows``). A padded row is masked out of every loss term, so the
port does not embed it: a rank embeds its real rows, and the masked loss of
the padded batch is the loss of its real rows. Every rank draws the same
orders, so the grid takes the batches of one process. The collectives of
the plan run on the rank's data group (the ranks of its model index; the
whole world on the grid (world, 1)):
- Distance: the data group's embeddings are gathered to the batch's (n, E)
  by one all-reduce (``parallel.mesh.gather_rows``); the rank's own rows go
  back in as the tensor that carries the gradient, the others detached.
  Every rank computes the batch's loss and its backward, which reaches the
  parameters through its own rows only.
- Classifier: the local loss is the NLL sum of the rank's rows over the
  batch's count; the loss and accuracy sums are all-reduced over the data
  group once an epoch.
- Both: the step's gradients, flattened into one buffer, are summed over
  the data group by one all-reduce (``all_reduce_grads``), then Adam steps
  on every rank alike. ``DistributedDataParallel`` is not used: it
  averages over R, which is wrong for a masked last batch; nor is an
  autograd all-gather, whose backward sums the R identical losses (R times
  the gradient) and needs collectives that gloo does not run on CUDA
  tensors.
With a model axis the ranks of a model group hold the same rows and compute
the same loss, each on its cut of the model (``models/mlp.py``): the
forward's sums over the model group make their embeddings equal, and each
rank's backward gives its cut's gradient and every whole parameter's true
one, so the data group's sum is the gradient of one process, never n_model
times it.
A process without a group takes the same plan as one rank: it holds every
row, its gathered embeddings are its own, and no collective runs. At world
size 1 a group adds only the all-reduces, whose sums of one rank change no
bit, so a one-rank group trains bit for bit as a process without one.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.losses import nll_sum, weighted_sqrt_mse
from ..ops.pairwise import pairwise_l2_exact
from ..parallel.mesh import DataMesh, all_reduce_, gather_rows
from ..utils.phases import phase

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


def local_rows(n_rows: int, batch_size: int, mesh: DataMesh | None) -> tuple[int, int]:
    """[lo, hi): this rank's real rows of a batch of ``n_rows`` items under
    the sharded plan, the range [d * local_b, (d + 1) * local_b) of its data
    index d, cut at ``n_rows`` (empty for a data index that holds only
    padding); every row without a mesh."""
    if mesh is None:
        return 0, n_rows
    local_b = -(-batch_size // mesh.n_data)
    lo = min(mesh.data_rank * local_b, n_rows)
    return lo, min(lo + local_b, n_rows)


def data_sum_(t: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """Sum ``t`` in place over the mesh's data group; nothing without a
    mesh over a process group."""
    if mesh is None or not mesh.distributed:
        return t
    return all_reduce_(t, mesh.data_group)


def all_reduce_grads(model: nn.Module, mesh: DataMesh | None) -> None:
    """Sum every parameter's gradient over the data group by one all-reduce
    of one flat buffer (a parameter without a gradient adds zeros); the
    gradients become views of that buffer. Nothing to do without a mesh
    over a process group."""
    if mesh is None or not mesh.distributed:
        return
    with phase("train.grad_sum"):
        params = list(model.parameters())
        flat = data_sum_(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                    .reshape(-1) for p in params]), mesh)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)


def gathered_embeddings(own: torch.Tensor, lo: int, n_rows: int,
                        mesh: DataMesh | None) -> torch.Tensor:
    """(n_rows, E) embeddings of a batch from the data group's rows; this
    rank's rows [lo, lo + len(own)) are ``own`` itself, so the gradient of a
    loss of the result reaches this rank's parameters through them alone.
    Without a mesh over a process group ``own`` is the batch."""
    if mesh is None or not mesh.distributed:
        return own
    full = gather_rows(own, lo, n_rows, mesh.data_group)
    return torch.cat([full[:lo], own, full[lo + own.shape[0]:]])


def sharded_step(model: nn.Module, opt: torch.optim.Optimizer, loss_fn, has_rows: bool,
                 mesh: DataMesh | None) -> torch.Tensor:
    """One Adam step of the sharded plan: ``loss_fn()`` is the batch's loss,
    whose backward runs where the rank holds rows, then the gradients are
    summed over the data group; returns the loss. Spans: ``train.loss``,
    ``train.backward``, and ``train.adam`` twice (the zero_grad before the
    loss, the step after the gradients' sum)."""
    with phase("train.adam"):
        opt.zero_grad(set_to_none=True)
    with phase("train.loss"):
        loss = loss_fn()
    if has_rows:
        with phase("train.backward"):
            loss.backward()
    all_reduce_grads(model, mesh)
    with phase("train.adam"):
        opt.step()
    return loss


def _distance_batch_loss(emb, dist, idx, weight_offset):
    true_dist = dist.index_select(0, idx).index_select(1, idx)
    return weighted_sqrt_mse(pairwise_l2_exact(emb), true_dist, None, weight_offset)


def distance_steps(embed, model: nn.Module, opt: torch.optim.Optimizer, dist: torch.Tensor,
                   order: torch.Tensor, batch_size: int, weight_offset: float = 1e-6,
                   mesh: DataMesh | None = None, before_step=None) -> torch.Tensor:
    """One epoch of the distance-embedding trainer over ``order`` (item
    indices into ``dist`` rows/cols, on its device), with ``embed(idx)``
    the embeddings of a batch's items; ``before_step()``, when given, runs
    before every batch step on every rank. ``mesh`` is the trainer's grid
    (None or a mesh of one: every row); returns the epoch loss as a device
    scalar. A batch's span ``train.step`` leaves ``before_step()`` out, so
    that a step and a refresh never overlap."""
    model.train()
    total = torch.zeros((), dtype=torch.float32, device=dist.device)
    for idx in torch.split(order, batch_size):
        if before_step is not None:
            before_step()
        with phase("train.step"):
            lo, hi = local_rows(idx.numel(), batch_size, mesh)
            with phase("train.forward"):
                own = (embed(idx[lo:hi]) if hi > lo else
                       torch.zeros((0, model.fc2.out_features), device=dist.device))
            loss = sharded_step(model, opt, lambda: _distance_batch_loss(
                gathered_embeddings(own, lo, idx.numel(), mesh), dist, idx, weight_offset),
                hi > lo, mesh)
            total += loss.detach() * idx.numel()
    return total / max(order.numel(), 1)


def distance_epoch(model: nn.Module, opt: torch.optim.Optimizer, feats: torch.Tensor,
                   dist: torch.Tensor, order: torch.Tensor, batch_size: int,
                   weight_offset: float = 1e-6, mesh: DataMesh | None = None) -> torch.Tensor:
    """``distance_steps`` with the model's forward of ``feats`` rows: dense
    (n, V) vectors, FSW (n, N, k+1) point sets or (n, V) vocab weights."""
    return distance_steps(lambda idx: model(feats.index_select(0, idx)), model, opt, dist,
                          order, batch_size, weight_offset, mesh)


def classifier_epoch(model: nn.Module, opt: torch.optim.Optimizer, feats: torch.Tensor,
                     labels: torch.Tensor, order: torch.Tensor, batch_size: int,
                     mesh: DataMesh | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One epoch of the classifier trainer over ``order``; returns the epoch
    NLL and top-1 accuracy (taken before each batch's step, as the JAX
    runner does) as device scalars; ``mesh`` as in ``distance_steps``."""
    model.train()
    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    correct = torch.zeros((), dtype=torch.int64, device=feats.device)
    for idx in torch.split(order, batch_size):
        with phase("train.step"):
            lo, hi = local_rows(idx.numel(), batch_size, mesh)
            with phase("train.forward"):
                log_probs = model(feats.index_select(0, idx[lo:hi]))
            y = labels.index_select(0, idx[lo:hi])
            loss = sharded_step(model, opt, lambda: nll_sum(log_probs, y) / idx.numel(), True,
                                mesh)
            total += loss.detach() * idx.numel()
            correct += (log_probs.detach().argmax(dim=1) == y).sum()
    sums = data_sum_(torch.stack([total.double(), correct.double()]), mesh)
    n = max(order.numel(), 1)
    return sums[0].float() / n, sums[1].to(torch.float32) / n


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
