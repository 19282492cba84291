"""Training losses (the port's copy of the JAX package's ``ops/losses.py``;
reference: losses.py).

- weighted_sqrt_mse: Loss.my_mse_loss (losses.py:13-49):
  mean( (d_model - sqrt(d_true))^2 / (d_true + 1e-6) )
- chunks_weighted_sqrt_mse: Loss_chunks (losses.py:58-117), the same with
  a weight of 1 / (d_true + 1000), for the chunk distance trainer
- nll_loss: torch nn.NLLLoss over log_softmax outputs
  (train_classifier_model.py:278); nll_sum, its sum
- contigs_weighted_sqrt_mse and lambda_weighted_sqrt_mse: the reference's
  Loss_for_contigs and Loss_wlambda, which no trainer uses

Both take an optional pair/sample mask; masked-out entries drop out of the
mean, which is taken over the entries that remain.
"""

from __future__ import annotations

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.mean(values)
    total = torch.sum(torch.where(mask, values, torch.zeros_like(values)))
    return total / torch.clamp(torch.sum(mask), min=1)


def weighted_sqrt_mse(model_dist: torch.Tensor, true_dist: torch.Tensor,
                      pair_mask: torch.Tensor | None = None,
                      weight_offset: float = 1e-6) -> torch.Tensor:
    weight = 1.0 / (true_dist + weight_offset)
    v = (model_dist - torch.sqrt(true_dist)) ** 2 * weight
    return _masked_mean(v, pair_mask)


def chunks_weighted_sqrt_mse(model_dist: torch.Tensor, true_dist: torch.Tensor,
                             pair_mask: torch.Tensor | None = None) -> torch.Tensor:
    return weighted_sqrt_mse(model_dist, true_dist, pair_mask, weight_offset=1000.0)


def _nll_terms(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.gather(log_probs, 1, labels[:, None].long())[:, 0]


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             sample_mask: torch.Tensor | None = None) -> torch.Tensor:
    return _masked_mean(_nll_terms(log_probs, labels), sample_mask)


def nll_sum(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The NLL summed over the rows: a rank's share of a batch's loss in the
    sharded plan, before the division by the batch's count."""
    return torch.sum(_nll_terms(log_probs, labels))


def contigs_weighted_sqrt_mse(model_dist: torch.Tensor, true_dist: torch.Tensor,
                              ma_dist: torch.Tensor, a_const: float = 0.0) -> torch.Tensor:
    """Loss_for_contigs (losses.py:120-182): within-genome pairs (d_true ==
    0) weighted by A / (ma + 1e-6), between-genome pairs by
    1 / (sqrt(d_true) + 1e-6); the target is sqrt(d_true)."""
    sqrt_true = torch.sqrt(true_dist)
    weight = torch.where(sqrt_true == 0.0, a_const / (ma_dist + 1e-6), 1.0 / (sqrt_true + 1e-6))
    return torch.mean((model_dist - sqrt_true) ** 2 * weight)


def lambda_weighted_sqrt_mse(model_dist: torch.Tensor, true_dist: torch.Tensor,
                             lam: torch.Tensor) -> torch.Tensor:
    """Loss_wlambda (losses.py:184-253): per-sample weights lam on both axes
    of the weighted squared error, over the off-diagonal element count."""
    weight = 1.0 / (true_dist + 1e-6)
    v = (model_dist - torch.sqrt(true_dist)) ** 2 * weight
    s = torch.sum(lam[None, :] * v, dim=1)
    return torch.sum(lam * s) / max(v.numel() - v.shape[0], 1)
