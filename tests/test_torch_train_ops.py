"""The training ops of the port against the JAX package's: the exact pairwise
L2 (values and gradients, duplicate rows included), the three losses with
and without masks, and the step learning-rate schedule.

Values compare at rtol 1e-6 (fp32 elementwise work in another order);
gradients at rtol 1e-5 / atol 1e-6 (sums of B terms in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.ops.losses import chunks_weighted_sqrt_mse as jax_chunks_weighted_sqrt_mse
from kf2vecfsw_tpu.ops.losses import nll_loss as jax_nll_loss
from kf2vecfsw_tpu.ops.losses import weighted_sqrt_mse as jax_weighted_sqrt_mse
from kf2vecfsw_tpu.ops.pairwise import pairwise_l2_exact as jax_pairwise_l2_exact
from kf2vecfsw_tpu.train.schedule import step_lr as jax_step_lr
from kf2vecfsw_tpu_torch.ops.losses import chunks_weighted_sqrt_mse, nll_loss, weighted_sqrt_mse
from kf2vecfsw_tpu_torch.ops.pairwise import pairwise_l2_exact
from kf2vecfsw_tpu_torch.train.schedule import step_lr


def _rows_with_duplicates(seed, b=9, e=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, e)).astype(np.float32)
    x[3] = x[0]  # off-diagonal pairs at distance exactly 0
    x[7] = x[0]
    x[5] = x[2]
    return x


def _true_dist(seed, b):
    rng = np.random.default_rng(seed + 100)
    d = np.abs(rng.normal(size=(b, b))).astype(np.float32)
    d = d + d.T
    np.fill_diagonal(d, 0)
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_l2_exact_values_and_gradient_match_jax(seed):
    x = _rows_with_duplicates(seed)
    d = _true_dist(seed, x.shape[0])
    got = pairwise_l2_exact(torch.from_numpy(x))
    ref = np.asarray(jax_pairwise_l2_exact(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    assert got[0, 3] == 0 and got[0, 7] == 0 and got[2, 5] == 0 and (torch.diag(got) == 0).all()

    # gradient of the training loss through the distances, duplicates included
    xt = torch.from_numpy(x).requires_grad_(True)
    weighted_sqrt_mse(pairwise_l2_exact(xt), torch.from_numpy(d)).backward()
    g_ref = jax.grad(lambda v: jax_weighted_sqrt_mse(jax_pairwise_l2_exact(v), jnp.asarray(d)))(
        jnp.asarray(x))
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-6)

    # the bare distances' gradient is finite and zero where a pair coincides
    xt2 = torch.from_numpy(x).requires_grad_(True)
    pairwise_l2_exact(xt2)[[0, 0, 2], [3, 7, 5]].sum().backward()
    assert torch.isfinite(xt2.grad).all() and (xt2.grad == 0).all()
    g2 = jax.grad(lambda v: jax_pairwise_l2_exact(v)[jnp.array([0, 0, 2]),
                                                     jnp.array([3, 7, 5])].sum())(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(g2), 0.0)


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    rng = np.random.default_rng(3)
    b, c = 7, 5
    md = np.abs(rng.normal(size=(b, b))).astype(np.float32)
    d = _true_dist(3, b)
    logits = rng.normal(size=(b, c)).astype(np.float32)
    log_probs = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    labels = rng.integers(0, c, size=b)
    item_mask = np.arange(b) < 5 if masked else None
    pair_mask = item_mask[:, None] & item_mask[None, :] if masked else None
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731

    got = weighted_sqrt_mse(t(md), t(d), t(pair_mask))
    ref = jax_weighted_sqrt_mse(j(md), j(d), j(pair_mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    got = chunks_weighted_sqrt_mse(t(md), t(d), t(pair_mask))
    ref = jax_chunks_weighted_sqrt_mse(j(md), j(d), j(pair_mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    got = nll_loss(t(log_probs), t(labels), t(item_mask))
    ref = jax_nll_loss(j(log_probs), j(labels), j(item_mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    if masked:  # the masked mean is the plain mean over what the mask keeps
        keep = np.flatnonzero(item_mask)
        np.testing.assert_allclose(
            float(nll_loss(t(log_probs[keep]), t(labels[keep]))), float(got), rtol=1e-6)
        sub = np.ix_(keep, keep)
        np.testing.assert_allclose(
            float(weighted_sqrt_mse(t(md[sub]), t(d[sub]))),
            float(weighted_sqrt_mse(t(md), t(d), t(pair_mask))), rtol=1e-6)


@pytest.mark.parametrize("lr0,lr_min,decay", [(1e-5, 3e-6, 2000), (1e-3, 1e-6, 50.0)])
def test_step_lr_matches_jax(lr0, lr_min, decay):
    for epoch in range(0, 1001):
        assert step_lr(epoch, lr0, lr_min, decay) == jax_step_lr(epoch, lr0, lr_min, decay)
    assert step_lr(0, lr0, lr_min, decay) == lr0
    assert step_lr(100, lr0, lr_min, decay) == step_lr(1, lr0, lr_min, decay)
    assert step_lr(101, lr0, lr_min, decay) < step_lr(100, lr0, lr_min, decay)
