"""One epoch of each port trainer against the JAX runner it replaces, from the
same params and in the JAX runner's own item order: n = 10 items in
batches of B = 4 (4, 4 and a partial tail of 2, so three Adam steps; the
JAX runner's fourth, all-padding batch is an exact no-op).

The epoch loss (and the classifier's accuracy) agree within rtol 1e-5.
Params and Adam's moments after the epoch agree within
atol = 2 * 1.02 * lr * steps + rtol 1e-4 * |value|: Adam's first steps move a
weight by about lr * sign(grad) (a bias-corrected step is at most 1.015 lr
over the first six steps), so a gradient element that rounds to opposite
signs in XLA:CPU and PyTorch moves a weight by up to 2 * 1.02 * lr per
step. The bulk must be far tighter: the median difference of every weight
matrix stays below 1e-3 of that bound, and the step counts are equal.

The distance model's biases are held to the bound alone: the pairwise
distances do not change when every embedding moves by the same vector, so
the gradient of fc2's bias, and of fc1's for a unit active on the whole
batch, sums to zero and is rounding noise, which Adam's first steps turn
into +-lr. The same noise in the distance trainer's epoch loss grows with
the learning rate, so that test runs at the default lr 1e-5 and at 1e-4."""

import jax
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.models.mlp import (
    classifier_apply,
    classifier_specs,
    dist_embed_apply,
    dist_embed_specs,
    init_classifier,
    init_dist_embed,
)
from kf2vecfsw_tpu.parallel.mesh import MODEL_AXIS, make_mesh, shard_params
from kf2vecfsw_tpu.train.step import (
    ClassifierEpochRunner,
    DistanceEpochRunner,
    _packed_perm,
    adam_init,
)
from kf2vecfsw_tpu_torch.models.mlp import (
    adam_state_from_jax,
    adam_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from kf2vecfsw_tpu_torch.train.step import classifier_epoch, distance_epoch, make_adam

torch.set_num_threads(1)

N, B, V, H, E, C = 10, 4, 32, 16, 8, 3
STEPS = 3
ADAM_STEP = 1.02  # bound of a bias-corrected Adam step over its first steps, in lr


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def _assert_trees_close(got, ref, lr, noisy_biases=False):
    atol = 2 * ADAM_STEP * lr * STEPS
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-4, atol=atol, err_msg=name)
        if noisy_biases and name.endswith("/b"):
            continue
        assert np.median(np.abs(got[name] - ref[name])) <= 1e-3 * atol, name


def _jax_order(runner, key):
    perm = np.asarray(_packed_perm(key, runner.n_bucket, N))
    assert sorted(perm[:N]) == list(range(N))
    return perm[:N]


def _problem(seed):
    rng = np.random.default_rng(seed)
    feats = (rng.random((N, V)).astype(np.float32) * 3.0)
    d = np.abs(rng.normal(size=(N, N))).astype(np.float32)
    d = d + d.T
    np.fill_diagonal(d, 0)
    labels = rng.integers(0, C, size=N).astype(np.int32)
    return feats, d, labels


@pytest.mark.parametrize("seed,lr", [(0, 1e-4), (1, 1e-5)])
def test_distance_epoch_matches_jax_runner(seed, lr):
    feats, dist, _ = _problem(seed)
    mesh = make_mesh(1, 1)
    key = jax.random.PRNGKey(seed)
    params = jax.device_get(init_dist_embed(key, V, H, E))
    specs = dist_embed_specs(MODEL_AXIS)
    runner = DistanceEpochRunner(mesh, dist_embed_apply, specs, N, B)
    assert runner.n_batches == STEPS + 1  # one all-padding batch
    epoch_key = jax.random.fold_in(key, 7)
    order = _jax_order(runner, epoch_key)
    p_jax = shard_params(params, specs, mesh)
    p_jax, o_jax, loss_jax = runner.run_epoch(p_jax, adam_init(p_jax), feats, dist, epoch_key, lr)

    model = params_from_jax(params)
    opt = make_adam(model, lr)
    loss = distance_epoch(model, opt, torch.from_numpy(feats), torch.from_numpy(dist),
                          torch.from_numpy(order.astype(np.int64)), B)
    np.testing.assert_allclose(float(loss), float(loss_jax), rtol=1e-5)
    _assert_trees_close(params_to_jax(model), jax.device_get(p_jax), lr, noisy_biases=True)
    state = adam_state_to_jax(opt, model)
    o_jax = jax.device_get(o_jax)
    assert int(state["count"]) == int(o_jax["count"]) == STEPS
    _assert_trees_close(state["mu"], o_jax["mu"], lr, noisy_biases=True)
    _assert_trees_close(state["nu"], o_jax["nu"], lr, noisy_biases=True)


@pytest.mark.parametrize("seed,lr", [(2, 1e-3), (3, 1e-2)])
def test_classifier_epoch_matches_jax_runner(seed, lr):
    feats, _, labels = _problem(seed)
    mesh = make_mesh(1, 1)
    key = jax.random.PRNGKey(seed)
    params = jax.device_get(init_classifier(key, V, H, C))
    specs = classifier_specs(MODEL_AXIS)
    runner = ClassifierEpochRunner(mesh, classifier_apply, specs, N, B)
    epoch_key = jax.random.fold_in(key, 3)
    order = _jax_order(runner, epoch_key)
    p_jax = shard_params(params, specs, mesh)
    p_jax, o_jax, loss_jax, acc_jax = runner.run_epoch(
        p_jax, adam_init(p_jax), feats, labels, epoch_key, lr)

    model = params_from_jax(params)
    opt = make_adam(model, lr)
    loss, acc = classifier_epoch(model, opt, torch.from_numpy(feats),
                                 torch.from_numpy(labels.astype(np.int64)),
                                 torch.from_numpy(order.astype(np.int64)), B)
    np.testing.assert_allclose(float(loss), float(loss_jax), rtol=1e-5)
    np.testing.assert_allclose(float(acc), float(acc_jax), rtol=1e-5)
    _assert_trees_close(params_to_jax(model), jax.device_get(p_jax), lr)
    state = adam_state_to_jax(opt, model)
    o_jax = jax.device_get(o_jax)
    assert int(state["count"]) == int(o_jax["count"]) == STEPS
    _assert_trees_close(state["mu"], o_jax["mu"], lr)
    _assert_trees_close(state["nu"], o_jax["nu"], lr)


def test_adam_state_carries_across_both_ways():
    """A JAX Adam state loaded into torch.optim.Adam, stepped once there, equals
    the JAX update of the same state with the same gradients."""
    from kf2vecfsw_tpu.train.step import adam_update

    rng = np.random.default_rng(5)
    params = jax.device_get(init_dist_embed(jax.random.PRNGKey(5), V, H, E))
    state = {"count": np.int32(4),
             "mu": jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 1e-2, params),
             "nu": jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32) * 1e-4, params)}
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 1e-2, params)
    model = params_from_jax(params)
    opt = make_adam(model, 1e-3)
    adam_state_from_jax(opt, model, state)
    back = adam_state_to_jax(opt, model)
    assert int(back["count"]) == 4
    for (n1, a), (n2, b) in zip(_leaves(back["mu"]), _leaves(state["mu"])):
        assert n1 == n2 and np.array_equal(a, b)
    g = params_from_jax(grads)
    for p, gp in zip(model.parameters(), g.parameters()):
        p.grad = gp.detach().clone()
    opt.step()
    p_ref, s_ref = adam_update(params, grads, state, 1e-3)
    np.testing.assert_allclose(dict(_leaves(params_to_jax(model)))["fc1/w"],
                               np.asarray(p_ref["fc1"]["w"]), rtol=1e-6, atol=1e-7)
    after = adam_state_to_jax(opt, model)
    assert int(after["count"]) == int(s_ref["count"]) == 5
    for (_, a), (_, b) in zip(_leaves(after["nu"]), _leaves(jax.device_get(s_ref["nu"]))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
