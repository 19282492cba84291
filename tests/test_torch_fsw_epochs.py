"""One epoch of each FSW training route of the port against the JAX runner it
replaces, from the same params and in the JAX runner's own item order, and
the lazy route's refresh cadence against the JAX span path.

n = 10 items in batches of B = 4 (4, 4 and a partial tail of 2: three Adam
steps; the JAX runner's fourth, all-padding batch is an exact no-op), k=4
(V=136), base_dim 2, 16 slices, H 32, E 16, lr 1e-4.

The epoch loss agrees within rtol 1e-4: the FSW forward carries the
tolerance of ``tests/test_torch_fsw.py`` into the loss. Params and Adam's
moments after the epoch are held to the sign-flip bound of
``tests/test_torch_train_step.py``: atol = 2 * 1.02 * lr * steps + rtol 1e-4,
the median difference of every non-bias leaf below 1e-3 of that bound (a
gradient element that rounds to opposite signs in XLA:CPU and PyTorch moves
a weight by up to 2 * 1.02 * lr a step; biases are rounding noise of a
loss that ignores a common shift of the embeddings)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.models import fsw as jfsw
from kf2vecfsw_tpu.parallel.mesh import MODEL_AXIS, make_mesh, shard_params
from kf2vecfsw_tpu.train.fsw_lazy import FSWLazyEpochRunner, FSWLazyPerGenomeRunner
from kf2vecfsw_tpu.train.step import DistanceEpochRunner, _packed_perm, adam_init
from kf2vecfsw_tpu_torch.models.mlp import adam_state_to_jax, params_from_jax, params_to_jax
from kf2vecfsw_tpu_torch.train.fsw_lazy import LazyPlanes, lazy_distance_epoch
from kf2vecfsw_tpu_torch.train.step import distance_epoch, make_adam

from .test_torch_fsw_train import _leaves, _params, _point_sets, _vocab_weights

torch.set_num_threads(1)

N, B, K = 10, 4, 4
STEPS = 3
LR = 1e-4
ADAM_STEP = 1.02  # bound of a bias-corrected Adam step over its first steps, in lr
SPECS = jfsw.fsw_dist_embed_specs(MODEL_AXIS)


def _assert_trees_close(got, ref, lr=LR, steps=STEPS):
    atol = 2 * ADAM_STEP * lr * steps
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-4, atol=atol, err_msg=name)
        if not name.endswith("/b"):
            assert np.median(np.abs(got[name] - ref[name])) <= 1e-3 * atol, name


def _dist(seed, n=N):
    rng = np.random.default_rng(seed)
    d = np.abs(rng.normal(size=(n, n))).astype(np.float32)
    d = d + d.T
    np.fill_diagonal(d, 0)
    return d


def _feats(route, seed, n=N):
    if route.endswith("shared"):
        return _vocab_weights(seed, n)
    rng = np.random.default_rng(seed)
    return _point_sets(seed, lengths=tuple(int(m) for m in rng.integers(12, 48, n)))


def _jax_runner(route, mesh, n=N, refresh=0):
    if route == "exact_shared":
        return DistanceEpochRunner(mesh, jfsw.make_fsw_shared_apply(K), SPECS, n, B)
    if route == "exact_pergenome":
        return DistanceEpochRunner(mesh, jfsw.fsw_dist_embed_apply, SPECS, n, B)
    cls = FSWLazyEpochRunner if route == "lazy_shared" else FSWLazyPerGenomeRunner
    return cls(mesh, K, SPECS, n, B, refresh_steps=refresh)


def _port_epoch(route, model, opt, x, dist, order, refresh=0):
    if route.startswith("exact"):
        return distance_epoch(model, opt, x, dist, order, B)
    planes = LazyPlanes(x, route == "lazy_shared", refresh, -(-N // B), group=4)
    loss = lazy_distance_epoch(model, opt, planes, dist, order, B)
    assert planes.refreshes == (STEPS if refresh == 1 else 1)
    return loss


@pytest.mark.parametrize("route,refresh", [
    ("exact_shared", 0), ("exact_pergenome", 0),
    ("lazy_shared", 1), ("lazy_shared", 8), ("lazy_pergenome", 1), ("lazy_pergenome", 8)])
def test_fsw_epoch_matches_jax_runner(route, refresh):
    seed = 20 + refresh
    x, dist = _feats(route, seed), _dist(seed)
    params = _params(seed)
    mesh = make_mesh(1, 1)
    runner = _jax_runner(route, mesh, refresh=refresh)
    assert runner.n_batches == STEPS + 1  # one all-padding batch
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    order = np.asarray(_packed_perm(key, runner.n_bucket, N))[:N]
    assert sorted(order) == list(range(N))
    p_jax = shard_params(params, SPECS, mesh)
    p_jax, o_jax, loss_jax = runner.run_epoch(p_jax, adam_init(p_jax), runner.pad_items(x),
                                              runner.pad_dist(dist), key, LR)

    model = params_from_jax(params)
    opt = make_adam(model, LR)
    loss = _port_epoch(route, model, opt, torch.from_numpy(x), torch.from_numpy(dist),
                       torch.from_numpy(order.astype(np.int64)), refresh)
    np.testing.assert_allclose(float(loss), float(loss_jax), rtol=1e-4)
    _assert_trees_close(params_to_jax(model), jax.device_get(p_jax))
    state, o_jax = adam_state_to_jax(opt, model), jax.device_get(o_jax)
    assert int(state["count"]) == int(o_jax["count"]) == STEPS
    _assert_trees_close(state["mu"], o_jax["mu"])
    _assert_trees_close(state["nu"], o_jax["nu"])


@pytest.mark.parametrize("route", ["shared", "pergenome"])
def test_lazy_epoch_at_refresh_1_equals_the_exact_epoch(route):
    """Refreshing before every step is the exact route: the same loss and,
    within the sign-flip bound, the same params after the epoch."""
    x, dist = _feats(route, 30), _dist(30)
    order = torch.randperm(N, generator=torch.Generator().manual_seed(30))
    out = []
    for name in (f"exact_{route}", f"lazy_{route}"):
        model = params_from_jax(_params(30))
        opt = make_adam(model, LR)
        loss = _port_epoch(name, model, opt, torch.from_numpy(x), torch.from_numpy(dist), order,
                           refresh=1)
        out.append((float(loss), params_to_jax(model)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    _assert_trees_close(out[1][1], out[0][1])


class _CountingLazyRunner(FSWLazyEpochRunner):
    """The JAX lazy runner with a host callback in its refresh, which runs
    inside the span's device loop."""

    def __init__(self, *args, **kw):
        self.refresh_calls = []
        super().__init__(*args, **kw)

    def _refresh_impl(self, params, feats):
        jax.debug.callback(lambda: self.refresh_calls.append(1))
        return super()._refresh_impl(params, feats)


@pytest.mark.parametrize("refresh", [1, 3, 4, 8])
def test_refresh_cadence_equals_the_jax_span_path(refresh):
    """4 epochs of 2 batches (8 items, B = 4), as one JAX span of 4 epochs:
    R = 4 refreshes before epochs 0 and 2, R = 1 before every step, R = 3
    before every epoch (the interval rounds down to whole epochs) and R = 8
    once."""
    n, epochs = 8, 4
    w, dist = _vocab_weights(40, n), _dist(40, n)
    mesh = make_mesh(1, 1)
    runner = _CountingLazyRunner(mesh, K, SPECS, n, B, refresh_steps=refresh)
    assert runner.n_batches == 2
    params = shard_params(_params(40), SPECS, mesh)
    best = (jax.tree.map(jnp.copy, params), jnp.float32(np.inf), jnp.int32(-1))
    _, _, _, losses = runner.run_epoch_span(params, adam_init(params), best, jnp.asarray(w),
                                            jnp.asarray(dist), jax.random.PRNGKey(40), 0, epochs,
                                            (1e-3, 1e-4, 2000.0, 0.1, 100))
    assert np.isfinite(np.asarray(losses)).all()

    model = params_from_jax(_params(40))
    opt = make_adam(model, 1e-3)
    planes = LazyPlanes(torch.from_numpy(w), True, refresh, 2, group=8)
    gen = torch.Generator().manual_seed(40)
    for _ in range(epochs):
        loss = lazy_distance_epoch(model, opt, planes, torch.from_numpy(dist),
                                   torch.randperm(n, generator=gen), B)
        assert np.isfinite(float(loss))
    assert planes.refreshes == len(runner.refresh_calls) == {1: 8, 3: 4, 4: 2, 8: 1}[refresh]
