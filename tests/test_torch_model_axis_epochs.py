"""One epoch on the grids (1, 2) and (2, 2) of gloo ranks on the CPU, from
carried JAX weights and in the JAX runner's own item order (its
``_packed_perm``, as ``test_torch_parallel.py`` draws it): n = 13 items in
batches of B = 5 (5, 5 and 3; at n_data = 2 data index 1 holds only
padding in the last batch), at the default learning rate 1e-5 (the
rounding noise of the distance model's epoch loss grows with the learning
rate: ``test_torch_train_step.py``).

- Dense model and classifier: held to the JAX runner on the same
  ``make_mesh(n_data, n_model)``: the epoch loss (and accuracy) within rtol
  1e-5, the gathered params within ``test_torch_train_step``'s Adam
  sign-flip bound. The JAX runner's gradients of fc1 and of fc2's / fc3's
  weight are n_model times the true ones there (its ``shard_map`` runs with
  ``check_rep`` off, so the transpose of the forward's ``psum`` is another
  ``psum``); Adam divides the first moment by the root of the second, so a
  scaled gradient changes only the weight of its eps, far inside the bound.
- FSW on every route (exact and lazy at R = 8, shared-vocab and
  per-genome): held to the JAX runner on ``make_mesh(n_data, 1)``, the
  loss within rtol 1e-4 (``test_torch_fsw_epochs``' tolerance), and to the
  port's one process, the loss within rtol 1e-5; the gathered params
  within the Adam bound of both. Not to a JAX mesh with n_model > 1, whose
  replicated ``lookup`` takes a gradient of its own rank's slices only,
  n_model times, and drifts apart across the model ranks.
- Replicas after the epoch: each rank's cut bit-equal to the other ranks'
  of its model index (its data group); every whole parameter (the FSW
  lookup, the row-parallel biases, FSW's fc1 bias and fc2) bit-equal on
  every rank; the gathered params bit-equal on every rank."""

import jax
import numpy as np
import pytest

from kf2vecfsw_tpu.models import fsw as jfsw
from kf2vecfsw_tpu.models.mlp import (
    classifier_apply,
    classifier_specs,
    dist_embed_apply,
    dist_embed_specs,
)
from kf2vecfsw_tpu.parallel.mesh import MODEL_AXIS, make_mesh, shard_params
from kf2vecfsw_tpu.train.fsw_lazy import FSWLazyEpochRunner, FSWLazyPerGenomeRunner
from kf2vecfsw_tpu.train.step import (
    ClassifierEpochRunner,
    DistanceEpochRunner,
    _packed_perm,
    adam_init,
)
from kf2vecfsw_tpu_torch.models.mlp import model_axis_specs, params_from_jax

from .test_torch_model_axis import K, MODELS, REFRESH, one_process, problem, run_grid_epochs
from .test_torch_train_step import _assert_trees_close, _leaves

N, B, LR = 13, 5, 1e-5
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}


def jax_runner(name, jmesh):
    if name == "dense":
        return DistanceEpochRunner(jmesh, dist_embed_apply, dist_embed_specs(MODEL_AXIS), N, B)
    if name == "classifier":
        return ClassifierEpochRunner(jmesh, classifier_apply, classifier_specs(MODEL_AXIS), N, B)
    specs = jfsw.fsw_dist_embed_specs(MODEL_AXIS)
    if name == "fsw_shared":
        return DistanceEpochRunner(jmesh, jfsw.make_fsw_shared_apply(K), specs, N, B)
    if name == "fsw_pergenome":
        return DistanceEpochRunner(jmesh, jfsw.fsw_dist_embed_apply, specs, N, B)
    cls = FSWLazyEpochRunner if name == "fsw_lazy_shared" else FSWLazyPerGenomeRunner
    return cls(jmesh, K, specs, N, B, refresh_steps=REFRESH)


def jax_epoch(name, kind, feats, target, params, jmesh, seed):
    """(order, loss, acc, params) of the JAX runner's epoch on ``jmesh``."""
    runner = jax_runner(name, jmesh)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    order = np.asarray(_packed_perm(key, runner.n_bucket, N))[:N].astype(np.int64)
    p = shard_params(params, runner_specs(name), jmesh)
    if kind == "classifier":
        p, _, loss, acc = runner.run_epoch(p, adam_init(p), feats, target.astype(np.int32), key,
                                           LR)
        return order, float(loss), float(acc), jax.device_get(p)
    p, _, loss = runner.run_epoch(p, adam_init(p), runner.pad_items(feats),
                                  runner.pad_dist(target), key, LR)
    return order, float(loss), float("nan"), jax.device_get(p)


def runner_specs(name):
    if name == "dense":
        return dist_embed_specs(MODEL_AXIS)
    if name == "classifier":
        return classifier_specs(MODEL_AXIS)
    return jfsw.fsw_dist_embed_specs(MODEL_AXIS)


@pytest.fixture(scope="module")
def grid_epochs(tmp_path_factory):
    out = {}
    for tag, (n_data, n_model) in GRIDS.items():
        problems, refs = [], {}
        for i, name in enumerate(MODELS):
            seed = 60 + i
            kind, feats, target, params, refresh = problem(name, seed, N)
            fsw = name.startswith("fsw")
            jmesh = make_mesh(n_data, 1 if fsw else n_model)
            order, *jax_ref = jax_epoch(name, kind, feats, target, params, jmesh, seed)
            problems.append((name, kind, feats, target, params, refresh, order))
            refs[name] = (jax_ref, one_process(kind, feats, target, params, refresh, order, B, LR))
        got = run_grid_epochs(tmp_path_factory.mktemp(tag), n_data, n_model, problems, B, LR)
        out[tag] = {name: (got[name], *refs[name]) for name in MODELS}
    return out


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_epoch_on_a_grid_matches_the_jax_runner(grid_epochs, grid, model):
    ranks, (loss_jax, acc_jax, p_jax), (loss_one, _, p_one, _) = grid_epochs[grid][model]
    loss, acc, params, _, _ = ranks[0]
    if model.startswith("fsw"):  # the JAX runner on make_mesh(n_data, 1) and one process
        np.testing.assert_allclose(loss, loss_jax, rtol=1e-4)
        np.testing.assert_allclose(loss, loss_one, rtol=1e-5)
        _assert_trees_close(params, p_jax, LR, noisy_biases=True)
        _assert_trees_close(params, p_one, LR, noisy_biases=True)
        return
    np.testing.assert_allclose(loss, loss_jax, rtol=1e-5)
    if model == "classifier":
        np.testing.assert_allclose(acc, acc_jax, rtol=1e-5)
    _assert_trees_close(params, p_jax, LR, noisy_biases=model == "dense")


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_replicas_after_an_epoch_on_a_grid(grid_epochs, grid, model):
    ranks = grid_epochs[grid][model][0]
    n_model = GRIDS[grid][1]
    full = dict(params_from_jax(ranks[0][2]).named_parameters())
    specs = model_axis_specs(params_from_jax(ranks[0][2]))
    gathered = [dict(_leaves(r[2])) for r in ranks]
    for r, (_, _, _, _, local) in enumerate(ranks):
        peer = ranks[r % n_model][4]  # data index 0 at this rank's model index
        for name, value in local.items():
            assert np.array_equal(value, peer[name]), (r, name)
            dim = specs[name]
            if dim is None:
                assert np.array_equal(value, ranks[0][4][name]), (r, name)
            else:
                assert value.shape[dim] * n_model == full[name].shape[dim], (r, name)
        for name, value in gathered[r].items():
            assert np.array_equal(value, gathered[0][name]), (r, name)
