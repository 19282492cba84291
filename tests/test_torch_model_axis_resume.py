"""Trainer states across grids and packages: a state autosaved on the grid
(1, 2) of gloo ranks on the CPU holds full-size params and Adam moments (the
trainers gather them before the coordinator writes), which the JAX
package's reader reads as the port's does; it resumes in one process and on
the grid (1, 2) (cut again); and a state the JAX package wrote resumes on
the grid (1, 2). For the dense model, the classifier and FSW (lazy
shared-vocab and exact per-genome), n = 13 items in batches of 5, lr 1e-5,
one epoch, then a second from the state.

- The state after the grid's epoch: params equal to the gathered params
  and the best params to the full ones the epoch started from, bit for
  bit; every Adam moment full size, with one step count (3 steps).
- Resumed in one process, its Adam moments are the state's bit for bit;
  the second epoch resumed on the grid takes the loss of the one resumed
  in one process within rtol 1e-5, its params within
  ``test_torch_train_step``'s Adam sign-flip bound, its step count 6.
- The JAX package's state (its runner's epoch on ``make_mesh(1, 1)``)
  resumed on the grid and in one process: the same checks."""

import jax
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.parallel.mesh import make_mesh, shard_params
from kf2vecfsw_tpu.train.resume import load_trainer_state as jax_load_trainer_state
from kf2vecfsw_tpu.train.resume import save_trainer_state as jax_save_trainer_state
from kf2vecfsw_tpu.train.step import adam_init
from kf2vecfsw_tpu_torch.models.mlp import adam_state_to_jax, params_from_jax, params_to_jax
from kf2vecfsw_tpu_torch.train.fsw_lazy import LazyPlanes, lazy_distance_epoch
from kf2vecfsw_tpu_torch.train.resume import load_trainer_state, start_or_resume
from kf2vecfsw_tpu_torch.train.step import classifier_epoch, distance_epoch

from .test_torch_model_axis import problem, run_grid_epochs
from .test_torch_model_axis_epochs import B, LR, N, jax_runner, runner_specs
from .test_torch_train_step import _assert_trees_close, _leaves

torch.set_num_threads(1)

MODELS = ("dense", "classifier", "fsw_lazy_shared", "fsw_pergenome")
STEPS = 3  # batches of one epoch


def _orders(seed):
    rng = np.random.default_rng(seed)
    return rng.permutation(N).astype(np.int64), rng.permutation(N).astype(np.int64)


def _resumed_epoch(kind, feats, target, params, refresh, order, state_path):
    """(loss, params, opt state) of an epoch in one process from the trainer
    state at ``state_path``."""
    st = start_or_resume(params_from_jax(params), torch.Generator(), N, str(state_path), True,
                         None, LR, torch.device("cpu"))
    x, y, o = torch.from_numpy(feats), torch.from_numpy(target), torch.from_numpy(order)
    if kind == "classifier":
        loss, _ = classifier_epoch(st.model, st.opt, x, y, o, B)
    elif refresh:
        planes = LazyPlanes(x, x.dim() == 2, refresh, -(-N // B), 4)
        loss = lazy_distance_epoch(st.model, st.opt, planes, y, o, B)
    else:
        loss = distance_epoch(st.model, st.opt, x, y, o, B)
    return float(loss), params_to_jax(st.model), adam_state_to_jax(st.opt, st.model), st


def _jax_state(name, kind, feats, target, params, path):
    """The JAX runner's epoch on make_mesh(1, 1), autosaved by the JAX package."""
    jmesh = make_mesh(1, 1)
    runner = jax_runner(name, jmesh)
    key = jax.random.PRNGKey(7)
    p = shard_params(params, runner_specs(name), jmesh)
    if kind == "classifier":
        p, opt, loss, _ = runner.run_epoch(p, adam_init(p), feats, target.astype(np.int32), key,
                                           LR)
    else:
        p, opt, loss = runner.run_epoch(p, adam_init(p), runner.pad_items(feats),
                                        runner.pad_dist(target), key, LR)
    p, opt = jax.device_get(p), jax.device_get(opt)
    jax_save_trainer_state(str(path), 0, p, opt, p, float(loss), 0)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    root = tmp_path_factory.mktemp("states")
    first, second = [], []
    setup = {}
    for i, name in enumerate(MODELS):
        kind, feats, target, params, refresh = problem(name, 80 + i, N)
        order1, order2 = _orders(80 + i)
        grid_state, jax_state = root / f"{name}_grid_state.npz", root / f"{name}_jax_state.npz"
        _jax_state(name, kind, feats, target, params, jax_state)
        setup[name] = (kind, feats, target, params, refresh, order2, grid_state, jax_state)
        first.append((name, kind, feats, target, params, refresh, order1))
        for tag, state in (("grid", grid_state), ("jax", jax_state)):
            second.append((f"{name}_{tag}", kind, feats, target, params, refresh, order2,
                            str(state), str(root / f"{name}_{tag}_after.npz")))
    epoch1 = run_grid_epochs(root / "e1", 1, 2, first, B, LR,
                             save_states={n: str(setup[n][6]) for n in MODELS})
    epoch2 = run_grid_epochs(root / "e2", 1, 2, [p[:7] for p in second], B, LR,
                             resume_states={p[0]: p[7] for p in second},
                             save_states={p[0]: p[8] for p in second})
    return root, setup, epoch1, epoch2


@pytest.mark.parametrize("model", MODELS)
def test_a_state_written_on_a_grid_is_full_size(resumed, model):
    _, setup, epoch1, _ = resumed
    grid_state = setup[model][6]
    state = load_trainer_state(str(grid_state))
    jstate = jax_load_trainer_state(str(grid_state))
    gathered = dict(_leaves(epoch1[model][0][2]))
    initial = dict(_leaves(setup[model][3]))  # the best params: the worker keeps its start
    for tree, jtree, want in ((state[1], jstate[1], gathered), (state[3], jstate[3], initial)):
        got = dict(_leaves(tree))
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
            np.testing.assert_array_equal(np.asarray(dict(_leaves(jtree))[name]), got[name])
    assert int(state[2]["count"]) == STEPS
    for m in ("mu", "nu"):
        moments = dict(_leaves(state[2][m]))
        assert {k: v.shape for k, v in moments.items()} == {k: v.shape for k, v in gathered.items()}


@pytest.mark.parametrize("source", ["grid", "jax"])
@pytest.mark.parametrize("model", MODELS)
def test_a_state_resumes_in_one_process_and_on_a_grid(resumed, model, source):
    root, setup, _, epoch2 = resumed
    kind, feats, target, params, refresh, order2, grid_state, jax_state = setup[model]
    state_path = grid_state if source == "grid" else jax_state
    saved = load_trainer_state(str(state_path))
    loss, p_one, opt_one, _ = _resumed_epoch(kind, feats, target, params, refresh, order2,
                                             state_path)
    # resumed in one process: Adam's moments are the state's, bit for bit
    st = start_or_resume(params_from_jax(params), torch.Generator(), N, str(state_path), True,
                         None, LR, torch.device("cpu"))
    carried = adam_state_to_jax(st.opt, st.model)
    assert int(carried["count"]) == int(saved[2]["count"]) == STEPS
    for m in ("mu", "nu"):
        for (name, a), (_, b) in zip(_leaves(carried[m]), _leaves(saved[2][m])):
            np.testing.assert_array_equal(a, b, err_msg=name)
    # resumed on the grid (1, 2): cut again, the same epoch as one process
    ranks = epoch2[f"{model}_{source}"]
    np.testing.assert_allclose(ranks[0][0], loss, rtol=1e-5)
    _assert_trees_close(ranks[0][2], p_one, LR, noisy_biases=True)
    after = load_trainer_state(str(root / f"{model}_{source}_after.npz"))
    assert int(after[2]["count"]) == int(opt_one["count"]) == 2 * STEPS
    _assert_trees_close(after[2]["mu"], opt_one["mu"], LR, noisy_biases=True)
