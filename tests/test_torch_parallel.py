"""The port's sharded batch plan over two gloo ranks on the CPU
(``parallel/mp_check.py`` spawns them), and the launch checks of
``parallel/mesh.py``.

- One epoch at R = 2, B = 5, n = 13 (batches of 5, 5 and 3: the last holds
  real rows on rank 0 only, rank 1 holds only padding) from the same params
  and item order as the JAX runner on ``make_mesh(2, 1)`` (the order comes
  from its ``_packed_perm``, as ``test_torch_train_step.py:_jax_order``
  draws it): the epoch loss (and the classifier's accuracy) within rtol
  1e-5, params within ``test_torch_train_step``'s Adam sign-flip bound.
- The summed gradient of one batch at R = 2 equals one process's within
  rtol 1e-5 (a factor-of-R fault would double it), with a rank of padding
  and without.
- A SLURM or OpenMPI launch of several tasks without MASTER_ADDR raises;
  NCCL with more local ranks than cards raises with the gloo hint, built
  here with no card; a command that does not train over ranks refuses
  more than one."""

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
from kf2vecfsw_tpu_torch.models.mlp import params_from_jax, params_to_jax
from kf2vecfsw_tpu_torch.parallel import mesh
from kf2vecfsw_tpu_torch.parallel.mp_check import launch, worker, write_epoch_problem
from kf2vecfsw_tpu_torch.train.checkpoint import _unflatten
from kf2vecfsw_tpu_torch.train.step import distance_epoch, local_rows, make_adam

from .test_torch_train_step import _assert_trees_close, _leaves

torch.set_num_threads(1)

N, B, V, H, E, C = 13, 5, 32, 16, 8, 3
RANKS = 2
TIMEOUT_S = 60


def _problem(seed):
    rng = np.random.default_rng(seed)
    feats = rng.random((N, V)).astype(np.float32) * 3.0
    d = np.abs(rng.normal(size=(N, N))).astype(np.float32)
    d = d + d.T
    np.fill_diagonal(d, 0)
    labels = rng.integers(0, C, size=N).astype(np.int64)
    return feats, d, labels


def _ranked_epoch(tmp_path, kind, feats, target, order, batch, lr, params):
    """Rank 0's (loss, acc, params, grads) of one epoch over RANKS gloo ranks."""
    problem, out = tmp_path / f"{kind}.npz", tmp_path / f"{kind}_out.npz"
    write_epoch_problem(str(problem), kind, feats, target, order, batch, lr, params)
    launch([worker("epoch") + [str(problem), str(out)]] * RANKS, "gloo", TIMEOUT_S)
    with np.load(out) as data:
        trees = {tag: _unflatten({k.split("::", 1)[1]: data[k] for k in data.files
                                  if k.startswith(f"{tag}::")}) for tag in ("params", "grads")}
        return float(data["loss"]), float(data["acc"]), trees["params"], trees["grads"]


def test_local_rows_pads_at_the_end():
    plan = [local_rows(n, B, mesh.DataMesh(RANKS, r, torch.device("cpu"), True))
            for n in (5, 3) for r in range(RANKS)]
    assert plan == [(0, 3), (3, 5), (0, 3), (3, 3)]  # batch_pad 6, local_b 3
    assert local_rows(5, B, mesh.DataMesh()) == (0, 5)


@pytest.mark.parametrize("seed,lr", [(0, 1e-4), (1, 1e-5)])
def test_distance_plan_matches_jax_runner_on_two_devices(tmp_path, seed, lr):
    feats, dist, _ = _problem(seed)
    jmesh = make_mesh(RANKS, 1)
    key = jax.random.PRNGKey(seed)
    params = jax.device_get(init_dist_embed(key, V, H, E))
    specs = dist_embed_specs(MODEL_AXIS)
    runner = DistanceEpochRunner(jmesh, dist_embed_apply, specs, N, B)
    assert runner.batch_pad == 6 and runner.local_b == 3
    epoch_key = jax.random.fold_in(key, 7)
    order = np.asarray(_packed_perm(epoch_key, runner.n_bucket, N))[:N].astype(np.int64)
    p_jax = shard_params(params, specs, jmesh)
    p_jax, _, loss_jax = runner.run_epoch(p_jax, adam_init(p_jax), feats, dist, epoch_key, lr)

    loss, _, got, _ = _ranked_epoch(tmp_path, "distance", feats, dist, order, B, lr, params)
    np.testing.assert_allclose(loss, float(loss_jax), rtol=1e-5)
    _assert_trees_close(got, jax.device_get(p_jax), lr, noisy_biases=True)


@pytest.mark.parametrize("seed,lr", [(2, 1e-3), (3, 1e-2)])
def test_classifier_plan_matches_jax_runner_on_two_devices(tmp_path, seed, lr):
    feats, _, labels = _problem(seed)
    jmesh = make_mesh(RANKS, 1)
    key = jax.random.PRNGKey(seed)
    params = jax.device_get(init_classifier(key, V, H, C))
    specs = classifier_specs(MODEL_AXIS)
    runner = ClassifierEpochRunner(jmesh, classifier_apply, specs, N, B)
    epoch_key = jax.random.fold_in(key, 3)
    order = np.asarray(_packed_perm(epoch_key, runner.n_bucket, N))[:N].astype(np.int64)
    p_jax = shard_params(params, specs, jmesh)
    p_jax, _, loss_jax, acc_jax = runner.run_epoch(
        p_jax, adam_init(p_jax), feats, labels.astype(np.int32), epoch_key, lr)

    loss, acc, got, _ = _ranked_epoch(tmp_path, "classifier", feats, labels, order, B, lr, params)
    np.testing.assert_allclose(loss, float(loss_jax), rtol=1e-5)
    np.testing.assert_allclose(acc, float(acc_jax), rtol=1e-5)
    _assert_trees_close(got, jax.device_get(p_jax), lr)


@pytest.mark.parametrize("n_items", [5, 3])
def test_distance_gradient_over_two_ranks_is_one_process(tmp_path, n_items):
    """One batch of n_items: 3 + 2 rows, or 3 rows and a rank of padding."""
    feats, dist, _ = _problem(4)
    params = jax.device_get(init_dist_embed(jax.random.PRNGKey(4), V, H, E))
    order = np.arange(n_items, dtype=np.int64)[::-1].copy()
    loss, _, _, grads = _ranked_epoch(tmp_path, "distance", feats, dist, order, B, 1e-4, params)

    model = params_from_jax(params)
    ref_loss = distance_epoch(model, make_adam(model, 1e-4), torch.from_numpy(feats),
                              torch.from_numpy(dist), torch.from_numpy(order), B)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    grad_model = params_from_jax(params)
    with torch.no_grad():
        for g, p in zip(grad_model.parameters(), model.parameters()):
            g.copy_(p.grad)
    ref = dict(_leaves(params_to_jax(grad_model)))
    got = dict(_leaves(grads))
    assert got.keys() == ref.keys()
    # rtol 1e-5 of each gradient element, and of the largest one for the
    # biases of fc2, whose true gradient is zero (rounding noise)
    scale = max(np.abs(v).max() for v in ref.values())
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("cluster", [
    {"SLURM_JOB_ID": "7", "SLURM_NTASKS": "2", "SLURM_PROCID": "0"},
    {"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "1"},
])
def test_cluster_launch_without_master_addr_raises(monkeypatch, cluster):
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    for name, value in cluster.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match="without MASTER_ADDR"):
        mesh.initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_single_process_joins_nothing(monkeypatch):
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert mesh.initialize_distributed(device="cpu") is False
    assert mesh.data_mesh(torch.device("cpu")) == mesh.DataMesh()
    assert mesh.is_coordinator()


def test_nccl_with_more_ranks_than_cards_raises_with_the_gloo_hint(monkeypatch):
    with pytest.raises(RuntimeError, match="gloo"):
        mesh.nccl_card(0, 2, 1)
    assert mesh.nccl_card(1, 2, 2) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: pytest.fail("set_device ran"))
    for name, value in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29999", "WORLD_SIZE": "2",
                        "RANK": "1", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(name, value)
    monkeypatch.delenv(mesh.BACKEND_ENV, raising=False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        mesh.initialize_distributed(device="cuda")
    assert not torch.distributed.is_initialized()


def test_process_row_slice_needs_rows_that_divide():
    ranks = [mesh.DataMesh(3, r, torch.device("cpu"), True) for r in range(3)]
    assert [mesh.process_row_slice(9, m) for m in ranks] == [slice(0, 3), slice(3, 6), slice(6, 9)]
    with pytest.raises(ValueError, match="not divisible"):
        mesh.process_row_slice(10, ranks[1])


def test_cli_refuses_commands_that_do_not_train_over_ranks(monkeypatch, tmp_path):
    """More than one rank of get_frequencies would write every .kf once per
    rank: the CLI refuses it before it runs."""
    from kf2vecfsw_tpu_torch.cli import main

    monkeypatch.setattr(mesh, "initialize_distributed", lambda device: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(SystemExit, match="does not run over ranks"):
        main(["get_frequencies", "-input_dir", str(tmp_path), "-output_dir", str(tmp_path),
              "-device", "cpu"])
    assert list(tmp_path.iterdir()) == []
