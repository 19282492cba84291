"""The trainers of the CLI on the grid (1, 2) of gloo ranks on the CPU
(``parallel/mp_check.py``'s ``grid`` worker, the model cut in two) against
one process with the same seed: ``train_classifier``, dense
``train_model_set`` (``-no_fsw``) and FSW ``train_model_set`` on its
default route (lazy sort-refresh, shared-vocab), on
``test_torch_parallel_trainers``' backbone. Each rank writes to its own
output directory.

- Only rank 0 writes, the files of one process; rank 0's log names the
  grid, and the gathered params are bit-equal on both ranks (the trainer's
  checksum line for every checkpoint); every rank prints its ``sort_rows``
  launches.
- The epoch losses within rtol 1e-5 of one process's; the checkpoints hold
  full-size params, which the JAX package's ``load_checkpoint`` reads as
  the port's reader does, within the Adam sign-flip bound of one process's
  (``test_torch_parallel_trainers.adam_bound``) and with the same best
  epoch.
- The exports (the embeddings, the classifier's probabilities): one
  process's are the forward of its checkpoint (rtol 1e-5, atol 1e-6), and
  the grid's differ from them by at most what the Adam bound on the
  params can move the forward to first order, twice delta * sum over the
  params of |d out / d p|.
- With ``-test_set`` and ``-save_interval 1`` (dense and FSW lazy): every
  rank scores the held-out genomes with its cut each epoch, every rank
  gathers the model for each snapshot, and rank 0 writes the snapshots and
  their exports: the files of one process, the test losses within rtol
  1e-5, the snapshots within the Adam bound."""

import os
import re

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.defaults import FEATURES_SCALER
from kf2vecfsw_tpu_torch.models.mlp import params_from_jax
from kf2vecfsw_tpu_torch.parallel.mp_check import launch, worker
from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint
from kf2vecfsw_tpu_torch.train.classifier import load_kf_matrix
from kf2vecfsw_tpu_torch.train.distance import pad_point_sets

from .test_torch_parallel_trainers import (
    EPOCH_LOSS,
    TRAINERS,
    _argv,
    _backbone,
    _leaves,
    _logs,
    adam_bound,
)

torch.set_num_threads(1)

RANKS, TIMEOUT_S = 2, 90
GRID_TRAINERS = ("classifier", "dense", "fsw_lazy")
TEST_LOSS = re.compile(r"Test loss: ([0-9.eE+-]+)")


def _read_rows(path, header):
    with open(path) as f:
        if header:
            f.readline()
        return {parts[0]: np.array(parts[1:], dtype=np.float64)
                for parts in (line.rstrip("\n").split("\t") for line in f)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Each trainer in one process and on the grid (1, 2): (root, single
    output, the ranks' outputs, the ranks' console output)."""
    root = _backbone(tmp_path_factory.mktemp("backbone"))
    out = {}
    for name in GRID_TRAINERS:
        single = root / f"{name}_single"
        main(_argv(root, name, single))
        outs = [root / f"{name}_rank{r}" for r in range(RANKS)]
        for o in outs:
            o.mkdir()
        results = launch([worker("grid") + ["1", "2", *_argv(root, name, o)] for o in outs],
                         "gloo", TIMEOUT_S)
        out[name] = (root, single, outs, [output for _, output in results])
    return out


@pytest.mark.parametrize("name", GRID_TRAINERS)
def test_a_grid_trains_what_one_process_trains(trained, name):
    root, single, outs, outputs = trained[name]
    assert os.listdir(outs[1]) == []  # only rank 0 writes
    files = {f for f in os.listdir(single) if not f.endswith(".log")}
    assert {f for f in os.listdir(outs[0]) if not f.endswith(".log")} == files
    log_single, log_grid = _logs(single), _logs(outs[0])
    checkpoints = TRAINERS[name][1]
    assert "Ranks: 2 (gloo), grid 1 x 2 (data x model)" in log_grid
    assert log_grid.count(f"bit-equal on {RANKS} rank(s)") == len(checkpoints)
    assert all("sort_rows launches: " in output for output in outputs)
    routes = [line for line in log_grid.splitlines() if "FSW " in line]
    assert routes == [line for line in log_single.splitlines() if "FSW " in line]
    np.testing.assert_allclose([float(x) for x in EPOCH_LOSS.findall(log_grid)],
                               [float(x) for x in EPOCH_LOSS.findall(log_single)], rtol=1e-5)
    for ckpt, n_batches in checkpoints.items():
        _, m_ref, p_ref = load_checkpoint(str(single / ckpt))
        _, m_got, p_got = load_checkpoint(str(outs[0] / ckpt))
        _, m_jax, p_jax = jax_load_checkpoint(str(outs[0] / ckpt))
        assert m_got["best_epoch"] == m_ref["best_epoch"] and m_jax == m_got
        got, ref, jax_view = dict(_leaves(p_got)), dict(_leaves(p_ref)), dict(_leaves(p_jax))
        assert got.keys() == ref.keys() == jax_view.keys()
        for leaf in ref:
            assert got[leaf].shape == ref[leaf].shape, leaf  # full size: gathered
            np.testing.assert_array_equal(np.asarray(jax_view[leaf]), got[leaf])
            np.testing.assert_allclose(got[leaf], ref[leaf], rtol=1e-4,
                                       atol=adam_bound(n_batches), err_msg=f"{ckpt} {leaf}")


def _exported_bound(params, x, delta, probs=False):
    """(outputs, bound): the forward of ``params`` on rows ``x`` (their
    probabilities when ``probs``), and twice the first-order change that
    moving every parameter by up to ``delta`` can make in each output,
    delta * sum |d out / d p|."""
    model = params_from_jax(params)
    out = model(torch.from_numpy(x))
    out = out.exp() if probs else out
    bound = np.zeros(out.shape)
    for i in range(out.shape[0]):
        for j in range(out.shape[1]):
            grads = torch.autograd.grad(out[i, j], list(model.parameters()), retain_graph=True)
            bound[i, j] = 2 * delta * sum(float(g.abs().sum()) for g in grads)
    return out.detach().numpy(), bound


def _features(root, name, genomes):
    if name == "fsw_lazy":
        return pad_point_sets([np.load(root / "npy" / f"{g}_k3.npy").astype(np.float32)
                               for g in genomes])
    _, x = load_kf_matrix([str(root / "kf" / f"{g}.kf") for g in genomes])
    return x * np.float32(FEATURES_SCALER)


@pytest.mark.parametrize("name", GRID_TRAINERS)
def test_a_grid_exports_what_one_process_exports(trained, name):
    """The exports of the grid's gathered params against one process's,
    within what the Adam bound on the params can move them."""
    root, single, outs, _ = trained[name]
    exports = ({"classifier_model.ckpt": ("backbone_classes.out", True)} if name == "classifier"
               else {ckpt: (f"embeddings_subtree_{ckpt[len('model_subtree_'):-len('.ckpt')]}.csv",
                            False) for ckpt in TRAINERS[name][1]})
    for ckpt, (csv, header) in exports.items():
        a, b = _read_rows(outs[0] / csv, header), _read_rows(single / csv, header)
        assert a.keys() == b.keys()
        genomes = sorted(b)
        _, _, params = load_checkpoint(str(single / ckpt))
        ref, bound = _exported_bound(params, _features(root, name, genomes),
                                     adam_bound(TRAINERS[name][1][ckpt]), probs=header)
        got = np.array([a[g][-ref.shape[1]:] for g in genomes])
        want = np.array([b[g][-ref.shape[1]:] for g in genomes])
        np.testing.assert_allclose(want, ref, rtol=1e-5, atol=1e-6)  # the export is the forward
        assert np.all(np.abs(got - want) <= bound + 1e-6), np.max(np.abs(got - want) - bound)


def _files(out):
    return sorted(os.path.relpath(os.path.join(d, f), out) for d, _, files in os.walk(out)
                  for f in files if not f.endswith(".log"))


@pytest.mark.parametrize("name", ["dense", "fsw_lazy"])
def test_a_grid_scores_a_test_set_and_writes_snapshots(tmp_path, name):
    root = _backbone(tmp_path)
    (root / "holdout.txt").write_text("c0g6\nc1g4\n")  # 6 and 4 genomes left to train on
    flags = ["-test_set", str(root / "holdout.txt"), "-save_interval", "1"]
    single = root / "single"
    main(_argv(root, name, single) + flags)
    outs = [root / f"rank{r}" for r in range(RANKS)]
    for o in outs:
        o.mkdir()
    launch([worker("grid") + ["1", "2", *_argv(root, name, o), *flags] for o in outs], "gloo",
           TIMEOUT_S)
    assert os.listdir(outs[1]) == []
    files = _files(single)
    assert _files(outs[0]) == files and "model_epoch_2/embeddings_subtree_0.csv" in files
    test_losses = [float(x) for x in TEST_LOSS.findall(_logs(outs[0]))]
    assert len(test_losses) == 4  # 2 epochs x 2 subtrees
    np.testing.assert_allclose(test_losses,
                               [float(x) for x in TEST_LOSS.findall(_logs(single))], rtol=1e-5)
    for ckpt in (f for f in files if f.endswith(".ckpt")):
        n_batches = {"0": 2, "1": 1}[ckpt[-len("0.ckpt")]]
        _, _, p_ref = load_checkpoint(str(single / ckpt))
        _, _, p_got = load_checkpoint(str(outs[0] / ckpt))
        for (leaf, got), (_, ref) in zip(_leaves(p_got), _leaves(p_ref)):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=adam_bound(n_batches),
                                       err_msg=f"{ckpt} {leaf}")
