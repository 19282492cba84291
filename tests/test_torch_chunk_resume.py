"""``-resume`` of the chunk trainers, on the backbone of
``tests/test_torch_chunk_cli.py`` (the port with ``device="cpu"``).

- A resumed port run equals an uninterrupted one exactly: the epoch's item
  order and spans come from the generator keyed by the absolute epoch, and
  the trainer state carries params, Adam and the best so far exactly.
- The port's trainer state resumes in the JAX package (its host-store path,
  ``KF2VEC_CHUNK_DEVICE_BUDGET=0``, which draws the port's batches): the
  next epoch there agrees with the port's own resumed epoch within rtol
  1e-4 on the loss and the sign-flip bound of
  ``tests/test_torch_fsw_epochs.py`` on the params (2 * 1.02 * lr a step).
- The JAX package's trainer state (from its device path) resumes in the
  port with the Adam step count and the best so far carried on."""

import glob
import os

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.train import chunks as jax_chunks
from kf2vecfsw_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kf2vecfsw_tpu.train.resume import load_trainer_state as jax_load_trainer_state
from kf2vecfsw_tpu_torch.train import chunks
from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint
from kf2vecfsw_tpu_torch.train.resume import load_trainer_state

from .test_torch_chunk_cli import SIZES, _backbone
from .test_torch_fsw_epochs import _assert_trees_close
from .test_torch_fsw_train import _leaves

torch.set_num_threads(1)

H, E, B, LR = 32, 16, 2, 1e-3


def _train(pkg, trainer, root, out, epochs, **kw):
    """One chunk trainer of either package on the backbone's chunks."""
    chunks_dir, full_dir, sub = (str(root / d) for d in ("chunks", "full", "t.subtrees"))
    files = sorted(glob.glob(os.path.join(chunks_dir, "*.kf")))
    mod = chunks if pkg == "port" else jax_chunks
    if pkg == "port":
        kw["device"] = "cpu"
    if trainer == "distance":
        mod.train_model_set_chunks_func(chunks_dir, full_dir, files, sub, str(root), epochs, H, E,
                                        B, LR, 3e-6, 2000, None, 28, False, str(out), **kw)
    else:
        mod.train_classifier_chunks_func(chunks_dir, full_dir, files, sub, epochs, H, B, LR, 3e-6,
                                         2000, 28, False, False, str(out), **kw)


def _names(trainer):
    """(checkpoint, trainer state, steps an epoch) of each model."""
    if trainer == "distance":
        return [(f"model_subtree_{c}.ckpt", f"trainer_state_chunks_subtree_{c}.ckpt", -(-n // B))
                for c, n in enumerate(SIZES)]
    return [("classifier_model.ckpt", "trainer_state_chunks_classifier.ckpt", -(-sum(SIZES) // B))]


def _log(out):
    return "".join(open(p).read() for p in glob.glob(str(out / "*.log")))


@pytest.mark.parametrize("trainer", ["distance", "classifier"])
def test_resumed_run_equals_an_uninterrupted_one(tmp_path, trainer):
    _backbone(tmp_path)
    whole, split = tmp_path / "whole", tmp_path / "split"
    _train("port", trainer, tmp_path, whole, 4)
    _train("port", trainer, tmp_path, split, 2)
    _train("port", trainer, tmp_path, split, 4, resume=True)
    assert "Resuming from epoch 2" in _log(split)
    for ckpt, state, _ in _names(trainer):
        a, b = load_checkpoint(str(whole / ckpt)), load_checkpoint(str(split / ckpt))
        assert a[0] == b[0] and a[1] == b[1]
        for (name, x), (_, y) in zip(_leaves(a[2]), _leaves(b[2])):
            np.testing.assert_array_equal(x, y, err_msg=name)
        sa, sb = load_trainer_state(str(whole / state)), load_trainer_state(str(split / state))
        assert sa[0] == sb[0] == 3 and sa[4:] == sb[4:]
    out = ["backbone_classes.out"] if trainer == "classifier" else [
        f"embeddings_subtree_{c}.csv" for c in range(2)]
    for name in out:
        assert (whole / name).read_bytes() == (split / name).read_bytes()


@pytest.mark.parametrize("trainer", ["distance", "classifier"])
def test_trainer_states_resume_across_packages(tmp_path, monkeypatch, trainer):
    _backbone(tmp_path)
    port, jax_from_port, jax_out = tmp_path / "port", tmp_path / "jax_from_port", tmp_path / "jax"
    _train("port", trainer, tmp_path, port, 2)
    jax_from_port.mkdir()
    for _, state, _ in _names(trainer):
        os.link(port / state, jax_from_port / state)
    monkeypatch.setenv("KF2VEC_CHUNK_DEVICE_BUDGET", "0")
    _train("jax", trainer, tmp_path, jax_from_port, 3, resume=True, autosave_every=1)
    monkeypatch.delenv("KF2VEC_CHUNK_DEVICE_BUDGET")
    _train("port", trainer, tmp_path, port, 3, resume=True)
    assert "Resuming from epoch 2" in _log(jax_from_port) and "Chunk store: host streaming" in _log(
        jax_from_port)
    for ckpt, state, steps in _names(trainer):
        _, p_meta, p_params = load_checkpoint(str(port / ckpt))
        _, j_meta, j_params = jax_load_checkpoint(str(jax_from_port / ckpt))
        assert p_meta["best_epoch"] == j_meta["best_epoch"]
        np.testing.assert_allclose(p_meta["lowest_loss"], j_meta["lowest_loss"], rtol=1e-4)
        # the resumed epoch's params, or the best so far that both restored
        _assert_trees_close(p_params, j_params, lr=LR, steps=steps)
        assert int(jax_load_trainer_state(str(jax_from_port / state))[2]["count"]) == 3 * steps

    # the JAX package's state (device path) into the port
    _train("jax", trainer, tmp_path, jax_out, 2)
    resumed = tmp_path / "port_from_jax"
    resumed.mkdir()
    for ckpt, state, steps in _names(trainer):
        os.link(jax_out / state, resumed / state)
    jax_states = {state: jax_load_trainer_state(str(jax_out / state)) for _, state, _ in _names(trainer)}
    _train("port", trainer, tmp_path, resumed, 3, resume=True)
    assert "Resuming from epoch 2" in _log(resumed)
    for ckpt, state, steps in _names(trainer):
        j = jax_states[state]
        p = load_trainer_state(str(resumed / state))
        assert (j[0], p[0]) == (1, 2) and int(j[2]["count"]) == 2 * steps
        assert int(p[2]["count"]) == 3 * steps and p[5] in (j[5], 2)
        if p[5] == j[5]:  # the best so far was carried over, not replaced
            for (name, x), (_, y) in zip(_leaves(p[3]), _leaves(j[3])):
                np.testing.assert_array_equal(x, y, err_msg=name)
