"""The trainers of the CLI over two gloo ranks on the CPU against one process
with the same seed: ``train_classifier``, dense ``train_model_set``
(``-no_fsw``) and FSW ``train_model_set`` on the lazy route (its default)
and the exact one (``-fsw_lazy_refresh 0``), each on the shared-vocab and
on the per-genome route. Each rank gets its own output directory, as ranks
without a shared filesystem would, and runs the CLI (``python -m
kf2vecfsw_tpu_torch``) as a launcher's rank would.

- Only rank 0 writes: the other rank's directory stays empty, and rank 0's
  files are the single process's.
- The ranks' parameters are bit-equal (rank 0's log carries the trainer's
  all-reduced checksum line for every checkpoint), and every rank logs
  every epoch of every model, with its batches and the all-reduced loss.
- At the default learning rate, the epoch losses after one epoch within
  rtol 1e-5 (the noise below grows with the learning rate); the checkpoints'
  params within the Adam sign-flip bound: 2 * ADAM_STEP * (the learning
  rates of the run's steps summed) + rtol 1e-4 |p|, since the two ranks
  sum the gradients in another order, which can flip the sign of a
  gradient of rounding-noise size (the distance models' biases), and
  Adam's first steps move such a weight by about lr either way; the best
  epoch the same."""

import glob
import os
import re
import sys

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.defaults import LEARNING_RATE, LEARNING_RATE_DECAY, LEARNING_RATE_MIN
from kf2vecfsw_tpu_torch.io.kf import write_kf
from kf2vecfsw_tpu_torch.parallel.mp_check import launch
from kf2vecfsw_tpu_torch.train.checkpoint import _flatten, load_checkpoint
from kf2vecfsw_tpu_torch.train.schedule import step_lr
from kf2vecfsw_tpu_torch.tree.distance import write_di_mtrx

torch.set_num_threads(1)

RANKS, EPOCHS, BATCH, LR = 2, 2, 4, LEARNING_RATE  # the default learning rate
V, H, E = 32, 16, 8
SIZES = (7, 5)  # genomes per clade
TIMEOUT_S = 90
EPOCH_LOSS = re.compile(r"Epoch \[1/\d+\], Step \[\d+/\d+\], Train loss: ([0-9.eE+-]+)")
EPOCH_LINE = re.compile(r"Epoch \[(\d+)/\d+\], Step \[(\d+)/\d+\], Train loss: ([0-9.eE+-]+)")
CLI = [sys.executable, "-m", "kf2vecfsw_tpu_torch"]
# a bias-corrected Adam step over its first steps is at most 1.015 lr
# (test_torch_train_step.py's ADAM_STEP; this module imports no JAX, so the
# card-only tests can share its fixtures)
ADAM_STEP = 1.02


def _backbone(root):
    """.kf vectors of two clades, FASTA genomes for get_kmers (600 bases, at
    k=3: the shared-vocab route) and contigs (90 bases, at k=5: at most 86
    k-mers, padded to 128 < V/3, the per-genome route), the .subtrees file
    and a .di_mtrx per clade."""
    rng = np.random.default_rng(3)
    kf_dir, fna, contigs = root / "kf", root / "fna", root / "contigs"
    for d in (kf_dir, fna, contigs):
        d.mkdir()
    rows = []
    for c, n in enumerate(SIZES):
        names = [f"c{c}g{i}" for i in range(n)]
        rows += [(g, c) for g in names]
        for g in names:
            x = rng.random(V) + (np.arange(V) % 2 == c)
            write_kf(str(kf_dir / f"{g}.kf"), [(g, x / x.sum())])
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=600)
            (fna / f"{g}.fna").write_bytes(b">s\n" + seq.tobytes() + b"\n")
            (contigs / f"{g}.fna").write_bytes(b">s\n" + seq[:90].tobytes() + b"\n")
        d = np.abs(rng.normal(size=(n, n))) * 0.1
        d = d + d.T
        np.fill_diagonal(d, 0)
        write_di_mtrx(str(root / f"t_subtree_{c}.di_mtrx"), names[::-1], d)
    (root / "t.subtrees").write_text("genome clade\n" + "".join(f"{g} {c}\n" for g, c in rows))
    for src, out, k in ((fna, "npy", "3"), (contigs, "npy_contigs", "5")):
        main(["get_kmers", "-input_dir", str(src), "-output_dir", str(root / out), "-k", k,
              "-device", "cpu"])
    return root


TRAINERS = {  # name: (command and flags, batches of one epoch per model)
    "classifier": (["train_classifier", "-input_dir", "kf", "-hidden_sz", str(H)],
                   {"classifier_model.ckpt": 3}),
    "dense": (["train_model_set", "-input_dir", "kf", "-no_fsw", "-hidden_sz", str(H),
               "-embed_sz", str(E)], {"model_subtree_0.ckpt": 2, "model_subtree_1.ckpt": 2}),
    "fsw_lazy": (["train_model_set", "-input_dir", "npy", "-hidden_sz", str(H), "-embed_sz",
                  str(E), "-base_dim", "2", "-fswout_dim", "16"],
                 {"model_subtree_0.ckpt": 2, "model_subtree_1.ckpt": 2}),
    "fsw_exact": (["train_model_set", "-input_dir", "npy", "-hidden_sz", str(H), "-embed_sz",
                   str(E), "-base_dim", "2", "-fswout_dim", "16", "-fsw_lazy_refresh", "0"],
                  {"model_subtree_0.ckpt": 2, "model_subtree_1.ckpt": 2}),
    "fsw_pergenome_lazy": (["train_model_set", "-input_dir", "npy_contigs", "-hidden_sz", str(H),
                            "-embed_sz", str(E), "-base_dim", "2", "-fswout_dim", "16"],
                           {"model_subtree_0.ckpt": 2, "model_subtree_1.ckpt": 2}),
    "fsw_pergenome_exact": (["train_model_set", "-input_dir", "npy_contigs", "-hidden_sz", str(H),
                             "-embed_sz", str(E), "-base_dim", "2", "-fswout_dim", "16",
                             "-fsw_lazy_refresh", "0"],
                            {"model_subtree_0.ckpt": 2, "model_subtree_1.ckpt": 2}),
}


def _argv(root, name, out):
    cmd, _ = TRAINERS[name]
    argv = [cmd[0], "-input_dir", str(root / cmd[2]), *cmd[3:], "-subtrees",
            str(root / "t.subtrees"), "-o", str(out), "-e", str(EPOCHS), "-batch_sz", str(BATCH),
            "-device", "cpu"]
    if cmd[0] == "train_model_set":
        argv += ["-true_dist", str(root)]
    return argv


def _logs(out):
    text = ""
    for path in sorted(glob.glob(os.path.join(out, "*.log"))):
        with open(path) as f:
            text += f.read()
    return text


def _leaves(tree):
    return sorted(_flatten(tree).items())


def adam_bound(n_batches: int) -> float:
    return 2 * ADAM_STEP * n_batches * sum(
        step_lr(e, LR, LEARNING_RATE_MIN, LEARNING_RATE_DECAY) for e in range(EPOCHS))


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_two_ranks_train_what_one_process_trains(tmp_path, name):
    root = _backbone(tmp_path)
    single = tmp_path / "single"
    main(_argv(root, name, single))
    outs = [tmp_path / f"rank{r}" for r in range(RANKS)]
    for out in outs:
        out.mkdir()
    results = launch([CLI + _argv(root, name, out) for out in outs], "gloo", TIMEOUT_S)

    assert os.listdir(outs[1]) == []  # only rank 0 writes
    files = {f for f in os.listdir(single) if not f.endswith(".log")}
    assert {f for f in os.listdir(outs[0]) if not f.endswith(".log")} == files
    log_single, log_ranked = _logs(single), _logs(outs[0])
    checkpoints = TRAINERS[name][1]
    assert log_ranked.count(f"bit-equal on {RANKS} rank(s)") == len(checkpoints)
    assert "Ranks: 2 (gloo)" in log_ranked and "Ranks:" not in log_single
    routes = [line for line in log_ranked.splitlines() if "FSW " in line]
    assert routes == [line for line in log_single.splitlines() if "FSW " in line]
    if name.startswith("fsw"):  # every subtree on the route the name says
        assert sum("shared-vocab" in line for line in routes) == (
            0 if "pergenome" in name else len(checkpoints))
        assert sum("lazy" in line for line in routes) == (len(checkpoints) if "lazy" in name else 0)
    np.testing.assert_allclose([float(x) for x in EPOCH_LOSS.findall(log_ranked)],
                               [float(x) for x in EPOCH_LOSS.findall(log_single)], rtol=1e-5)
    epochs = EPOCH_LINE.findall(log_ranked)  # every rank: every epoch, its batches, one loss
    assert [(int(e), int(n)) for e, n, _ in epochs] == [
        (e + 1, n) for n in checkpoints.values() for e in range(EPOCHS)]
    for _, output in results:
        assert EPOCH_LINE.findall(output) == epochs
    for ckpt, n_batches in checkpoints.items():
        m_name, m_ref, p_ref = load_checkpoint(str(single / ckpt))
        got_name, m_got, p_got = load_checkpoint(str(outs[0] / ckpt))
        assert got_name == m_name and m_got["best_epoch"] == m_ref["best_epoch"]
        np.testing.assert_allclose(m_got["lowest_loss"], m_ref["lowest_loss"], rtol=1e-4)
        got, ref = dict(_leaves(p_got)), dict(_leaves(p_ref))
        assert got.keys() == ref.keys()
        for leaf in ref:
            np.testing.assert_allclose(got[leaf], ref[leaf], rtol=1e-4,
                                       atol=adam_bound(n_batches), err_msg=f"{ckpt} {leaf}")
