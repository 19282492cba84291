"""Two and three gloo ranks on the CPU for the chunk trainers, the
genome-sharded chunk store, sharded counting and resume
(``parallel/mp_check.py`` spawns the ranks).

- Both chunk trainers at two ranks against one process with the same seed:
  each rank reads its slice of the chunk files into the genome-sharded
  store (their logs say so); only rank 0 writes; the ranks' parameters are
  bit-equal; the epoch losses after one epoch within rtol 1e-5 and the
  checkpoints within ``test_torch_parallel_trainers``'s Adam sign-flip
  bound.
- The sharded store's span rows of an epoch equal the replicated store's
  bit for bit, with 7 genomes over 2 ranks (one padding row).
- ``count_canonical_sharded`` at R in {2, 3} equals ``count_canonical_numpy``
  exactly, and the JAX package's ``count_canonical_sharded`` on
  ``make_mesh(2, 1)``.
- Kill and resume at two ranks: a classifier run of 3 epochs, then
  ``-resume`` to 6, ends within the Adam bound of one uninterrupted process
  and says it resumed; and when only rank 0 can see the autosave, every
  rank stops with ``SystemExit`` (no rank hangs).

This module imports no JAX at its top (the counting test imports the JAX
package inside), so the card-only tests can share its fixtures."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.io.kf import write_kf
from kf2vecfsw_tpu_torch.kmer.counter import count_canonical_numpy
from kf2vecfsw_tpu_torch.parallel.mp_check import launch, worker
from kf2vecfsw_tpu_torch.train.chunks import ChunkStore, DeviceChunkStore, epoch_plan
from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint
from kf2vecfsw_tpu_torch.tree.distance import write_di_mtrx

from .test_torch_parallel_trainers import EPOCH_LOSS, _leaves, _logs, adam_bound

torch.set_num_threads(1)

RANKS, V, H, E = 2, 32, 16, 8
SIZES = (7, 5)
TIMEOUT_S = 90
CLI = [sys.executable, "-m", "kf2vecfsw_tpu_torch"]


def _chunk_backbone(root):
    """Chunk rows (6-12 windows of V counts) and full-genome .kf vectors of
    two clades, the .subtrees file and a .di_mtrx per clade."""
    rng = np.random.default_rng(9)
    for d in ("chunks", "full"):
        (root / d).mkdir()
    rows = []
    for c, n in enumerate(SIZES):
        names = [f"c{c}g{i}" for i in range(n)]
        rows += [(g, c) for g in names]
        for g in names:
            mat = rng.integers(0, 50, size=(int(rng.integers(6, 13)), V)).astype(np.float64)
            mat[:, c::2] += 20
            write_kf(str(root / "chunks" / f"{g}.kf"),
                     [(f"{g}.part_{r}", mat[r]) for r in range(mat.shape[0])])
            full = mat.sum(axis=0)
            write_kf(str(root / "full" / f"{g}.kf"), [(g, full / full.sum())])
        d = np.abs(rng.normal(size=(n, n)))
        d = d + d.T
        np.fill_diagonal(d, 0)
        write_di_mtrx(str(root / f"t_subtree_{c}.di_mtrx"), names, d)
    (root / "t.subtrees").write_text("genome clade\n" + "".join(f"{g} {c}\n" for g, c in rows))
    return root


CHUNK_TRAINERS = {  # name: (flags, batches of one epoch per checkpoint)
    "train_classifier_chunks": ([], {"classifier_model.ckpt": 3}),
    "train_model_set_chunks": (["-embed_sz", str(E)],
                               {"model_subtree_0.ckpt": 2, "model_subtree_1.ckpt": 2}),
}


def _chunk_argv(root, cmd, out):
    argv = [cmd, "-input_dir", str(root / "chunks"), "-input_dir_fullgenomes", str(root / "full"),
            "-subtrees", str(root / "t.subtrees"), "-o", str(out), "-e", "2", "-hidden_sz", str(H),
            "-batch_sz", "4", "-device", "cpu", *CHUNK_TRAINERS[cmd][0]]
    return argv + (["-true_dist", str(root)] if cmd == "train_model_set_chunks" else [])


def _assert_checkpoints_close(single, ranked, checkpoints):
    for ckpt, n_batches in checkpoints.items():
        _, m_ref, p_ref = load_checkpoint(str(single / ckpt))
        _, m_got, p_got = load_checkpoint(str(ranked / ckpt))
        assert m_got["best_epoch"] == m_ref["best_epoch"]
        got, ref = dict(_leaves(p_got)), dict(_leaves(p_ref))
        assert got.keys() == ref.keys()
        for leaf in ref:
            np.testing.assert_allclose(got[leaf], ref[leaf], rtol=1e-4,
                                       atol=adam_bound(n_batches), err_msg=f"{ckpt} {leaf}")


@pytest.mark.parametrize("cmd", sorted(CHUNK_TRAINERS))
def test_chunk_trainers_over_two_ranks(tmp_path, cmd):
    root = _chunk_backbone(tmp_path)
    single = tmp_path / "single"
    main(_chunk_argv(root, cmd, single))
    outs = [tmp_path / f"rank{r}" for r in range(RANKS)]
    for out in outs:
        out.mkdir()
    launch([CLI + _chunk_argv(root, cmd, out) for out in outs], "gloo", TIMEOUT_S)

    assert os.listdir(outs[1]) == []
    assert ({f for f in os.listdir(outs[0]) if not f.endswith(".log")}
            == {f for f in os.listdir(single) if not f.endswith(".log")})
    log_single, log_ranked = _logs(single), _logs(outs[0])
    checkpoints = CHUNK_TRAINERS[cmd][1]
    assert log_ranked.count("Chunk ingest: per-rank genome slices") == len(checkpoints)
    assert log_ranked.count("sharded by genome over the ranks") == len(checkpoints)
    assert log_ranked.count(f"bit-equal on {RANKS} rank(s)") == len(checkpoints)
    assert "Chunk ingest" not in log_single
    np.testing.assert_allclose([float(x) for x in EPOCH_LOSS.findall(log_ranked)],
                               [float(x) for x in EPOCH_LOSS.findall(log_single)], rtol=1e-5)
    _assert_checkpoints_close(single, outs[0], checkpoints)


@pytest.mark.parametrize("draws", [1, 2])
def test_sharded_store_samples_the_replicated_batch(tmp_path, draws):
    root = _chunk_backbone(tmp_path)
    chunks = tmp_path / "clade0"
    chunks.mkdir()
    paths = [str(root / "chunks" / f"c0g{i}.kf") for i in range(SIZES[0])]
    for p in paths:
        shutil.copy(p, chunks)
    out = tmp_path / "rows.npy"
    launch([worker("sampler") + [str(chunks), "5", str(draws), "cpu", str(out)]] * RANKS, "gloo",
           TIMEOUT_S)
    got = np.load(out)
    store = ChunkStore(paths)
    _, spans = epoch_plan(5, 0, store.counts, draws)
    want = DeviceChunkStore(store.matrices, "cpu").batch(torch.from_numpy(spans)).numpy()
    assert got.shape == want.shape == (SIZES[0] * draws, V)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("ranks", [2, 3])
def test_sharded_counting_is_exact(tmp_path, ranks):
    from kf2vecfsw_tpu.parallel.counting import count_canonical_sharded as jax_count_sharded
    from kf2vecfsw_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(ranks)
    codes = rng.choice(5, size=200_003, p=[0.24, 0.26, 0.25, 0.24, 0.01]).astype(np.uint8)
    np.save(tmp_path / "codes.npy", codes)
    out = tmp_path / "hist.npy"
    launch([worker("count") + [str(tmp_path / "codes.npy"), "7", "cpu", str(out)]] * ranks,
           "gloo", TIMEOUT_S)
    got = np.load(out)
    assert got.dtype == np.int64
    assert np.array_equal(got, count_canonical_numpy(codes, 7))
    assert np.array_equal(got, jax_count_sharded(codes, 7, make_mesh(2, 1)))


def _classifier_argv(root, out, epochs, *flags):
    return ["train_classifier", "-input_dir", str(root / "full"), "-subtrees",
            str(root / "t.subtrees"), "-o", str(out), "-e", str(epochs), "-hidden_sz", str(H),
            "-batch_sz", "4", "-device", "cpu", *flags]


def test_kill_and_resume_over_two_ranks(tmp_path):
    root = _chunk_backbone(tmp_path)
    single, shared = tmp_path / "single", tmp_path / "shared"
    main(_classifier_argv(root, single, 6))
    launch([CLI + _classifier_argv(root, shared, 3)] * RANKS, "gloo", TIMEOUT_S)
    assert os.path.exists(shared / "trainer_state_classifier.ckpt")
    results = launch([CLI + _classifier_argv(root, shared, 6, "-resume")] * RANKS, "gloo",
                     TIMEOUT_S)
    assert all("Resuming from epoch 3" in output for _, output in results)
    assert "Resuming from epoch 3" in _logs(shared)
    _assert_checkpoints_close(single, shared, {"classifier_model.ckpt": 3})


def test_resume_refused_when_only_rank_0_sees_the_state(tmp_path):
    root = _chunk_backbone(tmp_path)
    outs = [tmp_path / f"rank{r}" for r in range(RANKS)]
    main(_classifier_argv(root, outs[0], 3))  # rank 0's autosave; rank 1 sees none
    outs[1].mkdir()
    results = launch([CLI + _classifier_argv(root, out, 6, "-resume") for out in outs], "gloo",
                     TIMEOUT_S, check=False)
    for rc, output in results:
        assert rc != 0 and "the ranks disagree on the autosaved state" in output
        assert "[[1, 2], [0, -1]]" in output
