"""Data-parallel training on the card, at the CPU tests' small widths
(``test_torch_parallel_trainers.py`` and ``test_torch_parallel_chunks.py``
fixtures, with ``-device cuda``):

(a) one rank in an NCCL group trains every trainer (the classifier, dense
    and FSW distance models on the lazy and exact routes, both chunk
    trainers) to the checkpoints of the same runs without a group: bit for
    bit expected, rtol 1e-6 allowed where the masked loss takes other float
    operations (the classifier's NLL sum over the batch count);
(b) two ranks sharing the card over gloo train them within the Adam
    sign-flip bound of one process, only rank 0 writes, and their
    parameters are bit-equal;
and ``count_canonical_sharded`` over two ranks on the card (``kmer_hist`` on
each rank's segment) equals one launch's count exactly; (c) the model cut
over two ranks sharing the card (the grid 1 x 2, ``mp_check``'s ``grid``
worker) trains the classifier and the dense and FSW models within the Adam
bound of one process, only rank 0 writes, and each rank's FSW training
launches ``sort_rows`` on its half of the slices.

The kernels have no CPU mode and NCCL needs a card, so every test here skips
without one. On the card (no JAX there):

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.kmer.counter import KmerCounter, count_canonical_numpy
from kf2vecfsw_tpu_torch.parallel.mp_check import launch, worker
from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint

from .test_torch_parallel_chunks import (
    CHUNK_TRAINERS,
    _assert_checkpoints_close,
    _chunk_argv,
    _chunk_backbone,
)
from .test_torch_parallel_trainers import TRAINERS, _argv, _backbone, _leaves, _logs

pytestmark = pytest.mark.cuda

TIMEOUT_S = 300
# a rank that runs CLI commands, separated by "--", in one process group (one
# process start for all of them) and prints each one's sort_rows launches
RANK_SCRIPT = """
import sys
from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.kernels.sort import sort_rows
from kf2vecfsw_tpu_torch.parallel.mesh import shutdown_distributed
argv = sys.argv[1:]
while argv:
    cut = argv.index("--") if "--" in argv else len(argv)
    sort_rows.launches = 0
    main(argv[:cut])
    print("sort_rows launches:", sort_rows.launches, flush=True)
    argv = argv[cut + 1:]
shutdown_distributed()
"""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and the kernels have no CPU mode")
    return torch.device("cuda")


def _runs(tmp_path):
    """(name, argv for an output directory, checkpoints) of every trainer on
    the card."""
    (tmp_path / "trees").mkdir()
    (tmp_path / "chunk_trees").mkdir()
    root = _backbone(tmp_path / "trees")
    chunks = _chunk_backbone(tmp_path / "chunk_trees")
    runs = [(name, lambda out, name=name: _argv(root, name, out), TRAINERS[name][1])
            for name in sorted(TRAINERS)]
    runs += [(cmd, lambda out, cmd=cmd: _chunk_argv(chunks, cmd, out), CHUNK_TRAINERS[cmd][1])
             for cmd in sorted(CHUNK_TRAINERS)]
    return [(name, lambda out, f=f: [a if a != "cpu" else "cuda" for a in f(out)], ckpts)
            for name, f, ckpts in runs]


def _ranked(tmp_path, runs, ranks, backend):
    """Every run over ``ranks`` ranks of one launch, rank r writing under
    ``tmp_path/backend/rank{r}``; returns rank 0's directory."""
    root = tmp_path / backend
    argvs = []
    for r in range(ranks):
        steps = []
        for name, argv, _ in runs:
            out = root / f"rank{r}" / name
            out.mkdir(parents=True)
            steps += [*argv(str(out)), "--"]
        argvs.append([sys.executable, "-c", RANK_SCRIPT, *steps[:-1]])
    results = launch(argvs, backend, TIMEOUT_S)
    for name, _, ckpts in runs:
        for r in range(1, ranks):
            assert os.listdir(root / f"rank{r}" / name) == [], name
        assert _logs(root / "rank0" / name).count(f"bit-equal on {ranks} rank(s)") == len(ckpts)
    for _, output in results:
        launches = [int(n) for n in re.findall(r"sort_rows launches: (\d+)", output)]
        assert len(launches) == len(runs)
        for (name, _, _), n in zip(runs, launches):
            assert "fsw" not in name or n >= 1, name
    return root / "rank0"


def test_one_nccl_rank_trains_what_no_group_trains(card, tmp_path):
    runs = _runs(tmp_path)
    for name, argv, _ in runs:
        main(argv(str(tmp_path / "plain" / name)))
    rank0 = _ranked(tmp_path, runs, 1, "nccl")
    for name, _, ckpts in runs:
        assert "Ranks: 1 (nccl)" in _logs(rank0 / name)
        for ckpt in ckpts:
            _, m_ref, p_ref = load_checkpoint(str(tmp_path / "plain" / name / ckpt))
            _, m_got, p_got = load_checkpoint(str(rank0 / name / ckpt))
            assert m_got["best_epoch"] == m_ref["best_epoch"]
            np.testing.assert_allclose(m_got["lowest_loss"], m_ref["lowest_loss"], rtol=1e-6)
            got, ref = dict(_leaves(p_got)), dict(_leaves(p_ref))
            for leaf in ref:
                np.testing.assert_allclose(got[leaf], ref[leaf], rtol=1e-6, atol=0,
                                           err_msg=f"{name} {ckpt} {leaf}")


def test_two_ranks_share_the_card_over_gloo(card, tmp_path):
    runs = _runs(tmp_path)
    for name, argv, _ in runs:
        main(argv(str(tmp_path / "plain" / name)))
    rank0 = _ranked(tmp_path, runs, 2, "gloo")
    for name, _, ckpts in runs:
        _assert_checkpoints_close(tmp_path / "plain" / name, rank0 / name, ckpts)


def test_sharded_counting_on_the_card(card, tmp_path):
    rng = np.random.default_rng(8)
    codes = rng.choice(5, size=3_000_001, p=[0.24, 0.26, 0.25, 0.24, 0.01]).astype(np.uint8)
    np.save(tmp_path / "codes.npy", codes)
    out = tmp_path / "hist.npy"
    results = launch([worker("count") + [str(tmp_path / "codes.npy"), "7", "cuda", str(out)]] * 2,
                     "gloo", TIMEOUT_S)
    got = np.load(out)
    assert np.array_equal(got, KmerCounter(7, card).dense_histogram(codes).cpu().numpy())
    assert np.array_equal(got, count_canonical_numpy(codes, 7))
    for _, output in results:
        assert "kmer_hist launches: 1" in output


def test_the_model_cut_over_two_ranks_on_the_card(card, tmp_path):
    runs = [run for run in _runs(tmp_path) if "chunks" not in run[0]]
    for name, argv, ckpts in runs:
        main(argv(str(tmp_path / "plain" / name)))
        outs = [tmp_path / "grid" / f"rank{r}" / name for r in range(2)]
        for out in outs:
            out.mkdir(parents=True)
        results = launch([worker("grid") + ["1", "2", *argv(str(out))] for out in outs], "gloo",
                         TIMEOUT_S)
        assert os.listdir(outs[1]) == [], name
        assert _logs(outs[0]).count("bit-equal on 2 rank(s)") == len(ckpts), name
        for _, output in results:
            (n,) = [int(n) for n in re.findall(r"sort_rows launches: (\d+)", output)]
            assert "fsw" not in name or n >= 1, name
        _assert_checkpoints_close(tmp_path / "plain" / name, outs[0], ckpts)
