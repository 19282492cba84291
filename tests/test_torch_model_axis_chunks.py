"""The chunk trainers on grids with a model axis, gloo ranks on the CPU
(``parallel/mp_check.py``'s ``grid`` worker) against one process with the
same seed, on ``test_torch_parallel_chunks``' chunk backbone. They train
over the grid's data axis only, every rank holding the whole model, as the
JAX package's chunk runners apply without ``model_axis``.

- (1, 2): one data index, so no collective of the batch plan runs and both
  ranks train what one process trains, params bit for bit; only rank 0
  writes; the ranks' params are bit-equal (the checksum line).
- (2, 2): the genome-sharded store over the two data indices (the log
  says so), the epoch losses within rtol 1e-5 and the checkpoints within
  ``test_torch_parallel_trainers``' Adam sign-flip bound of one process's."""

import os

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.parallel.mp_check import launch, worker
from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint

from .test_torch_parallel_chunks import (
    CHUNK_TRAINERS,
    _assert_checkpoints_close,
    _chunk_argv,
    _chunk_backbone,
)
from .test_torch_parallel_trainers import EPOCH_LOSS, _leaves, _logs

torch.set_num_threads(1)

TIMEOUT_S = 90


@pytest.mark.parametrize("n_data", [1, 2])
@pytest.mark.parametrize("cmd", sorted(CHUNK_TRAINERS))
def test_chunk_trainers_on_a_grid(tmp_path, cmd, n_data):
    root = _chunk_backbone(tmp_path)
    single = tmp_path / "single"
    main(_chunk_argv(root, cmd, single))
    world = 2 * n_data
    outs = [tmp_path / f"rank{r}" for r in range(world)]
    for out in outs:
        out.mkdir()
    launch([worker("grid") + [str(n_data), "2", *_chunk_argv(root, cmd, out)] for out in outs],
           "gloo", TIMEOUT_S)

    assert all(os.listdir(out) == [] for out in outs[1:])  # only rank 0 writes
    assert ({f for f in os.listdir(outs[0]) if not f.endswith(".log")}
            == {f for f in os.listdir(single) if not f.endswith(".log")})
    log_single, log_grid = _logs(single), _logs(outs[0])
    checkpoints = CHUNK_TRAINERS[cmd][1]
    assert f"grid {n_data} x 2 (data x model)" in log_grid
    assert log_grid.count(f"bit-equal on {world} rank(s)") == len(checkpoints)
    np.testing.assert_allclose([float(x) for x in EPOCH_LOSS.findall(log_grid)],
                               [float(x) for x in EPOCH_LOSS.findall(log_single)], rtol=1e-5)
    if n_data == 2:
        assert log_grid.count("Chunk ingest: per-rank genome slices (") == len(checkpoints)
        assert "over 2 data ranks" in log_grid
        _assert_checkpoints_close(single, outs[0], checkpoints)
        return
    assert log_grid.count("Chunk ingest: every rank reads every genome") == len(checkpoints)
    for ckpt in checkpoints:
        a, b = load_checkpoint(str(single / ckpt)), load_checkpoint(str(outs[0] / ckpt))
        assert a[1] == b[1]
        for (name, x), (_, y) in zip(_leaves(a[2]), _leaves(b[2])):
            np.testing.assert_array_equal(x, y, err_msg=f"{ckpt} {name}")
