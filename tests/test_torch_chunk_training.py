"""The port's chunk stores, span sampler and chunk training epochs against
the JAX package's ``train/chunks.py``, on the CPU.

- Stores: the loaded matrices (uint16, uint8 with ``cap``, the ``-mask``
  columns), ``nbytes``, ``fits`` and the int32 ``OverflowError`` equal the
  JAX package's exactly.
- Sampler: for three (seed, epoch) pairs, at draws 1 and 2, the port's
  epoch plan (item order, then every batch's spans) gives batches from
  both of its stores that equal ``ChunkStore.sample_batch`` of the JAX
  package bit for bit (float64 normalisation, float32 cast last, on both
  sides); every row is a contiguous span and the span lengths follow
  floor(Exp(c/5)) + 1.
- One epoch: ``KF2VEC_CHUNK_DEVICE_BUDGET=0`` sends the JAX trainer down its
  host-store path, whose batches are the port's. Both packages resume one
  trainer state at epoch -1 (the same params, a fresh Adam) and train epoch
  0: the epoch loss agrees within rtol 1e-4, and params within the
  sign-flip bound of ``tests/test_torch_fsw_epochs.py`` (atol 2 * 1.02 *
  lr * steps + rtol 1e-4, median of every weight leaf under 1e-3 of it): a
  gradient that rounds to opposite signs in XLA:CPU and PyTorch moves a
  weight by up to 2 * 1.02 * lr a step. Adam's moments, sums of gradients
  and of their squares, agree within rtol 1e-4 / atol 1e-4 x the largest
  magnitude of the moment over all leaves (fp32 sums over a batch in
  another order; the distance model's biases get gradients of rounding-noise
  size, since the loss ignores a common shift of the embeddings)."""

import glob

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.io.kf import write_kf as jax_write_kf
from kf2vecfsw_tpu.kmer.vocab import low_complexity_mask as jax_low_complexity_mask
from kf2vecfsw_tpu.train import chunks as jax_chunks
from kf2vecfsw_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kf2vecfsw_tpu.train.resume import load_trainer_state as jax_load_trainer_state
from kf2vecfsw_tpu.tree.distance import write_di_mtrx
from kf2vecfsw_tpu_torch.train import chunks
from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint
from kf2vecfsw_tpu_torch.train.resume import load_trainer_state, save_trainer_state

from .test_torch_fsw_epochs import _assert_trees_close
from .test_torch_fsw_train import _leaves

torch.set_num_threads(1)

V = 32  # k=3
SIZES = (5, 4)  # genomes per clade
H, E, LR = 32, 16, 1e-4


def _fixture(root, seed=0, big=False):
    """Chunk .kf matrices (8-30 windows of raw counts; counts above 255 for
    -cap), full-genome .kf vectors, a .subtrees file of two clades and a
    .di_mtrx for each."""
    rng = np.random.default_rng(seed)
    chunks_dir, full_dir = root / "chunks", root / "full"
    chunks_dir.mkdir()
    full_dir.mkdir()
    rows = []
    for c, n in enumerate(SIZES):
        names = [f"c{c}g{i}" for i in range(n)]
        rows += [(g, c) for g in names]
        for g in names:
            mat = rng.integers(0, 400 if big else 60, size=(int(rng.integers(8, 31)), V))
            mat[:, c::2] += rng.integers(0, 30, size=mat[:, c::2].shape)  # clade signal
            mat = mat.astype(np.float64)
            jax_write_kf(str(chunks_dir / f"{g}.kf"),
                         [(f"{g}.part_c.part_w{i}", mat[i]) for i in range(len(mat))])
            total = mat.sum(axis=0)
            jax_write_kf(str(full_dir / f"{g}.kf"), [(g, total / total.sum())])
        d = np.abs(rng.normal(size=(n, n)))
        d = d + d.T
        np.fill_diagonal(d, 0)
        write_di_mtrx(str(root / f"t_subtree_{c}.di_mtrx"), names, d)
    (root / "t.subtrees").write_text("genome clade\n" + "".join(f"{g} {c}\n" for g, c in rows))
    files = sorted(glob.glob(str(chunks_dir / "*.kf")))
    return str(chunks_dir), str(full_dir), files, str(root / "t.subtrees")


@pytest.mark.parametrize("cap,mask", [(False, False), (True, False), (False, True)])
def test_chunk_store_loading_equals_jax(tmp_path, cap, mask):
    _, _, files, _ = _fixture(tmp_path, big=True)
    column_mask = jax_low_complexity_mask(3) if mask else None
    got = chunks.ChunkStore(files, cap=cap, column_mask=column_mask)
    ref = jax_chunks.ChunkStore(files, cap=cap, column_mask=column_mask)
    assert got.names == ref.names and got.input_size == ref.input_size
    assert got.input_size == (int(column_mask.sum()) if mask else V)
    for a, b in zip(got.matrices, ref.matrices):
        assert a.dtype == b.dtype == (np.uint8 if cap else np.uint16)
        np.testing.assert_array_equal(a, b)
    if cap:
        assert max(int(m.max()) for m in got.matrices) == 255


def test_nbytes_fits_and_overflow_equal_jax(tmp_path, monkeypatch):
    _, _, files, _ = _fixture(tmp_path)
    mats = chunks.ChunkStore(files).matrices
    nbytes = chunks.DeviceChunkStore.nbytes(mats)
    cmax = max(m.shape[0] for m in mats)
    assert nbytes == jax_chunks.DeviceChunkStore.nbytes(mats) == len(mats) * (cmax + 1) * V * 4
    for budget, fits in ((None, True), (nbytes, True), (nbytes - 1, False), (0, False)):
        if budget is None:
            monkeypatch.delenv("KF2VEC_CHUNK_DEVICE_BUDGET", raising=False)
        else:
            monkeypatch.setenv("KF2VEC_CHUNK_DEVICE_BUDGET", str(budget))
        assert chunks.DeviceChunkStore.fits(mats, "cpu") is jax_chunks.DeviceChunkStore.fits(mats) is fits
    monkeypatch.delenv("KF2VEC_CHUNK_DEVICE_BUDGET")
    # a genome whose total count reaches 2^31 cannot live in the int32 store
    huge = mats[:2] + [np.full((33, 1000), 65535, np.uint16)]
    wide = [np.zeros((m.shape[0], 1000), np.uint16) for m in huge[:2]] + huge[2:]
    assert not chunks.DeviceChunkStore.fits(wide, "cpu") and not jax_chunks.DeviceChunkStore.fits(wide)
    msgs = []
    for cls, args in ((chunks.DeviceChunkStore, ("cpu",)), (jax_chunks.DeviceChunkStore, ())):
        with pytest.raises(OverflowError) as err:
            cls(wide, *args)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == (
        f"genome 2: total chunk count {33 * 1000 * 65535} overflows the int32 device prefix "
        "store; use the host ChunkStore path")


@pytest.mark.parametrize("draws", [1, 2])
@pytest.mark.parametrize("seed,epoch", [(28, 0), (28, 7), (5, 123)])
def test_epoch_batches_equal_jax_host_sampler(tmp_path, seed, epoch, draws):
    _, _, files, _ = _fixture(tmp_path, seed=seed)
    host = chunks.ChunkStore(files)
    dev = chunks.DeviceChunkStore(host.matrices, "cpu")
    ref = jax_chunks.ChunkStore(files)
    n, batch = len(files), 4
    erng = np.random.default_rng((seed, epoch))
    perm = erng.permutation(n)
    got_perm, spans = chunks.epoch_plan(seed, epoch, host.counts, draws)
    np.testing.assert_array_equal(got_perm, perm)
    rows = batch * draws
    host_batch = chunks.batch_source(host, None, spans, rows, "cpu")
    dev_batch = chunks.batch_source(host, dev, spans, rows, "cpu")
    for bi in range(-(-n // batch)):
        want = ref.sample_batch(erng, perm[bi * batch : (bi + 1) * batch], draws)
        for got in (host_batch(bi), dev_batch(bi)):
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    # sample_batch / sample_one draw the same stream as the JAX package's
    for store in (host, dev):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(store.sample_batch(a, [3, 0, 3], draws),
                                      ref.sample_batch(b, [3, 0, 3], draws))
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(host.sample_one(a, 2), ref.sample_one(b, 2))


def test_spans_are_contiguous_and_follow_the_exponential():
    """One-hot rows per window index (c = 100): the normalised span sum shows
    exactly which windows a span covered; lengths have mean about c/5 + 1/2
    (the over-c redraw pulls it up a little), as in the JAX package."""
    c = 100
    eye = np.eye(c, dtype=np.uint16)
    store = chunks.DeviceChunkStore([eye], "cpu", scaler=1.0)
    spans = chunks.draw_spans(np.random.default_rng(0), store.counts, [0] * 600, 1)
    rows = store.batch(torch.from_numpy(spans)).numpy()
    for (_, ix, n), row in zip(spans.T, rows):
        nz = np.flatnonzero(row)
        np.testing.assert_array_equal(nz, np.arange(ix, ix + n))
        np.testing.assert_allclose(row[nz], 1.0 / n, rtol=1e-7)
    assert 1 <= spans[2].min() and spans[2].max() <= c
    assert 17 < spans[2].mean() < 26, spans[2].mean()
    zero = chunks.DeviceChunkStore([np.zeros((3, 4), np.uint16)], "cpu")
    assert not zero.sample_batch(np.random.default_rng(1), [0], 2).any()


def _write_start_state(path, params, extra=None):
    """A trainer state at epoch -1: ``params``, a fresh Adam, no best yet."""
    zeros = {layer: {leaf: np.zeros_like(v) for leaf, v in tree.items()}
             for layer, tree in params.items()}
    opt = {"count": np.int32(0), "mu": zeros, "nu": zeros}
    save_trainer_state(path, -1, params, opt, params, float("inf"), -1, extra)


def _linear_params(rng, sizes, names=("fc1", "fc2")):
    params = {}
    for name, n_in, n_out in zip(names, sizes, sizes[1:]):
        bound = 1.0 / np.sqrt(n_in)
        params[name] = {"w": rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                                "b": rng.uniform(-bound, bound, (n_out,)).astype(np.float32)}
    return params


@pytest.mark.parametrize("store", ["device", "host"])
@pytest.mark.parametrize("trainer", ["distance", "classifier", "classifier_mask"])
def test_one_epoch_equals_the_jax_host_path(tmp_path, monkeypatch, trainer, store):
    """Epoch 0 of each chunk trainer in both packages from one trainer state,
    the port on either store, the JAX package on its host store."""
    chunks_dir, full_dir, files, sub = _fixture(tmp_path, seed=3)
    rng = np.random.default_rng(9)
    mask = trainer == "classifier_mask"
    width = int(jax_low_complexity_mask(3).sum()) if mask else V
    batch = 3
    outs = {}
    for pkg in ("jax", "port"):
        out = tmp_path / pkg
        out.mkdir()
        outs[pkg] = out
    if trainer == "distance":
        params = _linear_params(rng, (V, H, E))
        steps = {c: -(-n // batch) for c, n in enumerate(SIZES)}
        for out in outs.values():
            for c in steps:
                _write_start_state(str(out / f"trainer_state_chunks_subtree_{c}.ckpt"), params)
        args = (chunks_dir, full_dir, files, sub, str(tmp_path), 1, H, E, batch, LR, 3e-6, 2000,
                None, 28, False)
        monkeypatch.setenv("KF2VEC_CHUNK_DEVICE_BUDGET", "0")
        jax_chunks.train_model_set_chunks_func(*args, str(outs["jax"]), resume=True,
                                               autosave_every=1)
        if store == "device":
            monkeypatch.delenv("KF2VEC_CHUNK_DEVICE_BUDGET")
        chunks.train_model_set_chunks_func(*args, str(outs["port"]), resume=True,
                                           autosave_every=1, device="cpu")
        states = {c: f"trainer_state_chunks_subtree_{c}.ckpt" for c in steps}
        ckpts = {c: f"model_subtree_{c}.ckpt" for c in steps}
    else:
        params = _linear_params(rng, (width, H, len(SIZES)), ("fc1", "fc3"))
        steps = {0: -(-sum(SIZES) // batch)}
        for out in outs.values():
            _write_start_state(str(out / "trainer_state_chunks_classifier.ckpt"), params,
                               {"acc_at_best": -1.0})
        args = (chunks_dir, full_dir, files, sub, 1, H, batch, LR, 3e-6, 2000, 28, mask, False)
        monkeypatch.setenv("KF2VEC_CHUNK_DEVICE_BUDGET", "0")
        jax_chunks.train_classifier_chunks_func(*args, str(outs["jax"]), resume=True,
                                                autosave_every=1)
        if store == "device":
            monkeypatch.delenv("KF2VEC_CHUNK_DEVICE_BUDGET")
        chunks.train_classifier_chunks_func(*args, str(outs["port"]), resume=True,
                                            autosave_every=1, device="cpu")
        states = {0: "trainer_state_chunks_classifier.ckpt"}
        ckpts = {0: "classifier_model.ckpt"}
    logs = {pkg: "".join(open(p).read() for p in glob.glob(str(out / "*.log")))
            for pkg, out in outs.items()}
    assert "Chunk store: host streaming" in logs["jax"]
    assert ("Chunk store: device-resident prefix sums" in logs["port"]) == (store == "device")
    assert "Resuming from epoch 0" in logs["port"] and "Resuming from epoch 0" in logs["jax"]
    for c, n_steps in steps.items():
        j_name, j_meta, j_params = jax_load_checkpoint(str(outs["jax"] / ckpts[c]))
        p_name, p_meta, p_params = load_checkpoint(str(outs["port"] / ckpts[c]))
        assert j_name == p_name and sorted(j_meta) == sorted(p_meta)
        assert j_meta["best_epoch"] == p_meta["best_epoch"] == 0
        np.testing.assert_allclose(p_meta["lowest_loss"], j_meta["lowest_loss"], rtol=1e-4)
        _assert_trees_close(p_params, j_params, lr=LR, steps=n_steps)
        j_state = jax_load_trainer_state(str(outs["jax"] / states[c]))
        p_state = load_trainer_state(str(outs["port"] / states[c]))
        assert j_state[0] == p_state[0] == 0
        assert int(j_state[2]["count"]) == int(p_state[2]["count"]) == n_steps
        for moment in ("mu", "nu"):
            got, ref = dict(_leaves(p_state[2][moment])), dict(_leaves(j_state[2][moment]))
            assert got.keys() == ref.keys()
            atol = 1e-4 * max(np.abs(want).max() for want in ref.values())
            for name, want in ref.items():
                np.testing.assert_allclose(got[name], want, rtol=1e-4, atol=atol, err_msg=name)
        if trainer != "distance":
            assert p_state[6]["acc_at_best"] == j_state[6]["acc_at_best"]
            assert (p_meta.get("low_complexity_mask_k"), j_meta.get("low_complexity_mask_k")) == (
                (3, 3) if mask else (None, None))
