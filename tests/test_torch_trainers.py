"""The port's trainers end to end on the CPU, against the JAX package's
checkpoint reader and forward: ``train_classifier_func`` (with ``-mask``)
and the dense ``train_model_set_func`` (with ``-test_set`` and
``-save_interval``), autosave and ``-resume`` in both directions between the
packages, and FSW training's refusal of a folder without point sets.

Embeddings that the JAX package's ``dist_embed_apply`` computes from the
port's checkpoint agree with the port's exported CSVs within rtol 1e-5 /
atol 1e-6 (fp32 products summed in another order, then printed with
str(np.float32)); classifier probabilities likewise at rtol 1e-4 /
atol 1e-7."""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.models.mlp import classifier_apply, dist_embed_apply
from kf2vecfsw_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kf2vecfsw_tpu.train.distance import train_model_set_func as jax_train_model_set_func
from kf2vecfsw_tpu.train.resume import load_trainer_state as jax_load_trainer_state
from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.io.kf import write_kf
from kf2vecfsw_tpu_torch.kmer.vocab import low_complexity_mask
from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint
from kf2vecfsw_tpu_torch.train.classifier import train_classifier_func
from kf2vecfsw_tpu_torch.train.distance import train_model_set_func
from kf2vecfsw_tpu_torch.train.resume import load_trainer_state
from kf2vecfsw_tpu_torch.tree.distance import write_di_mtrx

torch.set_num_threads(1)

K, V, H, E = 3, 32, 16, 8
SIZES = (7, 5)  # genomes per clade


@pytest.fixture
def backbone(tmp_path):
    """Two clades of .kf vectors, a .subtrees file and one .di_mtrx per clade."""
    rng = np.random.default_rng(0)
    kf_dir = tmp_path / "kf"
    kf_dir.mkdir()
    rows = []
    for c, n in enumerate(SIZES):
        names = [f"c{c}g{i}" for i in range(n)]
        rows += [(g, c) for g in names]
        for g in names:
            x = rng.random(V) + (np.arange(V) % 2 == c)  # clade-dependent composition
            write_kf(str(kf_dir / f"{g}.kf"), [(g, x / x.sum())])
        d = np.abs(rng.normal(size=(n, n))) * 0.1
        d = d + d.T
        np.fill_diagonal(d, 0)
        write_di_mtrx(str(tmp_path / f"t_subtree_{c}.di_mtrx"), names[::-1], d)
    sub = tmp_path / "t.subtrees"
    sub.write_text("genome clade\n" + "".join(f"{g} {c}\n" for g, c in rows))
    files = sorted(glob.glob(str(kf_dir / "*.kf")))
    return tmp_path, str(kf_dir), files, str(sub)


def _read_rows(path, header):
    with open(path) as f:
        head = f.readline().rstrip("\n").split("\t") if header else None
        rows = {}
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows[parts[0]] = parts[1:]
    return head, rows


def _scaled_feats(files):
    from kf2vecfsw_tpu_torch.train.classifier import load_kf_matrix

    names, x = load_kf_matrix(files)
    return names, x * np.float32(1e4)


def _train_dense(root, kf_dir, files, sub, out, epochs, **kw):
    return train_model_set_func(kf_dir, files, sub, str(root), epochs, H, E, 4, 1e-3, 3e-6,
                                2000, None, 28, str(out), use_fsw=False, device="cpu", **kw)


def test_classifier_with_mask_loads_in_jax(backbone):
    root, kf_dir, files, sub = backbone
    out = root / "cl"
    ckpt = train_classifier_func(kf_dir, files, sub, 25, H, 4, 1e-2, 3e-6, 2000, 28, True,
                                 str(out), device="cpu")
    name, meta, params = jax_load_checkpoint(ckpt)
    assert name == "NeuralNetClassifierOnly"
    keep = low_complexity_mask(K)
    assert meta["low_complexity_mask_k"] == K and meta["model_input_size"] == int(keep.sum())
    assert meta["model_class_count"] == 2 and 0 <= meta["best_epoch"] < 25
    names, x = _scaled_feats(files)
    probs = np.exp(np.asarray(classifier_apply(params, x[:, keep])))
    header, rows = _read_rows(out / "backbone_classes.out", header=True)
    assert header == ["genome", "true_class", "top_class", "top_p", "0", "1"]
    assert sorted(rows) == sorted(names)
    for g, p in zip(names, probs):
        got = np.array(rows[g][3:], dtype=np.float64)
        np.testing.assert_allclose(got, p, rtol=1e-4, atol=1e-7)
        assert float(rows[g][1]) == float(np.argmax(p))
    log = open(glob.glob(str(out / "train_classifier_*.log"))[0]).read()
    assert "Backend: cpu" in log and "Masking: True" in log and "Epoch [25/25]" in log
    assert "Dimensions of feature matrix after masking" in log


def test_dense_trainer_test_set_snapshots_and_export(backbone):
    root, kf_dir, files, sub = backbone
    (root / "holdout.txt").write_text("c0g6.kf\n")
    out = root / "di"
    saved = _train_dense(root, kf_dir, files, sub, out, 7, save_interval=3,
                         test_ids_path=str(root / "holdout.txt"))
    assert saved == [str(out / "model_subtree_0.ckpt"), str(out / "model_subtree_1.ckpt")]
    assert sorted(d for d in os.listdir(out) if d.startswith("model_epoch_")) == [
        "model_epoch_1", "model_epoch_4", "model_epoch_7"]
    log = open(glob.glob(str(out / "train_model_*.log"))[0]).read()
    assert "Number of Train Samples: 6" in log and "Number of Test Samples: 1" in log
    assert log.count("Test loss:") == 7 and "Model family: NeuralNet" in log
    names, x = _scaled_feats(files)
    for c, n in enumerate(SIZES):
        for d in (out, out / "model_epoch_1", out / "model_epoch_4", out / "model_epoch_7"):
            name, meta, params = jax_load_checkpoint(str(d / f"model_subtree_{c}.ckpt"))
            assert name == "NeuralNet" and meta["model_embedding_size"] == E
            members = [i for i, g in enumerate(names) if g.startswith(f"c{c}")]
            ref = np.asarray(dist_embed_apply(params, x[members]))
            _, emb = _read_rows(d / f"embeddings_subtree_{c}.csv", header=False)
            assert list(emb) == [names[i] for i in members]  # every genome, the held-out one too
            got = np.array(list(emb.values()), dtype=np.float64)
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
            header, dis = _read_rows(d / f"distortions_subtree_{c}.csv", header=True)
            assert header == [""] + list(emb)
            sq = ((ref[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
            sq[sq < 1e-6] = 0
            np.testing.assert_allclose(np.array(list(dis.values()), dtype=np.float64), sq,
                                       rtol=1e-4, atol=1e-6)
        _, meta, _ = load_checkpoint(str(out / f"model_subtree_{c}.ckpt"))
        assert 0 <= meta["best_epoch"] < 7 and np.isfinite(meta["lowest_loss"])


def test_resume_equals_an_uninterrupted_run(backbone):
    root, kf_dir, files, sub = backbone
    whole, split = root / "whole", root / "split"
    _train_dense(root, kf_dir, files, sub, whole, 6, autosave_every=3)
    _train_dense(root, kf_dir, files, sub, split, 3, autosave_every=3)
    assert load_trainer_state(str(split / "trainer_state_subtree_0.ckpt"))[0] == 2
    _train_dense(root, kf_dir, files, sub, split, 6, autosave_every=3, resume=True)
    log = sorted(glob.glob(str(split / "train_model_*.log")))
    assert any("Resuming from epoch 3" in open(p).read() for p in log)
    for c in range(2):
        a = load_checkpoint(str(whole / f"model_subtree_{c}.ckpt"))
        b = load_checkpoint(str(split / f"model_subtree_{c}.ckpt"))
        assert a[1] == b[1]
        for layer in ("fc1", "fc2"):
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(a[2][layer][leaf], b[2][layer][leaf])

    cl_whole, cl_split = root / "cl_whole", root / "cl_split"
    args = (kf_dir, files, sub)
    train_classifier_func(*args, 6, H, 4, 1e-2, 3e-6, 2000, 28, False, str(cl_whole),
                          autosave_every=3, device="cpu")
    train_classifier_func(*args, 3, H, 4, 1e-2, 3e-6, 2000, 28, False, str(cl_split),
                          autosave_every=3, device="cpu")
    train_classifier_func(*args, 6, H, 4, 1e-2, 3e-6, 2000, 28, False, str(cl_split),
                          autosave_every=3, resume=True, device="cpu")
    a = load_checkpoint(str(cl_whole / "classifier_model.ckpt"))
    b = load_checkpoint(str(cl_split / "classifier_model.ckpt"))
    assert a[1] == b[1]
    np.testing.assert_array_equal(a[2]["fc1"]["w"], b[2]["fc1"]["w"])
    assert (cl_whole / "backbone_classes.out").read_bytes() == (
        cl_split / "backbone_classes.out").read_bytes()


def test_trainer_states_resume_across_packages(backbone):
    root, kf_dir, files, sub = backbone
    jax_out, port_out = root / "jax", root / "port"
    common = dict(use_fsw=False, log_every=10, autosave_every=2)
    jax_train_model_set_func(kf_dir, files, sub, str(root), 4, H, E, 4, 1e-3, 3e-6, 2000,
                             None, 28, str(jax_out), **common)
    # the port resumes the JAX package's autosave: no epoch is left, so the
    # checkpoint it writes holds the JAX run's best params and Adam is intact
    state = jax_load_trainer_state(str(jax_out / "trainer_state_subtree_1.ckpt"))
    assert state[0] == 3 and int(state[2]["count"]) == 8  # 2 batches x 4 epochs
    resumed = root / "resumed"
    resumed.mkdir()
    for c in range(2):
        name = f"trainer_state_subtree_{c}.ckpt"
        (resumed / name).write_bytes((jax_out / name).read_bytes())
    _train_dense(root, kf_dir, files, sub, resumed, 4, autosave_every=2, resume=True)
    for c in range(2):
        a = jax.device_get(jax_load_checkpoint(str(jax_out / f"model_subtree_{c}.ckpt"))[2])
        b = load_checkpoint(str(resumed / f"model_subtree_{c}.ckpt"))[2]
        np.testing.assert_array_equal(a["fc2"]["w"], b["fc2"]["w"])
    # ... and trains on from it
    _train_dense(root, kf_dir, files, sub, resumed, 6, autosave_every=2, resume=True)
    after = load_trainer_state(str(resumed / "trainer_state_subtree_1.ckpt"))
    assert after[0] == 5 and int(after[2]["count"]) == 12 and np.isfinite(after[4])

    # the JAX package resumes the port's autosave
    _train_dense(root, kf_dir, files, sub, port_out, 4, **{"autosave_every": 2})
    jax_train_model_set_func(kf_dir, files, sub, str(root), 4, H, E, 4, 1e-3, 3e-6, 2000,
                             None, 28, str(port_out), resume=True, **common)
    logs = sorted(glob.glob(str(port_out / "train_model_*.log")))
    assert any("Resuming from epoch 4" in open(p).read() for p in logs)
    state = jax_load_trainer_state(str(port_out / "trainer_state_subtree_0.ckpt"))
    assert state[0] == 3 and int(state[2]["count"]) == 8


def test_resume_refuses_other_widths(backbone):
    root, kf_dir, files, sub = backbone
    out = root / "di"
    _train_dense(root, kf_dir, files, sub, out, 2, autosave_every=1)
    with pytest.raises(SystemExit, match="cannot -resume"):
        train_model_set_func(kf_dir, files, sub, str(root), 4, H + 1, E, 4, 1e-3, 3e-6, 2000,
                             None, 28, str(out), use_fsw=False, resume=True, device="cpu")


def test_fsw_training_stops_with_a_message(backbone, capsys):
    root, kf_dir, files, sub = backbone
    out = root / "fsw"
    out.mkdir()
    with pytest.raises(SystemExit, match="-no_fsw") as exc:
        main(["train_model_set", "-input_dir", kf_dir, "-subtrees", sub, "-true_dist", str(root),
              "-o", str(out), "-device", "cpu"])
    assert "get_kmers" in str(exc.value) and ".npy" in str(exc.value)
    with pytest.raises(SystemExit, match="-no_fsw"):
        train_model_set_func(kf_dir, files, sub, str(root), 1, H, E, 4, 1e-3, 3e-6, 2000,
                             None, 28, str(out), device="cpu")
    assert os.listdir(out) == []  # stopped before any work
    main(["train_model_set", "-input_dir", kf_dir, "-subtrees", sub, "-true_dist", str(root),
          "-o", str(out), "-no_fsw", "-e", "1", "-hidden_sz", str(H), "-embed_sz", str(E),
          "-device", "cpu"])
    assert sorted(f for f in os.listdir(out) if f.endswith(".ckpt")) == [
        "model_subtree_0.ckpt", "model_subtree_1.ckpt"]
