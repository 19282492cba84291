"""The chunk pipeline through the CLI of both packages (the port with
``-device cpu``): ``get_chunks`` and ``get_frequencies`` over a synthetic
backbone of two subtrees (7 genomes of 50-80 kb, k=3, 10 kb windows), then
``train_classifier_chunks`` and ``train_model_set_chunks`` (H 32, E 16,
batch 2, 2 epochs) in each package, and ``get_secondary_classes``.

The checkpoints of both packages carry the same model names and meta keys,
and their outputs the same shapes. The RNG streams of the two packages'
inits differ, so their trained values are not compared here
(``tests/test_torch_chunk_training.py`` compares one epoch from one
state); instead each package's ``classify`` and ``query`` read the other's
checkpoints and reproduce the other's ``backbone_classes.out``
probabilities (rtol 1e-4 / atol 1e-6) and ``embeddings_subtree_*.csv``
rows (rtol 1e-4 / atol 1e-5, the dense forward's tolerance). A full-genome
directory at another k raises the same ``ValueError`` in both, and the
``classes_*Best.out`` bytes are equal."""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.cli import main as jax_main
from kf2vecfsw_tpu.train import chunks as jax_chunks
from kf2vecfsw_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.io.kf import float_repr
from kf2vecfsw_tpu_torch.train import chunks
from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint
from kf2vecfsw_tpu_torch.tree.distance import write_di_mtrx

from .test_torch_slice import _read_emb

torch.set_num_threads(1)

K, H, E = 3, 32, 16
SIZES = (4, 3)
TRAIN = ["-hidden_sz", str(H), "-batch_sz", "2", "-lr", "1e-3", "-e", "2"]


def _backbone(root):
    """FASTA genomes of two clades with a clade-specific GC content, their
    chunk rows and full-genome .kf vectors from the port (CPU), the
    .subtrees file and a .di_mtrx per clade."""
    rng = np.random.default_rng(6)
    fna = root / "fna"
    fna.mkdir()
    rows = []
    for c, n in enumerate(SIZES):
        names = [f"c{c}g{i}" for i in range(n)]
        rows += [(g, c) for g in names]
        p = [0.3, 0.2, 0.2, 0.3] if c == 0 else [0.2, 0.3, 0.3, 0.2]
        for g in names:
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=int(rng.integers(50_000, 80_001)),
                             p=p)
            (fna / f"{g}.fna").write_bytes(b">%s\n%s\n" % (g.encode(), seq.tobytes()))
        d = np.abs(rng.normal(size=(n, n))) * 0.1
        d = d + d.T
        np.fill_diagonal(d, 0)
        write_di_mtrx(str(root / f"t_subtree_{c}.di_mtrx"), names, d)
    (root / "t.subtrees").write_text("genome clade\n" + "".join(f"{g} {c}\n" for g, c in rows))
    for cmd, out in (("get_chunks", "chunks"), ("get_frequencies", "full")):
        (root / out).mkdir()
        main([cmd, "-input_dir", str(fna), "-output_dir", str(root / out), "-k", str(K),
              "-device", "cpu"])
    return str(root / "chunks"), str(root / "full"), str(root / "t.subtrees"), rows


def _train_cli(run, root, out, device):
    chunks_dir, full_dir, sub = (str(root / d) for d in ("chunks", "full", "t.subtrees"))
    extra = ["-device", "cpu"] if device else []
    run(["train_classifier_chunks", "-input_dir", chunks_dir, "-input_dir_fullgenomes", full_dir,
         "-subtrees", sub, "-o", str(out), *TRAIN, *extra])
    run(["train_model_set_chunks", "-input_dir", chunks_dir, "-input_dir_fullgenomes", full_dir,
         "-subtrees", sub, "-true_dist", str(root), "-o", str(out), "-embed_sz", str(E), *TRAIN,
         *extra])


def _table(path, skip):
    """{genome: values after the first ``skip`` columns} of a TSV table."""
    with open(path) as f:
        f.readline()
        return {r[0]: np.array(r[1 + skip :], dtype=np.float64)
                for r in (line.rstrip("\n").split("\t") for line in f)}


def test_chunk_trainers_cross_read_between_packages(tmp_path):
    _, full_dir, _, rows = _backbone(tmp_path)
    outs = {}
    for tag, run, device in (("jax", jax_main, False), ("port", main, True)):
        outs[tag] = tmp_path / tag
        _train_cli(run, tmp_path, outs[tag], device)
    logs = "".join(open(p).read() for p in glob.glob(str(outs["port"] / "*.log")))
    assert logs.count("Chunk store: device-resident prefix sums") == 3
    for ckpt in ["classifier_model.ckpt"] + [f"model_subtree_{c}.ckpt" for c in range(2)]:
        jname, jmeta, jparams = jax_load_checkpoint(str(outs["jax"] / ckpt))
        pname, pmeta, pparams = load_checkpoint(str(outs["port"] / ckpt))
        assert jname == pname and sorted(jmeta) == sorted(pmeta), ckpt
        assert {k: np.shape(v) for k, v in pparams.items()} == {k: np.shape(v) for k, v in jparams.items()}
        assert np.isfinite(pmeta["lowest_loss"]) and 0 <= pmeta["best_epoch"] < 2
    for tag in outs:
        table = _table(outs[tag] / "backbone_classes.out", 3)
        assert sorted(table) == sorted(g for g, _ in rows)
        assert all(v.shape == (2,) and abs(v.sum() - 1) < 1e-5 for v in table.values())
        for c, n in enumerate(SIZES):
            emb = _read_emb(outs[tag] / f"embeddings_subtree_{c}.csv")
            assert len(emb) == n and all(e.shape == (E,) for e in emb.values())

    # each package's classify and query read the other's checkpoints
    picks = {c: next(g for g, cl in rows if cl == c) for c in range(2)}
    for lib, run, device in (("port", jax_main, False), ("jax", main, True)):
        extra = ["-device", "cpu"] if device else []
        cls_out = tmp_path / f"classify_{lib}"
        run(["classify", "-input_dir", full_dir, "-model", str(outs[lib]), "-o", str(cls_out),
             *extra])
        got, want = _table(cls_out / "classes.out", 2), _table(outs[lib] / "backbone_classes.out", 3)
        assert sorted(got) == sorted(want)
        for g in want:
            np.testing.assert_allclose(got[g], want[g], rtol=1e-4, atol=1e-6, err_msg=g)
        qdir, q_out = tmp_path / f"q_{lib}", tmp_path / f"q_out_{lib}"
        qdir.mkdir()
        for g in picks.values():
            shutil.copy(os.path.join(full_dir, f"{g}.kf"), qdir / f"{g}.kf")
        (qdir / "classes.out").write_text(
            "genome\ttop_class\n" + "".join(f"{g}\t{c}\n" for c, g in picks.items()))
        run(["query", "-input_dir", str(qdir), "-model", str(outs[lib]), "-classes", str(qdir),
             "-o", str(q_out), *extra])
        for c, g in picks.items():
            emb = _read_emb(q_out / f"embedding_subtree_{c}.emb")[g]
            np.testing.assert_allclose(emb, _read_emb(outs[lib] / f"embeddings_subtree_{c}.csv")[g],
                                       rtol=1e-4, atol=1e-5, err_msg=g)


def test_fullgenome_width_mismatch_raises_the_same_error(tmp_path):
    chunks_dir, _, sub, _ = _backbone(tmp_path)
    wrong = tmp_path / "full_k2"
    wrong.mkdir()
    main(["get_frequencies", "-input_dir", str(tmp_path / "fna"), "-output_dir", str(wrong),
          "-k", "2", "-device", "cpu"])
    files = sorted(glob.glob(os.path.join(chunks_dir, "*.kf")))
    msgs = []
    for pkg, extra in ((jax_chunks, {}), (chunks, {"device": "cpu"})):
        for call in (
            lambda: pkg.train_model_set_chunks_func(
                chunks_dir, str(wrong), files, sub, str(tmp_path), 1, H, E, 2, 1e-3, 3e-6, 2000,
                None, 28, False, str(tmp_path / "out"), **extra),
            lambda: pkg.train_classifier_chunks_func(
                chunks_dir, str(wrong), files, sub, 1, H, 2, 1e-3, 3e-6, 2000, 28, False, False,
                str(tmp_path / "out"), **extra),
        ):
            with pytest.raises(ValueError) as err:
                call()
            msgs.append(str(err.value))
    assert len(set(msgs)) == 1
    assert msgs[0] == ("full-genome feature width 10 != chunk feature width 32: -input_dir and "
                       "-input_dir_fullgenomes must be built with the same k")


@pytest.mark.parametrize("n_classes", [2, 3, 5])
def test_secondary_classes_bytes_equal_jax(tmp_path, n_classes):
    rng = np.random.default_rng(n_classes)
    probs = rng.random((6, n_classes))
    probs[1, 1:] = probs[1, 0]  # ties
    probs /= probs.sum(axis=1, keepdims=True)
    lines = ["\t".join(["genome", "top_class", "top_p"] + [str(c) for c in range(n_classes)])]
    for i, p in enumerate(probs):
        lines.append("\t".join([f"q{i}", float_repr(float(p.argmax())), float_repr(float(p.max()))]
                               + [float_repr(float(v)) for v in p]))
    written = {}
    for tag, run in (("jax", jax_main), ("port", main)):
        (tmp_path / tag).mkdir()
        (tmp_path / tag / "classes.out").write_text("\n".join(lines) + "\n")
        run(["get_secondary_classes", str(tmp_path / tag / "classes.out")])
        written[tag] = sorted(p.name for p in (tmp_path / tag).glob("classes_*Best.out"))
    assert written["port"] == written["jax"] == sorted(
        ["classes_secondBest.out", "classes_thirdBest.out", "classes_fourthBest.out"][: n_classes - 1])
    for name in written["port"]:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
