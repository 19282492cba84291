"""The training slice as a whole: ``build_library`` through the JAX package's
CLI and through the port's (``-device cpu``) on one synthetic backbone of
two clades whose genomes differ in GC content, at k=3 and narrow widths.

`.kf`, `.subtrees` and `.di_mtrx` files are byte-identical. Both libraries
have the same files, and each classifier puts every backbone genome in its
own clade (training streams differ between the frameworks, so the trained
weights are held to behaviour, not to values). The port's
``process_query_data`` then serves the library the port built."""

import os

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.cli import main as jax_main
from kf2vecfsw_tpu_torch.cli import main

torch.set_num_threads(1)

K, PER_CLADE, GENOME = 3, 8, 6000


def _caterpillar(names):
    s = f"{names[0]}:1"
    for n in names[1:]:
        s = f"({s},{n}:1):1"
    return s


@pytest.fixture
def backbone(tmp_path):
    rng = np.random.default_rng(7)
    fna = tmp_path / "fna"
    fna.mkdir()
    clades = [[f"a{i}" for i in range(PER_CLADE)], [f"b{i}" for i in range(PER_CLADE)]]
    for names, gc in zip(clades, (0.3, 0.7)):
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        for i, n in enumerate(names):
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=GENOME, p=p)
            seq[rng.random(GENOME) < 0.01] = ord("N")
            if i % 2:
                (fna / f"{n}.fq").write_bytes(b"@r\n" + seq.tobytes() + b"\n+\n"
                                              + b"I" * GENOME + b"\n")
            else:
                (fna / f"{n}.fna").write_bytes(b">r\n" + seq.tobytes() + b"\n")
    nwk = f"({_caterpillar(clades[0])},{_caterpillar(clades[1])});"
    return tmp_path, fna, nwk, clades


def _build(tmp_path, fna, nwk, tag, run, extra):
    lib = tmp_path / f"lib_{tag}"
    tree_dir = tmp_path / f"tree_{tag}"
    lib.mkdir()
    tree_dir.mkdir()
    (tree_dir / "tree.nwk").write_text(nwk)  # outputs land next to the tree
    result = run(["build_library", "-input_dir", str(fna), "-output_dir", str(lib),
                  "-tree", str(tree_dir / "tree.nwk"), "-k", str(K), "-p", "2",
                  "-size", str(PER_CLADE), "-cl_epochs", "24", "-di_epochs", "2",
                  "-cl_hidden_sz", "32", "-di_hidden_sz", "32", "-di_embed_sz", "16",
                  "-cl_lr", "1e-3", *extra])
    return lib, tree_dir, result


def _self_classified(lib):
    with open(lib / "backbone_classes.out") as f:
        header = f.readline().rstrip("\n").split("\t")
        assert header[:4] == ["genome", "true_class", "top_class", "top_p"]
        rows = [line.rstrip("\n").split("\t") for line in f]
    return {r[0]: (int(r[1]), int(float(r[2]))) for r in rows}


def test_build_library_matches_jax_and_serves(backbone):
    tmp_path, fna, nwk, clades = backbone
    lib_jax, tree_jax, _ = _build(tmp_path, fna, nwk, "jax", jax_main, [])
    lib, tree_port, stages = _build(tmp_path, fna, nwk, "port", main, ["-device", "cpu"])
    assert list(stages) == ["get_frequencies", "divide_tree", "get_distances",
                            "train_classifier", "train_model_set"]

    for d_port, d_jax, exts in ((lib, lib_jax, (".kf",)),
                                (tree_port, tree_jax, (".subtrees", ".di_mtrx", ".nwk"))):
        names = sorted(f for f in os.listdir(d_jax) if f.endswith(exts))
        assert names == sorted(f for f in os.listdir(d_port) if f.endswith(exts))
        for n in names:
            assert (d_port / n).read_bytes() == (d_jax / n).read_bytes(), n
    assert sorted(os.listdir(tree_port)) == [
        "tree.nwk", "tree.subtrees", "tree_full.di_mtrx",
        "tree_subtree_0.di_mtrx", "tree_subtree_1.di_mtrx"]
    model_files = ["backbone_classes.out", "classifier_model.ckpt"] + [
        f"{kind}_subtree_{c}.{ext}" for c in range(2)
        for kind, ext in (("model", "ckpt"), ("embeddings", "csv"), ("distortions", "csv"))]
    for d in (lib, lib_jax):
        assert set(model_files) <= set(os.listdir(d))

    for d in (lib, lib_jax):
        classes = _self_classified(d)
        assert len(classes) == 2 * PER_CLADE
        assert all(true == top for true, top in classes.values()), classes

    # the port serves what it built: four backbone genomes as queries
    queries, out = tmp_path / "queries", tmp_path / "served"
    queries.mkdir()
    out.mkdir()
    for f in os.listdir(fna):
        if f.split(".")[0] in ("a0", "a1", "b2", "b3"):
            os.symlink(fna / f, queries / f)
    main(["process_query_data", "-input_dir", str(queries), "-output_dir", str(out),
          "-k", str(K), "-classifier_model", str(lib), "-distance_model", str(lib),
          "-device", "cpu"])
    truth = _self_classified(lib)
    with open(out / "classes.out") as f:
        f.readline()
        served = {r[0]: int(float(r[1])) for r in (line.split("\t") for line in f)}
    assert served == {g: truth[g][0] for g in ("a0", "a1", "b2", "b3")}
    for c in sorted(set(served.values())):
        with open(out / f"apples_input_di_mtrx_subtree_{c}.csv") as f:
            header = f.readline().rstrip("\n").split("\t")
            rows = {r[0]: np.array(r[1:], dtype=np.float64)
                    for r in (line.rstrip("\n").split("\t") for line in f)}
        with open(lib / f"embeddings_subtree_{c}.csv") as f:
            anchors = [line.split("\t", 1)[0] for line in f]
        assert header == [""] + anchors and len(anchors) == PER_CLADE
        for g, row in rows.items():
            assert row.shape == (PER_CLADE,) and np.all(np.isfinite(row)) and np.all(row >= 0)
            assert row[anchors.index(g)] < 1e-3 * max(row.max(), 1e-12) + 1e-6  # itself


def test_build_library_refuses_full_only_and_a_missing_card(backbone):
    tmp_path, fna, nwk, _ = backbone
    argv = ["build_library", "-input_dir", str(fna), "-output_dir", str(tmp_path),
            "-tree", str(tmp_path / "t.nwk"), "-mode", "full_only", "-device", "cpu"]
    with pytest.raises(SystemExit, match="full_only"):
        main(argv)
    if torch.cuda.is_available():
        return
    out = tmp_path / "nocard"
    out.mkdir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["build_library", "-input_dir", str(fna), "-output_dir", str(out),
              "-tree", str(tmp_path / "t.nwk")])
    assert os.listdir(out) == []
