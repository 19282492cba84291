"""The whole serving slice: ``process_query_data`` through the JAX package's
CLI and through the port's CLI (``-device cpu``) on one small library.

`.kf` files must be byte-identical. classes.out probabilities and the
APPLES / `.emb` values compare at rtol 1e-4 (fp32 products and sums taken in
another order by XLA:CPU and PyTorch), and top_class must agree wherever the
top two log-probabilities are more than 1e-3 apart (a nearer tie may flip
under that rounding)."""

import os

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.cli import main as jax_main
from kf2vecfsw_tpu.infer.classify import classify_func as jax_classify_func
from kf2vecfsw_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.infer.classify import classify_func
from kf2vecfsw_tpu_torch.infer.query import query_func

torch.set_num_threads(1)

K, V, H, E, N_CLADES, N_ANCHORS = 5, 512, 32, 16, 3, 20


def _linear(rng, n_in, n_out):
    bound = 1.0 / np.sqrt(n_in)
    return {
        "w": rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
        "b": rng.uniform(-bound, bound, (n_out,)).astype(np.float32),
    }


def _write_library(mdir, rng, classifier_input=V, mask_k=None):
    meta = {"model_input_size": classifier_input, "model_hidden_size_fc1": H,
            "model_class_count": N_CLADES}
    if mask_k:
        meta["low_complexity_mask_k"] = mask_k
    jax_save_checkpoint(
        os.path.join(mdir, "classifier_model.ckpt"), "NeuralNetClassifierOnly", meta,
        {"fc1": _linear(rng, classifier_input, H), "fc3": _linear(rng, H, N_CLADES)},
    )
    for c in range(N_CLADES):
        jax_save_checkpoint(
            os.path.join(mdir, f"model_subtree_{c}.ckpt"), "NeuralNet",
            {"model_input_size": V, "model_hidden_size_fc1": H, "model_embedding_size": E},
            {"fc1": _linear(rng, V, H), "fc2": _linear(rng, H, E)},
        )
        with open(os.path.join(mdir, f"embeddings_subtree_{c}.csv"), "w") as f:
            for i in range(N_ANCHORS):
                row = rng.normal(size=E).astype(np.float32)
                f.write(f"c{c}_a{i}\t" + "\t".join(str(v) for v in row) + "\n")


def _write_queries(qdir, rng, n=6):
    for i in range(n):
        gc = 0.3 + 0.08 * i  # different compositions spread the classes
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=int(rng.integers(20_000, 50_000)), p=p)
        seq[rng.random(seq.size) < 0.005] = ord("N")
        body = seq.astype(np.uint8).tobytes()
        if i % 2:
            (qdir / f"q{i}.fq").write_bytes(b"@r\n" + body + b"\n+\n" + b"I" * len(body) + b"\n")
        else:
            (qdir / f"q{i}.fna").write_bytes(b">r\n" + body + b"\n")


def _read_table(path):
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = {}
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows[parts[0]] = np.array(parts[1:], dtype=np.float64)
    return header, rows


def _read_emb(path):
    rows = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows[parts[0]] = np.array(parts[1:], dtype=np.float64)
    return rows


def _compare_classes(port_path, jax_path):
    header, port = _read_table(port_path)
    jax_header, ref = _read_table(jax_path)
    assert header == jax_header and sorted(port) == sorted(ref)
    agreed = []
    for g, row in port.items():
        probs, ref_probs = row[2:], ref[g][2:]
        np.testing.assert_allclose(probs, ref_probs, rtol=1e-4, atol=1e-7)
        logp = np.sort(np.log(ref_probs))
        if logp[-1] - logp[-2] > 1e-3:
            assert row[0] == ref[g][0], g
            agreed.append(g)
    return {g: int(ref[g][0]) for g in agreed}


@pytest.fixture
def library(tmp_path):
    rng = np.random.default_rng(11)
    qdir, mdir = tmp_path / "queries", tmp_path / "library"
    qdir.mkdir()
    mdir.mkdir()
    _write_queries(qdir, rng)
    _write_library(str(mdir), rng)
    return qdir, mdir


def test_process_query_data_matches_jax(tmp_path, library):
    qdir, mdir = library
    # an unreadable model of a subtree no query falls into: both warn and go on
    (mdir / "model_subtree_99.ckpt").write_bytes(b"truncated")
    outs = {}
    for tag, run, extra in (("jax", jax_main, []), ("port", main, ["-device", "cpu"])):
        odir = tmp_path / f"out_{tag}"
        odir.mkdir()
        run(["process_query_data", "-input_dir", str(qdir), "-output_dir", str(odir),
             "-k", str(K), "-p", "2", "-classifier_model", str(mdir),
             "-distance_model", str(mdir), *extra])
        outs[tag] = odir
    port, ref = outs["port"], outs["jax"]

    kf = sorted(f for f in os.listdir(ref) if f.endswith(".kf"))
    assert len(kf) == 6 and kf == sorted(f for f in os.listdir(port) if f.endswith(".kf"))
    for f in kf:
        assert (port / f).read_bytes() == (ref / f).read_bytes(), f

    agreed = _compare_classes(port / "classes.out", ref / "classes.out")
    assert agreed, "no query had a clear top class"
    for c in sorted(set(agreed.values())):
        dist = f"apples_input_di_mtrx_subtree_{c}.csv"
        header, d_port = _read_table(port / dist)
        ref_header, d_ref = _read_table(ref / dist)
        assert header == ref_header == [""] + [f"c{c}_a{i}" for i in range(N_ANCHORS)]
        e_port = _read_emb(port / f"embedding_subtree_{c}.emb")
        e_ref = _read_emb(ref / f"embedding_subtree_{c}.emb")
        for g in (g for g, cl in agreed.items() if cl == c):
            np.testing.assert_allclose(d_port[g], d_ref[g], rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(e_port[g], e_ref[g], rtol=1e-4, atol=1e-6)
            assert d_port[g].shape == (N_ANCHORS,) and (d_port[g] >= 0).all()
            assert e_port[g].shape == (E,)


def test_classify_with_column_mask_matches_jax(tmp_path):
    from kf2vecfsw_tpu_torch.io.kf import write_kf
    from kf2vecfsw_tpu_torch.kmer.vocab import low_complexity_mask

    rng = np.random.default_rng(12)
    mdir, qdir = tmp_path / "m", tmp_path / "q"
    mdir.mkdir()
    qdir.mkdir()
    _write_library(str(mdir), rng, classifier_input=int(low_complexity_mask(K).sum()), mask_k=K)
    files = []
    for i in range(5):
        x = rng.random(V)
        files.append(str(qdir / f"q{i}.kf"))
        write_kf(files[-1], [(f"q{i}", x / x.sum())])
    (tmp_path / "o_jax").mkdir()
    (tmp_path / "o_port").mkdir()
    jax_classify_func(str(qdir), files, str(mdir), 28, str(tmp_path / "o_jax"))
    classify_func(str(qdir), files, str(mdir), 28, str(tmp_path / "o_port"), block_size=2,
                  device="cpu")
    _compare_classes(tmp_path / "o_port" / "classes.out", tmp_path / "o_jax" / "classes.out")


def test_query_remap_and_error_keeps_earlier_subtrees_whole(tmp_path, library):
    qdir, mdir = library
    odir = tmp_path / "out"
    odir.mkdir()
    main(["get_frequencies", "-input_dir", str(qdir), "-output_dir", str(odir), "-k", str(K),
          "-device", "cpu"])
    with open(odir / "classes.out", "w") as f:  # q0,q1 -> subtree 0; q2 -> subtree 2
        f.write("genome\ttop_class\ttop_p\n")
        f.write("q0\t0.0\t1.0\nq1\t0.0\t1.0\nq2\t2.0\t1.0\n")
    remap = tmp_path / "remap.tsv"
    remap.write_text("label\tnew_label\nq1\trenamed\n")
    os.remove(mdir / "model_subtree_2.ckpt")
    files = sorted(str(odir / f) for f in os.listdir(odir) if f.endswith(".kf"))
    with pytest.raises(FileNotFoundError, match="model_subtree_2"):
        query_func(str(odir), files, str(mdir), str(odir), 28, str(odir),
                   remap_path=str(remap), block_size=1, device="cpu")
    header, dist = _read_table(odir / "apples_input_di_mtrx_subtree_0.csv")
    assert len(header) == N_ANCHORS + 1 and sorted(dist) == ["q0", "renamed"]
    assert sorted(_read_emb(odir / "embedding_subtree_0.emb")) == ["q0", "renamed"]


def test_fsw_library_is_refused_before_any_work(tmp_path, library):
    """An FSW library is served on the card by default: with no card the
    command raises before it writes anything, and it runs on the CPU only
    when asked (-device cpu)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import jax

    from kf2vecfsw_tpu.models.fsw import init_fsw_dist_embed

    qdir, mdir = library
    jax_save_checkpoint(str(mdir / "model_subtree_1.ckpt"), "NeuralNetFSW",
                        {"model_input_size": K + 1, "fsw_k": K},
                        jax.device_get(init_fsw_dist_embed(jax.random.PRNGKey(1), K, 2, 8, 8, E)))
    odir = tmp_path / "out"
    odir.mkdir()
    argv = ["process_query_data", "-input_dir", str(qdir), "-output_dir", str(odir),
            "-k", str(K), "-classifier_model", str(mdir), "-distance_model", str(mdir)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert os.listdir(odir) == []  # no .kf, no .npy point sets
    stages = main(argv + ["-device", "cpu"])
    assert list(stages) == ["get_frequencies", "classify", "get_kmers", "query"]
    assert sorted(f for f in os.listdir(odir) if f.endswith(f"_k{K}.npy")) == [
        f"q{i}_k{K}.npy" for i in range(6)]
