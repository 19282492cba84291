"""The whole slice on an FSW library: ``process_query_data`` through the JAX
package's CLI and through the port's CLI (``-device cpu``), on a library
whose subtree models are all FSW and on one that mixes dense and FSW.

`.kf` and `.npy` files must be byte-identical. classes.out compares as in
test_torch_slice.py. APPLES and `.emb` files must have the same header and
labels, and values within rtol 1e-4 / atol 1e-5 (the FSW forward's
tolerance: projections, prefix sums and row sums run in another order)."""

import os

import jax
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.cli import main as jax_main
from kf2vecfsw_tpu.models.fsw import init_fsw_dist_embed
from kf2vecfsw_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from kf2vecfsw_tpu_torch.cli import main

from .test_torch_slice import _compare_classes, _linear, _read_emb, _read_table, _write_queries

torch.set_num_threads(1)

K, V, H, E, N_CLADES, N_ANCHORS = 5, 512, 32, 8, 3, 20
BASE_DIM, D_OUT, FSW_H = 3, 24, 16


def _write_library(mdir, rng, fsw_clades):
    jax_save_checkpoint(
        os.path.join(mdir, "classifier_model.ckpt"), "NeuralNetClassifierOnly",
        {"model_input_size": V, "model_hidden_size_fc1": H, "model_class_count": N_CLADES},
        {"fc1": _linear(rng, V, H), "fc3": _linear(rng, H, N_CLADES)},
    )
    for c in range(N_CLADES):
        path = os.path.join(mdir, f"model_subtree_{c}.ckpt")
        if c in fsw_clades:
            params = jax.device_get(init_fsw_dist_embed(
                jax.random.PRNGKey(c), K, BASE_DIM, D_OUT, FSW_H, E))
            jax_save_checkpoint(path, "NeuralNetFSW", {
                "model_input_size": K + 1, "model_hidden_size_fc1": FSW_H,
                "model_embedding_size": E, "fsw_k": K, "fsw_base_dim": BASE_DIM,
                "fsw_out_dim": D_OUT}, params)
        else:
            jax_save_checkpoint(path, "NeuralNet", {
                "model_input_size": V, "model_hidden_size_fc1": H, "model_embedding_size": E},
                {"fc1": _linear(rng, V, H), "fc2": _linear(rng, H, E)})
        with open(os.path.join(mdir, f"embeddings_subtree_{c}.csv"), "w") as f:
            for i in range(N_ANCHORS):
                row = rng.normal(size=E).astype(np.float32)
                f.write(f"c{c}_a{i}\t" + "\t".join(str(v) for v in row) + "\n")


@pytest.mark.parametrize("fsw_clades", [(0, 1, 2), (1,)], ids=["fsw", "mixed"])
def test_process_query_data_on_fsw_library_matches_jax(tmp_path, fsw_clades):
    rng = np.random.default_rng(31)
    qdir, mdir = tmp_path / "queries", tmp_path / "library"
    qdir.mkdir()
    mdir.mkdir()
    _write_queries(qdir, rng)
    _write_library(str(mdir), rng, fsw_clades)
    outs = {}
    for tag, run, extra in (("jax", jax_main, []), ("port", main, ["-device", "cpu"])):
        odir = tmp_path / f"out_{tag}"
        odir.mkdir()
        run(["process_query_data", "-input_dir", str(qdir), "-output_dir", str(odir),
             "-k", str(K), "-p", "2", "-classifier_model", str(mdir),
             "-distance_model", str(mdir), *extra])
        outs[tag] = odir
    port, ref = outs["port"], outs["jax"]

    for ext, count in ((".kf", 6), (".npy", 6)):
        files = sorted(f for f in os.listdir(ref) if f.endswith(ext))
        assert len(files) == count and files == sorted(f for f in os.listdir(port) if f.endswith(ext))
        for f in files:
            assert (port / f).read_bytes() == (ref / f).read_bytes(), f

    agreed = _compare_classes(port / "classes.out", ref / "classes.out")
    assert agreed, "no query had a clear top class"
    assert set(agreed.values()) & set(fsw_clades), "no query landed in an FSW subtree"
    for c in sorted(set(agreed.values())):
        dist = f"apples_input_di_mtrx_subtree_{c}.csv"
        header, d_port = _read_table(port / dist)
        ref_header, d_ref = _read_table(ref / dist)
        assert header == ref_header == [""] + [f"c{c}_a{i}" for i in range(N_ANCHORS)]
        e_port = _read_emb(port / f"embedding_subtree_{c}.emb")
        e_ref = _read_emb(ref / f"embedding_subtree_{c}.emb")
        assert list(d_port) == list(d_ref) and list(e_port) == list(e_ref)
        for g in (g for g, cl in agreed.items() if cl == c):
            np.testing.assert_allclose(d_port[g], d_ref[g], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(e_port[g], e_ref[g], rtol=1e-4, atol=1e-5)
            assert d_port[g].shape == (N_ANCHORS,) and (d_port[g] >= 0).all()
            assert e_port[g].shape == (E,)
