"""FSW ``train_model_set`` through the CLI of both packages (the port with
``-device cpu``), on .npy point sets that the port's ``get_kmers`` writes:

- full genomes at k=3, which cover the vocab and take the shared-vocab
  route, lazy by default and exact with ``-fsw_lazy_refresh 0``; with a
  device memory too small for the refresh, the lazy auto-check falls back;
- short contigs at k=5 (at most 96 k-mers, padded to 128 < V/3 = 170), which
  take the per-genome route.

Both packages log the same route lines and write NeuralNetFSW checkpoints
with the same meta. Each package's ``query`` reads the other's checkpoints:
a backbone genome queried against a library embeds as the library's export
wrote it, within rtol 1e-4 / atol 1e-5 (the FSW forward's tolerance). An FSW
trainer state resumes across the packages both ways with every Adam moment,
and a resumed run of the port equals an uninterrupted one."""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.cli import main as jax_main
from kf2vecfsw_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kf2vecfsw_tpu.train.distance import train_model_set_func as jax_train_model_set_func
from kf2vecfsw_tpu.train.resume import load_trainer_state as jax_load_trainer_state
from kf2vecfsw_tpu_torch.cli import main
from kf2vecfsw_tpu_torch.models.fsw import FSWDistEmbed, init_fsw_dist_embed_
from kf2vecfsw_tpu_torch.models.mlp import adam_state_to_jax
from kf2vecfsw_tpu_torch.train.checkpoint import load_checkpoint
from kf2vecfsw_tpu_torch.train.distance import train_model_set_func
from kf2vecfsw_tpu_torch.train.resume import load_trainer_state, start_or_resume
from kf2vecfsw_tpu_torch.tree.distance import write_di_mtrx

from .test_torch_fsw_train import _leaves
from .test_torch_slice import _read_emb

torch.set_num_threads(1)

H, E, BASE_DIM, D_OUT = 32, 16, 2, 16
DATASETS = {  # name: (k, sequences per clade, sequence length)
    "genomes": (3, (5, 4), 600),
    "contigs": (5, (5, 3), 90),
}
ROUTE_MARK = "FSW "


def _dataset(root, name):
    """FASTA -> port get_kmers .npy, a .subtrees file and a .di_mtrx per clade."""
    k, sizes, length = DATASETS[name]
    rng = np.random.default_rng(len(name))
    fna, feats = root / f"{name}_fna", root / f"{name}_k{k}"
    fna.mkdir()
    rows = []
    for c, n in enumerate(sizes):
        names = [f"c{c}{name[0]}{i}" for i in range(n)]
        rows += [(g, c) for g in names]
        for g in names:
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=length)
            (fna / f"{g}.fna").write_bytes(b">s\n" + seq.tobytes() + b"\n")
        d = np.abs(rng.normal(size=(n, n))) * 0.1
        d = d + d.T
        np.fill_diagonal(d, 0)
        write_di_mtrx(str(root / f"{name}_subtree_{c}.di_mtrx"), names[::-1], d)
    sub = root / f"{name}.subtrees"
    sub.write_text("genome clade\n" + "".join(f"{g} {c}\n" for g, c in rows))
    main(["get_kmers", "-input_dir", str(fna), "-output_dir", str(feats), "-k", str(k),
          "-device", "cpu"])
    return str(feats), str(sub), rows


def _train(run, feats, sub, root, out, *flags, device=True):
    run(["train_model_set", "-input_dir", feats, "-subtrees", sub, "-true_dist", str(root),
         "-o", str(out), "-hidden_sz", str(H), "-embed_sz", str(E), "-batch_sz", "4",
         "-lr", "1e-3", "-base_dim", str(BASE_DIM), "-fswout_dim", str(D_OUT), *flags,
         *(["-device", "cpu"] if device else [])])


def _route_lines(out):
    lines = []
    for path in sorted(glob.glob(os.path.join(out, "train_model_*.log"))):
        for line in open(path):
            if ROUTE_MARK in line:
                lines.append(line[line.index(ROUTE_MARK):].rstrip("\n"))
    return lines


def _query_own_genomes(run, feats, rows, library, out, device):
    """Query the first genome of each clade against ``library``; returns
    {clade: {genome: embedding}}."""
    qdir = out / "q"
    qdir.mkdir(parents=True)
    picks = {c: next(g for g, cl in rows if cl == c) for c in sorted({c for _, c in rows})}
    k = int(feats.rsplit("_k", 1)[1])
    for g in picks.values():
        shutil.copy(os.path.join(feats, f"{g}_k{k}.npy"), qdir / f"{g}_k{k}.npy")
    (qdir / "classes.out").write_text(
        "genome\ttop_class\n" + "".join(f"{g}\t{c}\n" for c, g in picks.items()))
    run(["query", "-input_dir", str(qdir), "-model", str(library), "-classes", str(qdir),
         "-o", str(out), *(["-device", "cpu"] if device else [])])
    return {c: _read_emb(out / f"embedding_subtree_{c}.emb") for c in picks}


@pytest.mark.parametrize("case,data,flags,routes", [
    ("default", "genomes", [], [
        "FSW shared-vocab path: V=32 (one shared sort per batch)",
        "FSW lazy sort-refresh path: refresh every 128 steps (auto-enabled; pass "
        "-fsw_lazy_refresh 0 for the exact per-step sort)"]),
    ("exact", "genomes", ["-fsw_lazy_refresh", "0"], [
        "FSW shared-vocab path: V=32 (one shared sort per batch)"]),
    ("over_budget", "genomes", [], [
        "FSW shared-vocab path: V=32 (one shared sort per batch)",
        "FSW lazy-refresh auto-check: the refresh sort transients exceed the per-device HBM "
        "budget for this clade; using the exact shared path"]),
    ("pergenome", "contigs", ["-fsw_lazy_refresh", "2"], [
        "FSW lazy sort-refresh path (per-genome sort orders): refresh every 2 steps"]),
])
def test_train_model_set_fsw_matches_jax(tmp_path, monkeypatch, case, data, flags, routes):
    feats, sub, rows = _dataset(tmp_path, data)
    if case == "over_budget":
        monkeypatch.setenv("KF2VEC_HBM_BYTES", "4096")
    outs = {}
    for tag, run, device in (("jax", jax_main, False), ("port", main, True)):
        outs[tag] = tmp_path / tag
        _train(run, feats, sub, tmp_path, outs[tag], "-e", "3", *flags, device=device)
        n_clades = len(DATASETS[data][1])
        assert _route_lines(outs[tag]) == routes * n_clades, tag
    monkeypatch.delenv("KF2VEC_HBM_BYTES", raising=False)
    k = DATASETS[data][0]
    for c in range(len(DATASETS[data][1])):
        ckpt = f"model_subtree_{c}.ckpt"
        jname, jmeta, _ = jax_load_checkpoint(str(outs["jax"] / ckpt))
        pname, pmeta, params = load_checkpoint(str(outs["port"] / ckpt))
        assert jname == pname == "NeuralNetFSW"
        assert sorted(jmeta) == sorted(pmeta)
        for key in ("model_input_size", "fsw_k", "fsw_base_dim", "fsw_out_dim"):
            assert jmeta[key] == pmeta[key]
        assert (pmeta["fsw_k"], pmeta["fsw_out_dim"]) == (k, D_OUT)
        assert np.shape(params["fsw"]["slices"]) == (D_OUT, k * BASE_DIM)
        assert np.isfinite(pmeta["lowest_loss"]) and 0 <= pmeta["best_epoch"] < 3

    # each package's query reads the other's library
    for lib, run, device in (("port", jax_main, False), ("jax", main, True)):
        got = _query_own_genomes(run, feats, rows, outs[lib], tmp_path / f"q_{lib}", device)
        for c, emb in got.items():
            export = _read_emb(outs[lib] / f"embeddings_subtree_{c}.csv")
            for g, e in emb.items():
                assert e.shape == (E,)
                np.testing.assert_allclose(e, export[g], rtol=1e-4, atol=1e-5, err_msg=g)


def _train_func(pkg, feats, sub, root, out, epochs, **kw):
    """train_model_set_func of either package with autosaves every 2 epochs."""
    fn = jax_train_model_set_func if pkg == "jax" else train_model_set_func
    if pkg == "port":
        kw["device"] = "cpu"
    files = sorted(glob.glob(os.path.join(feats, "*.npy")))
    return fn(feats, files, sub, str(root), epochs, H, E, 4, 1e-3, 3e-6, 2000, None, 28,
              str(out), base_dim=BASE_DIM, fswout_dim=D_OUT, autosave_every=2, **kw)


@pytest.mark.parametrize("refresh", [0, 2])
def test_fsw_resume_equals_an_uninterrupted_run(tmp_path, refresh):
    """The exact route, and the lazy route at R = 2: clade 0 (2 batches an
    epoch) refreshes every epoch, clade 1 (1 batch) every 2 epochs, so an
    uninterrupted run refreshes where the resumed run starts, at epoch 2."""
    feats, sub, _ = _dataset(tmp_path, "genomes")
    whole, split = tmp_path / "whole", tmp_path / "split"
    _train_func("port", feats, sub, tmp_path, whole, 4, fsw_lazy_refresh=refresh)
    _train_func("port", feats, sub, tmp_path, split, 2, fsw_lazy_refresh=refresh)
    assert load_trainer_state(str(split / "trainer_state_subtree_0.ckpt"))[0] == 1
    _train_func("port", feats, sub, tmp_path, split, 4, fsw_lazy_refresh=refresh, resume=True)
    logs = "".join(open(p).read() for p in glob.glob(str(split / "train_model_*.log")))
    assert "Resuming from epoch 2" in logs
    for c in range(2):
        a = load_checkpoint(str(whole / f"model_subtree_{c}.ckpt"))
        b = load_checkpoint(str(split / f"model_subtree_{c}.ckpt"))
        assert a[1] == b[1]
        for (name, x), (_, y) in zip(_leaves(a[2]), _leaves(b[2])):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_fsw_trainer_states_resume_across_packages(tmp_path):
    """The autosave of default-flag FSW training: JAX's loads into the port
    with every Adam moment (lookup, fsw/slices, fsw/freqs and the Linear
    layers), the port trains on from it, and the JAX package resumes the
    port's autosave, whose moments it reads back as the port wrote them."""
    feats, sub, _ = _dataset(tmp_path, "genomes")
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    _train_func("jax", feats, sub, tmp_path, jax_out, 2)
    state_path = str(jax_out / "trainer_state_subtree_0.ckpt")
    jstate = jax_load_trainer_state(state_path)
    assert jstate[0] == 1 and int(jstate[2]["count"]) == 4  # 2 batches x 2 epochs
    names = ["fc1/b", "fc1/w", "fc2/b", "fc2/w", "fsw/freqs", "fsw/slices", "lookup"]

    model = init_fsw_dist_embed_(FSWDistEmbed(3, BASE_DIM, D_OUT, H, E),
                                 torch.Generator().manual_seed(28))
    st = start_or_resume(model, torch.Generator(), 5, state_path, True, None, 1e-3,
                         torch.device("cpu"))
    assert st.start_epoch == 2
    carried = adam_state_to_jax(st.opt, st.model)
    assert int(carried["count"]) == 4
    for m in ("mu", "nu"):
        got, ref = dict(_leaves(carried[m])), dict(_leaves(jstate[2][m]))
        assert sorted(got) == sorted(ref) == names
        for name in names:
            assert np.abs(ref[name]).max() > 0, name
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)

    # the port trains on from JAX's autosave
    _train_func("port", feats, sub, tmp_path, jax_out, 4, resume=True)
    after = load_trainer_state(state_path)
    assert after[0] == 3 and int(after[2]["count"]) == 8 and np.isfinite(after[4])

    # the JAX package resumes the port's autosave
    _train_func("port", feats, sub, tmp_path, port_out, 2)
    pstate = load_trainer_state(str(port_out / "trainer_state_subtree_0.ckpt"))
    jview = jax_load_trainer_state(str(port_out / "trainer_state_subtree_0.ckpt"))
    for m in ("mu", "nu"):
        got, ref = dict(_leaves(jview[2][m])), dict(_leaves(pstate[2][m]))
        assert sorted(got) == names
        for name in names:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    _train_func("jax", feats, sub, tmp_path, port_out, 4, resume=True)
    logs = "".join(open(p).read() for p in glob.glob(str(port_out / "train_model_*.log")))
    assert "Resuming from epoch 2" in logs
    state = jax_load_trainer_state(str(port_out / "trainer_state_subtree_0.ckpt"))
    assert state[0] == 3 and int(state[2]["count"]) == 8 and np.isfinite(state[4])
