"""The model axis of the port's grid of ranks (``parallel.mesh.make_mesh``):
gloo ranks on the CPU, spawned by ``parallel/mp_check.py``, against one
process.

- One batch's summed gradient on the grids (1, 2) and (2, 2), gathered over
  the model axis, equals one process's within rtol 1e-5 of each element
  (and 1e-5 of the largest one, for gradients of rounding-noise size) for
  every parameter of the dense model, the classifier and FSW (shared-vocab
  and per-genome, exact and lazy, ``lookup`` included): n = 5 rows in a
  batch of B = 5, and at (2, 2) also n = 3, where data index 1 holds only
  padding. A gradient n_model times the true one (the JAX package's
  ``shard_map`` with ``check_rep`` off), or a ``lookup`` gradient of one
  rank's slices only, fails it.
- The launch checks: a grid whose n_data x n_model is not the world size
  raises, in one process and at two ranks, and so does a grid on the card
  without one; a hidden size or d_out that
  n_model does not divide raises with both numbers; a cut has the JAX
  package's specs' shapes and refuses ``params_to_jax`` until gathered.

Widths: V = 32 (dense), k = 3 (FSW, V = 32), base_dim 2, d_out 16, H 16,
E 8, 3 classes."""

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu_torch.kmer.vocab import (
    FSW_BASE_MAP,
    canonical_vocab_codes,
    canonical_vocab_size,
    codes_to_digit_matrix,
)
from kf2vecfsw_tpu_torch.models.fsw import FSWDistEmbed
from kf2vecfsw_tpu_torch.models.mlp import Classifier, DistEmbed, params_from_jax, params_to_jax
from kf2vecfsw_tpu_torch.parallel import mesh
from kf2vecfsw_tpu_torch.parallel.mp_check import launch, worker, write_epoch_problem
from kf2vecfsw_tpu_torch.train.checkpoint import _unflatten
from kf2vecfsw_tpu_torch.train.fsw_lazy import LazyPlanes, lazy_distance_epoch
from kf2vecfsw_tpu_torch.train.step import classifier_epoch, distance_epoch, make_adam

from .test_torch_train_step import _leaves

torch.set_num_threads(1)

V, H, E, C = 32, 16, 8, 3
K, BASE_DIM, D_OUT, N_PTS = 3, 2, 16, 24
B, LR, REFRESH = 5, 1e-4, 8
TIMEOUT_S = 90
MODELS = ("dense", "classifier", "fsw_shared", "fsw_pergenome", "fsw_lazy_shared",
          "fsw_lazy_pergenome")
GRIDS = {"1x2": (1, 2, 5), "2x2": (2, 2, 5), "2x2_padding": (2, 2, 3)}


def linear(rng, n_in, n_out):
    bound = 1.0 / np.sqrt(n_in)
    return {"w": rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (n_out,)).astype(np.float32)}


def fsw_params(seed):
    rng = np.random.default_rng(seed)
    return {"lookup": rng.normal(size=(4, BASE_DIM)).astype(np.float32),
            "fsw": {"slices": rng.normal(size=(D_OUT, K * BASE_DIM)).astype(np.float32),
                    "freqs": np.arange(D_OUT, dtype=np.float32)},
            "fc1": linear(rng, D_OUT, H), "fc2": linear(rng, H, E)}


def vocab_weights(seed, n):
    rng = np.random.default_rng(seed)
    w = rng.random((n, canonical_vocab_size(K))).astype(np.float32)
    w[w < 0.3] = 0.0  # absent k-mers
    return w


def point_sets(seed, n):
    """(n, N_PTS, k+1) point sets of distinct canonical k-mers, zero-padded
    past each set's length."""
    rng = np.random.default_rng(seed)
    codes = canonical_vocab_codes(K)
    x = np.zeros((n, N_PTS, K + 1), np.float32)
    for i, m in enumerate(rng.integers(8, N_PTS + 1, n)):
        x[i, :m, :K] = codes_to_digit_matrix(np.sort(rng.choice(codes, m, replace=False)), K,
                                             FSW_BASE_MAP)
        w = rng.random(m) + 0.01
        x[i, :m, K] = w / w.sum()
    return x


def true_dist(rng, n):
    d = np.abs(rng.normal(size=(n, n))).astype(np.float32)
    d = d + d.T
    np.fill_diagonal(d, 0)
    return d


def problem(name, seed, n):
    """(kind, feats, target, params, refresh) of a model of MODELS."""
    rng = np.random.default_rng(seed)
    if name == "classifier":
        return ("classifier", (rng.random((n, V)) * 3).astype(np.float32),
                rng.integers(0, C, n).astype(np.int64),
                {"fc1": linear(rng, V, H), "fc3": linear(rng, H, C)}, 0)
    if name == "dense":
        return ("distance", (rng.random((n, V)) * 3).astype(np.float32), true_dist(rng, n),
                {"fc1": linear(rng, V, H), "fc2": linear(rng, H, E)}, 0)
    feats = vocab_weights(seed, n) if name.endswith("shared") else point_sets(seed, n)
    return ("distance", feats, true_dist(rng, n), fsw_params(seed),
            REFRESH if "lazy" in name else 0)


def one_process(kind, feats, target, params, refresh, order, batch=B, lr=LR):
    """(loss, acc, params, grads of the last batch) of one epoch in this
    process, in the JAX layout."""
    model = params_from_jax(params)
    opt = make_adam(model, lr)
    x, y, o = torch.from_numpy(feats), torch.from_numpy(target), torch.from_numpy(order)
    acc = float("nan")
    if kind == "classifier":
        loss, acc = classifier_epoch(model, opt, x, y, o, batch)
    elif refresh:
        planes = LazyPlanes(x, x.dim() == 2, refresh, -(-o.numel() // batch), 4)
        loss = lazy_distance_epoch(model, opt, planes, y, o, batch)
    else:
        loss = distance_epoch(model, opt, x, y, o, batch)
    grads = params_from_jax(params)
    with torch.no_grad():
        for g, p in zip(grads.parameters(), model.parameters()):
            g.copy_(p.grad)
    return float(loss), float(acc), params_to_jax(model), params_to_jax(grads)


def read_out(path):
    with np.load(path) as data:
        trees = {tag: _unflatten({k.split("::", 1)[1]: data[k] for k in data.files
                                  if k.startswith(f"{tag}::")}) for tag in ("params", "grads")}
        local = {k.split("::", 1)[1]: data[k] for k in data.files if k.startswith("local::")}
        return float(data["loss"]), float(data["acc"]), trees["params"], trees["grads"], local


def run_grid_epochs(root, n_data, n_model, problems, batch=B, lr=LR, resume_states=None,
                    save_states=None):
    """One epoch of each (name, kind, feats, target, params, refresh, order)
    on the grid n_data x n_model, in one launch, from the trainer state
    ``resume_states[name]`` when given, autosaving the state after it to
    ``save_states[name]`` when given; returns, per name, every rank's
    (loss, acc, params, grads, local cut)."""
    root.mkdir(exist_ok=True)
    argv = []
    for name, kind, feats, target, params, refresh, order in problems:
        path = root / f"{name}.npz"
        write_epoch_problem(str(path), kind, feats, target, order, batch, lr, params,
                            n_model=n_model, refresh=refresh,
                            resume_state=(resume_states or {}).get(name, ""),
                            save_state=(save_states or {}).get(name, ""))
        argv += [str(path), str(root / f"{name}_out{{rank}}.npz")]
    world = n_data * n_model
    launch([worker("epoch") + argv] * world, "gloo", TIMEOUT_S)
    return {name: [read_out(root / f"{name}_out{r}.npz") for r in range(world)]
            for name, *_ in problems}


@pytest.fixture(scope="module")
def grid_gradients(tmp_path_factory):
    out = {}
    for tag, (n_data, n_model, n) in GRIDS.items():
        problems, refs = [], {}
        for i, name in enumerate(MODELS):
            kind, feats, target, params, refresh = problem(name, 40 + i, n)
            order = np.arange(n, dtype=np.int64)[::-1].copy()
            problems.append((name, kind, feats, target, params, refresh, order))
            refs[name] = one_process(kind, feats, target, params, refresh, order)
        got = run_grid_epochs(tmp_path_factory.mktemp(tag), n_data, n_model, problems)
        out[tag] = {name: (got[name], refs[name]) for name in MODELS}
    return out


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_one_batch_gradient_on_a_grid_is_one_process(grid_gradients, grid, model):
    ranks, (loss, _, _, grads) = grid_gradients[grid][model]
    ref = dict(_leaves(grads))
    scale = max(np.abs(v).max() for v in ref.values())
    for r, (r_loss, _, _, r_grads, _) in enumerate(ranks):
        np.testing.assert_allclose(r_loss, loss, rtol=1e-5, err_msg=f"rank {r}")
        got = dict(_leaves(r_grads))
        assert got.keys() == ref.keys()
        for name in ref:
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=f"rank {r} {name}")
    if model.startswith("fsw"):  # the lookup's gradient: every cut's part, on every rank
        assert np.abs(ref["lookup"]).max() > 1e-3 * scale


def test_a_grid_must_cover_the_world(tmp_path):
    assert not torch.distributed.is_initialized()  # this process: a world of one
    with pytest.raises(ValueError, match="needs 2 ranks, but the world has 1"):
        mesh.make_mesh(1, 2, "cpu")
    assert mesh.make_mesh(1, 1, "cpu") == mesh.data_mesh(torch.device("cpu"))
    if not torch.cuda.is_available():  # a grid on the card without one raises
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            mesh.make_mesh(1, 1, "cuda")
    # two ranks asked for a 2 x 2 grid: every rank raises before any group
    with pytest.raises(RuntimeError, match="needs 4 ranks, but the world has 2"):
        launch([worker("grid") + ["2", "2", "train_classifier", "-input_dir", str(tmp_path),
                                  "-subtrees", str(tmp_path / "t.subtrees"), "-o",
                                  str(tmp_path), "-device", "cpu"]] * 2, "gloo", TIMEOUT_S)


def _fake_grid(n_model, model_rank=0):
    """The grid of one rank of a world of n_model ranks, without a group
    (shard_module makes no collective)."""
    return mesh.DataMesh(n_model, model_rank, torch.device("cpu"), True, n_model)


@pytest.mark.parametrize("module,what", [
    (DistEmbed(V, 15, E), "hidden size 15"), (Classifier(V, 15, C), "hidden size 15"),
    (FSWDistEmbed(K, BASE_DIM, 15, H, E), "d_out 15")])
def test_a_cut_that_does_not_divide_raises(module, what):
    with pytest.raises(ValueError, match=f"{what} does not divide by n_model 2"):
        mesh.shard_module(module, _fake_grid(2))


def test_cuts_have_the_shapes_of_the_jax_specs():
    """fc1 column-parallel and fc2 / fc3 row-parallel for the dense models,
    the slices, freqs and fc1's input columns for FSW (the JAX package's
    ``dist_embed_specs``, ``classifier_specs``, ``fsw_dist_embed_specs``);
    the rank's part is the model-rank-th; a cut refuses params_to_jax."""
    full = FSWDistEmbed(K, BASE_DIM, D_OUT, H, E)
    cut = mesh.shard_module(full, _fake_grid(2, 1))
    shapes = {n: tuple(p.shape) for n, p in cut.named_parameters()}
    assert shapes == {"lookup": (4, BASE_DIM), "slices": (D_OUT // 2, K * BASE_DIM),
                      "freqs": (D_OUT // 2,), "fc1.weight": (H, D_OUT // 2), "fc1.bias": (H,),
                      "fc2.weight": (E, H), "fc2.bias": (E,)}
    assert torch.equal(cut.slices, full.slices[D_OUT // 2:]) and cut.fc1.in_features == D_OUT // 2
    dense = mesh.shard_module(DistEmbed(V, H, E), _fake_grid(2))
    assert {n: tuple(p.shape) for n, p in dense.named_parameters()} == {
        "fc1.weight": (H // 2, V), "fc1.bias": (H // 2,), "fc2.weight": (E, H // 2),
        "fc2.bias": (E,)}
    with pytest.raises(ValueError, match="gather_module it first"):
        params_to_jax(dense)
    assert mesh.shard_module(full, _fake_grid(1)) is full  # no model axis: no cut
