"""One epoch of each FSW training route of the port against the JAX runner it
replaces, from the same params and in the JAX runner's own item order, and
the lazy route's refresh cadence against the JAX span path: equal where
both count the same steps in one span, and the port's own count beside the
JAX runner's in the three cases where the JAX runner's bucket padding or
device spans move its refreshes (``kf2vecfsw_tpu_torch/train/fsw_lazy.py``).

n = 10 items in batches of B = 4 (4, 4 and a partial tail of 2: three Adam
steps; the JAX runner's fourth, all-padding batch is an exact no-op), k=4
(V=136), base_dim 2, 16 slices, H 32, E 16, lr 1e-4.

The epoch loss agrees within rtol 1e-4: the FSW forward carries the
tolerance of ``tests/test_torch_fsw.py`` into the loss. Params and Adam's
moments after the epoch are held to the sign-flip bound of
``tests/test_torch_train_step.py``: atol = 2 * 1.02 * lr * steps + rtol 1e-4,
the median difference of every non-bias leaf below 1e-3 of that bound (a
gradient element that rounds to opposite signs in XLA:CPU and PyTorch moves
a weight by up to 2 * 1.02 * lr a step; biases are rounding noise of a
loss that ignores a common shift of the embeddings)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.models import fsw as jfsw
from kf2vecfsw_tpu.parallel.mesh import MODEL_AXIS, make_mesh, shard_params
from kf2vecfsw_tpu.train.fsw_lazy import FSWLazyEpochRunner, FSWLazyPerGenomeRunner
from kf2vecfsw_tpu.train.step import DistanceEpochRunner, _packed_perm, adam_init, split_spans
from kf2vecfsw_tpu_torch.kmer.vocab import FSW_BASE_MAP, canonical_vocab_codes, codes_to_digit_matrix
from kf2vecfsw_tpu_torch.train import fsw_lazy
from kf2vecfsw_tpu_torch.train.distance import train_model_set_func
from kf2vecfsw_tpu_torch.models.mlp import adam_state_to_jax, params_from_jax, params_to_jax
from kf2vecfsw_tpu_torch.train.fsw_lazy import LazyPlanes, lazy_distance_epoch
from kf2vecfsw_tpu_torch.train.step import distance_epoch, make_adam
from kf2vecfsw_tpu_torch.tree.distance import write_di_mtrx

from .test_torch_fsw_train import _leaves, _params, _point_sets, _vocab_weights

torch.set_num_threads(1)

N, B, K = 10, 4, 4
STEPS = 3
LR = 1e-4
ADAM_STEP = 1.02  # bound of a bias-corrected Adam step over its first steps, in lr
SPECS = jfsw.fsw_dist_embed_specs(MODEL_AXIS)


def _assert_trees_close(got, ref, lr=LR, steps=STEPS):
    atol = 2 * ADAM_STEP * lr * steps
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-4, atol=atol, err_msg=name)
        if not name.endswith("/b"):
            assert np.median(np.abs(got[name] - ref[name])) <= 1e-3 * atol, name


def _dist(seed, n=N):
    rng = np.random.default_rng(seed)
    d = np.abs(rng.normal(size=(n, n))).astype(np.float32)
    d = d + d.T
    np.fill_diagonal(d, 0)
    return d


def _feats(route, seed, n=N):
    if route.endswith("shared"):
        return _vocab_weights(seed, n)
    rng = np.random.default_rng(seed)
    return _point_sets(seed, lengths=tuple(int(m) for m in rng.integers(12, 48, n)))


def _jax_runner(route, mesh, n=N, refresh=0):
    if route == "exact_shared":
        return DistanceEpochRunner(mesh, jfsw.make_fsw_shared_apply(K), SPECS, n, B)
    if route == "exact_pergenome":
        return DistanceEpochRunner(mesh, jfsw.fsw_dist_embed_apply, SPECS, n, B)
    cls = FSWLazyEpochRunner if route == "lazy_shared" else FSWLazyPerGenomeRunner
    return cls(mesh, K, SPECS, n, B, refresh_steps=refresh)


def _port_epoch(route, model, opt, x, dist, order, refresh=0):
    if route.startswith("exact"):
        return distance_epoch(model, opt, x, dist, order, B)
    planes = LazyPlanes(x, route == "lazy_shared", refresh, -(-N // B), group=4)
    loss = lazy_distance_epoch(model, opt, planes, dist, order, B)
    assert planes.refreshes == (STEPS if refresh == 1 else 1)
    return loss


@pytest.mark.parametrize("route,refresh", [
    ("exact_shared", 0), ("exact_pergenome", 0),
    ("lazy_shared", 1), ("lazy_shared", 8), ("lazy_pergenome", 1), ("lazy_pergenome", 8)])
def test_fsw_epoch_matches_jax_runner(route, refresh):
    seed = 20 + refresh
    x, dist = _feats(route, seed), _dist(seed)
    params = _params(seed)
    mesh = make_mesh(1, 1)
    runner = _jax_runner(route, mesh, refresh=refresh)
    assert runner.n_batches == STEPS + 1  # one all-padding batch
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    order = np.asarray(_packed_perm(key, runner.n_bucket, N))[:N]
    assert sorted(order) == list(range(N))
    p_jax = shard_params(params, SPECS, mesh)
    p_jax, o_jax, loss_jax = runner.run_epoch(p_jax, adam_init(p_jax), runner.pad_items(x),
                                              runner.pad_dist(dist), key, LR)

    model = params_from_jax(params)
    opt = make_adam(model, LR)
    loss = _port_epoch(route, model, opt, torch.from_numpy(x), torch.from_numpy(dist),
                       torch.from_numpy(order.astype(np.int64)), refresh)
    np.testing.assert_allclose(float(loss), float(loss_jax), rtol=1e-4)
    _assert_trees_close(params_to_jax(model), jax.device_get(p_jax))
    state, o_jax = adam_state_to_jax(opt, model), jax.device_get(o_jax)
    assert int(state["count"]) == int(o_jax["count"]) == STEPS
    _assert_trees_close(state["mu"], o_jax["mu"])
    _assert_trees_close(state["nu"], o_jax["nu"])


@pytest.mark.parametrize("route", ["shared", "pergenome"])
def test_lazy_epoch_at_refresh_1_equals_the_exact_epoch(route):
    """Refreshing before every step is the exact route: the same loss and,
    within the sign-flip bound, the same params after the epoch."""
    x, dist = _feats(route, 30), _dist(30)
    order = torch.randperm(N, generator=torch.Generator().manual_seed(30))
    out = []
    for name in (f"exact_{route}", f"lazy_{route}"):
        model = params_from_jax(_params(30))
        opt = make_adam(model, LR)
        loss = _port_epoch(name, model, opt, torch.from_numpy(x), torch.from_numpy(dist), order,
                           refresh=1)
        out.append((float(loss), params_to_jax(model)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    _assert_trees_close(out[1][1], out[0][1])


class _CountingLazyRunner(FSWLazyEpochRunner):
    """The JAX lazy runner with a host callback in its refresh, which runs
    inside the span's device loop."""

    def __init__(self, *args, **kw):
        self.refresh_calls = []
        super().__init__(*args, **kw)

    def _refresh_impl(self, params, feats):
        jax.debug.callback(lambda: self.refresh_calls.append(1))
        return super()._refresh_impl(params, feats)


@pytest.mark.parametrize("refresh", [1, 3, 4, 8])
def test_refresh_cadence_equals_the_jax_span_path(refresh):
    """4 epochs of 2 batches (8 items, B = 4), as one JAX span of 4 epochs:
    R = 4 refreshes before epochs 0 and 2, R = 1 before every step, R = 3
    before every epoch (the interval rounds down to whole epochs) and R = 8
    once."""
    n, epochs = 8, 4
    w, dist = _vocab_weights(40, n), _dist(40, n)
    mesh = make_mesh(1, 1)
    runner = _CountingLazyRunner(mesh, K, SPECS, n, B, refresh_steps=refresh)
    assert runner.n_batches == 2
    params = shard_params(_params(40), SPECS, mesh)
    best = (jax.tree.map(jnp.copy, params), jnp.float32(np.inf), jnp.int32(-1))
    _, _, _, losses = runner.run_epoch_span(params, adam_init(params), best, jnp.asarray(w),
                                            jnp.asarray(dist), jax.random.PRNGKey(40), 0, epochs,
                                            (1e-3, 1e-4, 2000.0, 0.1, 100))
    assert np.isfinite(np.asarray(losses)).all()

    model = params_from_jax(_params(40))
    opt = make_adam(model, 1e-3)
    planes = LazyPlanes(torch.from_numpy(w), True, refresh, 2, group=8)
    gen = torch.Generator().manual_seed(40)
    for _ in range(epochs):
        loss = lazy_distance_epoch(model, opt, planes, torch.from_numpy(dist),
                                   torch.randperm(n, generator=gen), B)
        assert np.isfinite(float(loss))
    assert planes.refreshes == len(runner.refresh_calls) == {1: 8, 3: 4, 4: 2, 8: 1}[refresh]


SCHEDULE = (1e-3, 1e-4, 2000.0, 0.1, 100)


def _jax_span_refreshes(n, batch, refresh, spans, seed):
    """Refreshes of the JAX lazy runner (shared vocab) over (epoch0, span)
    pieces of a run, as its span path drives them."""
    w, dist = _vocab_weights(seed, n), _dist(seed, n)
    mesh = make_mesh(1, 1)
    runner = _CountingLazyRunner(mesh, K, SPECS, n, batch, refresh_steps=refresh)
    params = shard_params(_params(seed), SPECS, mesh)
    opt = adam_init(params)
    best = (jax.tree.map(jnp.copy, params), jnp.float32(np.inf), jnp.int32(-1))
    for epoch0, span in spans:
        params, opt, best, losses = runner.run_epoch_span(
            params, opt, best, jnp.asarray(w), jnp.asarray(dist), jax.random.PRNGKey(seed),
            epoch0, span, SCHEDULE)
        assert np.isfinite(np.asarray(losses)).all()
    return runner, len(runner.refresh_calls)


def test_refresh_cadence_counts_real_steps_where_jax_counts_the_bucket():
    """n = 670, B = 16, R = 128, 6 epochs in one JAX span: the JAX runner
    counts ceil(bucket_items(670) / 16) = 47 steps an epoch and refreshes
    every 128 // 47 = 2 epochs (3 times); the port counts the 42 real steps
    and refreshes every 128 // 42 = 3 epochs (twice)."""
    assert "kf2vecfsw_tpu/train/step.py:225-228" in fsw_lazy.__doc__
    n, batch, epochs = 670, 16, 6
    runner, jax_count = _jax_span_refreshes(n, batch, 128, [(0, epochs)], 41)
    assert (runner.n_bucket, runner.n_batches) == (752, 47)
    assert jax_count == 3

    model = params_from_jax(_params(41))
    opt = make_adam(model, 1e-3)
    n_batches = -(-n // batch)
    planes = LazyPlanes(torch.from_numpy(_vocab_weights(41, n)), True, 128, n_batches, group=8)
    gen = torch.Generator().manual_seed(41)
    dist = torch.from_numpy(_dist(41, n))
    refreshed_at = []
    for epoch in range(epochs):
        before = planes.refreshes
        loss = lazy_distance_epoch(model, opt, planes, dist, torch.randperm(n, generator=gen),
                                   batch)
        assert np.isfinite(float(loss))
        refreshed_at += [epoch] * (planes.refreshes - before)
    assert (n_batches, planes.interval) == (42, 126)
    assert refreshed_at == [0, 3]


def _shared_clade(root, n_train, n_test, seed=42):
    """.npy point sets of every canonical 3-mer (the shared-vocab route) for
    one clade, its .subtrees and .di_mtrx, and a -test_set file."""
    rng = np.random.default_rng(seed)
    codes = canonical_vocab_codes(3)
    feats = root / "npy"
    feats.mkdir()
    names = [f"g{i}" for i in range(n_train + n_test)]
    for g in names:
        w = rng.random(codes.size) + 0.01
        mat = np.column_stack((codes_to_digit_matrix(codes, 3, FSW_BASE_MAP), w / w.sum()))
        np.save(feats / f"{g}_k3.npy", mat.astype(np.float32))
    write_di_mtrx(str(root / "t_subtree_0.di_mtrx"), names, _dist(seed, len(names)))
    (root / "t.subtrees").write_text("genome clade\n" + "".join(f"{g} 0\n" for g in names))
    (root / "test.txt").write_text("".join(f"{g}.fna\n" for g in names[n_train:]))
    return str(feats), str(root / "t.subtrees"), str(root / "test.txt")


def _port_trainer_refreshes(monkeypatch, tmp_path, epochs, refresh, **kw):
    """Epochs of the port's train_model_set (8 train genomes, B = 4: 2 steps
    an epoch; 2 more genomes with a test set) in which a lazy refresh fell."""
    with_test_set = kw.pop("test_set", False)
    feats, sub, test_set = _shared_clade(tmp_path, 8, 2 if with_test_set else 0)
    epochs_at = []
    real = fsw_lazy.LazyPlanes.refresh

    def counting(planes, model):
        epochs_at.append(planes.step // 2)
        return real(planes, model)

    monkeypatch.setattr(fsw_lazy.LazyPlanes, "refresh", counting)
    if with_test_set:
        kw["test_ids_path"] = test_set
    files = sorted(str(p) for p in (tmp_path / "npy").glob("*.npy"))
    train_model_set_func(feats, files, sub, str(tmp_path), epochs, 16, 8, 4, 1e-3, 1e-4, 2000,
                         None, 28, str(tmp_path / "out"), base_dim=2, fswout_dim=8,
                         fsw_lazy_refresh=refresh, device="cpu", **kw)
    log = "".join(p.read_text() for p in (tmp_path / "out").glob("train_model_*.log"))
    assert f"FSW lazy sort-refresh path: refresh every {refresh} steps" in log
    return epochs_at


def test_refresh_cadence_with_a_test_set(monkeypatch, tmp_path):
    """A -test_set run, R = 3, 2 steps an epoch, 4 epochs: the port refreshes
    every R // 2 = 1 epoch, as without a test set; the JAX runner, one epoch
    a call, once its plane has aged 3 steps, every ceil(3 / 2) = 2 epochs."""
    assert "kf2vecfsw_tpu/train/fsw_lazy.py:333-368" in fsw_lazy.__doc__
    port = _port_trainer_refreshes(monkeypatch, tmp_path, 4, 3, test_set=True)
    assert port == [0, 1, 2, 3]
    log = "".join(p.read_text() for p in (tmp_path / "out").glob("train_model_*.log"))
    assert "Number of Test Samples: 2" in log and "Test loss: " in log

    mesh = make_mesh(1, 1)
    runner = _CountingLazyRunner(mesh, K, SPECS, 8, B, refresh_steps=3)
    assert runner.n_batches == 2
    w, dist = jnp.asarray(_vocab_weights(43, 8)), jnp.asarray(_dist(43, 8))
    params = shard_params(_params(43), SPECS, mesh)
    opt = adam_init(params)
    refreshed_at = []
    for epoch in range(4):
        before = len(runner.refresh_calls)
        params, opt, loss = runner.run_epoch(params, opt, w, dist,
                                             jax.random.fold_in(jax.random.PRNGKey(43), epoch),
                                             1e-3)
        jax.block_until_ready(loss)
        refreshed_at += [epoch] * (len(runner.refresh_calls) - before)
    assert refreshed_at == [0, 2]


def test_refresh_cadence_with_a_save_interval(monkeypatch, tmp_path):
    """-save_interval 3 over 8 epochs, R = 4, 2 steps an epoch: the port
    refreshes every 2 epochs (4 times) with the flag or without it. The
    JAX trainer's span edges fall at epochs 1, 4 and 7, so split_spans cuts
    the run into 1-epoch spans and each refreshes at its start (8 times);
    without the flag it runs one 8-epoch span and refreshes 4 times."""
    assert "kf2vecfsw_tpu/train/distance.py:513-518" in fsw_lazy.__doc__
    port = _port_trainer_refreshes(monkeypatch, tmp_path, 8, 4, save_interval=3)
    assert port == [0, 2, 4, 6]
    assert sorted(p.name for p in (tmp_path / "out").glob("model_epoch_*")) == [
        "model_epoch_1", "model_epoch_4", "model_epoch_7", "model_epoch_8"]

    boundaries = sorted(e + 1 for e in range(0, 8, 3))  # kf2vecfsw_tpu/train/distance.py:517-518
    spans = split_spans(0, 8, boundaries)
    assert spans == [(e, 1) for e in range(8)]
    assert _jax_span_refreshes(8, B, 4, spans, 44)[1] == 8
    assert _jax_span_refreshes(8, B, 4, split_spans(0, 8, []), 44)[1] == 4
