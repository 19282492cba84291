"""The port's FSW training forwards against the JAX package's, on the same numpy
parameters and inputs (k=4 so V=136, base_dim 2, 16 slices, H 32, E 16, B 3):
value and gradient of the exact per-genome and shared-vocab forwards (the
shared one also at k=9, V=131,072), the sort's backward, the lazy route's
refreshes and its forward at a fresh permutation, the lazy gate, the vocab
weights and the Adam state of an FSW model.

Every point set holds distinct k-mers and the projections are drawn from a
normal law, so no two projections of a row tie and both packages sort them
the same way. Values use the tolerance of ``tests/test_torch_fsw.py`` (rtol
1e-4, atol 1e-5). A gradient leaf is held to atol 1e-4 * max|reference| +
rtol 1e-3: each element sums up to B*N products whose order differs between
XLA and PyTorch, and the slices' and the lookup's gradients add the
cotangents of every point of a row through the unsort."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.ingest.kmers import point_sets_to_vocab_weights as jax_vocab_weights
from kf2vecfsw_tpu.models import fsw as jfsw
from kf2vecfsw_tpu.train import fsw_lazy as jlazy
from kf2vecfsw_tpu_torch.ingest.kmers import point_sets_to_vocab_weights
from kf2vecfsw_tpu_torch.kernels.sort import sort_rows_reference
from kf2vecfsw_tpu_torch.kmer.vocab import (
    FSW_BASE_MAP,
    canonical_vocab_codes,
    canonical_vocab_size,
    codes_to_digit_matrix,
)
from kf2vecfsw_tpu_torch.models import fsw as tfsw
from kf2vecfsw_tpu_torch.models.mlp import (
    adam_state_from_jax,
    adam_state_to_jax,
    params_from_jax,
)
from kf2vecfsw_tpu_torch.train import fsw_lazy as tlazy
from kf2vecfsw_tpu_torch.train.step import make_adam

torch.set_num_threads(1)

K, BASE_DIM, D_OUT, H, E, B = 4, 2, 16, 32, 16, 3
V = canonical_vocab_size(K)
N_PTS = 48


def _params(seed, k=K):
    rng = np.random.default_rng(seed)

    def linear(n_in, n_out):
        bound = 1.0 / np.sqrt(n_in)
        return {"w": rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                "b": rng.uniform(-bound, bound, (n_out,)).astype(np.float32)}

    return {
        "lookup": rng.normal(size=(4, BASE_DIM)).astype(np.float32),
        "fsw": {"slices": rng.normal(size=(D_OUT, k * BASE_DIM)).astype(np.float32),
                "freqs": np.arange(D_OUT, dtype=np.float32)},
        "fc1": linear(D_OUT, H),
        "fc2": linear(H, E),
    }


def _point_sets(seed, lengths=(40, 17, 48), n=N_PTS, k=K):
    """(B, n, k+1) point sets of distinct canonical k-mers (the rows of
    get_kmers), zero-padded past each set's length."""
    rng = np.random.default_rng(seed)
    codes = canonical_vocab_codes(k)
    x = np.zeros((len(lengths), n, k + 1), np.float32)
    for i, m in enumerate(lengths):
        pick = np.sort(rng.choice(codes, m, replace=False))
        x[i, :m, :k] = codes_to_digit_matrix(pick, k, FSW_BASE_MAP)
        w = rng.random(m) + 0.01
        x[i, :m, k] = w / w.sum()
    return x


def _vocab_weights(seed, n=B, v=V):
    rng = np.random.default_rng(seed)
    w = rng.random((n, v)).astype(np.float32)
    w[w < 0.3] = 0.0  # absent k-mers
    return w


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(tree[key])


def _port_grads(model) -> dict:
    """The gradients of ``model``'s parameters in the JAX layout."""
    g = lambda t: t.grad.detach().numpy()
    return {"lookup": g(model.lookup), "fsw": {"slices": g(model.slices), "freqs": g(model.freqs)},
            "fc1": {"w": g(model.fc1.weight).T, "b": g(model.fc1.bias)},
            "fc2": {"w": g(model.fc2.weight).T, "b": g(model.fc2.bias)}}


def _assert_grads_close(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(jax.device_get(ref)))
    assert got.keys() == ref.keys()
    for name in ref:
        scale = float(np.abs(ref[name]).max())
        assert scale > 0, name
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=name)


def _jax_value_and_grad(apply, params, x, cot):
    def loss(p):
        out = apply(p, x)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(out), grads


def _port_value_and_grad(fwd, model, cot):
    out = fwd(model)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), _port_grads(model)


@pytest.mark.parametrize("slice_chunk", [0, 8])
@pytest.mark.parametrize("route", ["pergenome", "shared", "shared_k9"])
def test_exact_forward_value_and_grads_match_jax(route, slice_chunk):
    """``shared_k9``: the shared route at k = 9, upstream's largest vocabulary
    (V = 131,072, the largest the shared route takes; on the card its sorts
    take ``sort_rows``' cluster path and its coefficient kernels the
    unstaged variant), at the same tolerances."""
    k = 9 if route == "shared_k9" else K
    params = _params(0, k)
    cot = np.random.default_rng(1).normal(size=(B, E)).astype(np.float32)
    if route == "pergenome":
        x = _point_sets(2)
        apply = lambda p, a: jfsw.fsw_dist_embed_apply(p, a, slice_chunk=slice_chunk)
    else:
        x = _vocab_weights(2, v=canonical_vocab_size(k))
        digits = jfsw._vocab_digits_dev(k)
        apply = lambda p, a: jfsw.fsw_dist_embed_apply_shared(p, a, digits,
                                                               slice_chunk=slice_chunk)
    ref, ref_grads = _jax_value_and_grad(apply, params, jnp.asarray(x), cot)
    got, grads = _port_value_and_grad(
        lambda m: m(torch.from_numpy(x), slice_chunk=slice_chunk), params_from_jax(params), cot)
    assert got.shape == (B, E)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    _assert_grads_close(grads, ref_grads)
    assert np.abs(grads["fsw"]["freqs"]).max() > 0  # the cos/sinc block trains the freqs


def test_shared_forward_equals_the_pergenome_forward_of_the_same_sets():
    """Zero-weight points are no-ops: (B, V) weights over the vocab embed as
    the (B, N, k+1) point sets they came from."""
    model = params_from_jax(_params(3))
    x = _point_sets(4)
    w = point_sets_to_vocab_weights([x[i] for i in range(B)], K)
    with torch.no_grad():
        a = model(torch.from_numpy(x))
        b = model(torch.from_numpy(w))
        c = model.forward_shared(torch.from_numpy(w), tfsw.vocab_digits(K, torch.device("cpu")))
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert torch.equal(b, c)


@pytest.mark.parametrize("ties", [False, True])
def test_sort_pw_backward_is_the_transposed_permutation(ties):
    """SortPW sorts as the stable plain version and sends d_ps back through
    the transpose of its permutation, ties included; the weights get no
    gradient."""
    rng = np.random.default_rng(5)
    r, n, p = 6, 37, 2
    keys = (rng.integers(0, 5, (r, n)) if ties else rng.normal(size=(r, n))).astype(np.float32)
    keys = torch.from_numpy(keys).requires_grad_()
    w = torch.from_numpy(rng.random((p, n)).astype(np.float32)).requires_grad_()
    ps, ws = tfsw.SortPW.apply(keys, w)
    ref_ps, ref_ws, perm = sort_rows_reference(keys.detach(), w.detach())
    assert torch.equal(ps, ref_ps) and torch.equal(ws, ref_ws)
    d = torch.from_numpy(rng.normal(size=(r, n)).astype(np.float32))
    (ps * d).sum().backward()
    onehot = torch.nn.functional.one_hot(perm.long(), n).float()  # [r, j, perm[r, j]] = 1
    want = torch.einsum("rj,rjc->rc", d, onehot)
    assert torch.equal(keys.grad, want)
    assert w.grad is None


def test_sort_shared_backward_unsorts_the_batch_summed_cotangent():
    rng = np.random.default_rng(6)
    c, n, b = 5, 29, 3
    keys = torch.from_numpy(rng.normal(size=(c, n)).astype(np.float32)).requires_grad_()
    wn = torch.from_numpy(rng.random((b, n)).astype(np.float32))
    ps, perm = tfsw.SortShared.apply(keys, wn)
    ref_ps, _, ref_perm = sort_rows_reference(keys.detach(), wn[:1])
    assert torch.equal(ps, ref_ps) and torch.equal(perm, ref_perm)
    assert not perm.requires_grad
    d = torch.from_numpy(rng.normal(size=(b, c, n)).astype(np.float32))
    (ps[None] * d).sum().backward()
    want = torch.empty_like(keys).scatter_(-1, perm.long(), d.sum(0))
    torch.testing.assert_close(keys.grad, want)


def _jax_lazy(route, params, x):
    params = jax.tree.map(jnp.asarray, params)
    if route == "shared":
        digits = jfsw._vocab_digits_dev(K)
        points = params["lookup"][digits].reshape(V, -1)
        return jfsw.fsw_lazy_refresh(params["fsw"], points, digits, jnp.asarray(x), group=2)
    return jfsw.fsw_lazy_refresh_pergenome(params["fsw"], params["lookup"], jnp.asarray(x),
                                           group=2)


def _port_lazy(route, model, x, group=2):
    x = torch.from_numpy(x)
    if route == "shared":
        digits = tfsw.vocab_digits(K, torch.device("cpu"))
        points = model.lookup.detach()[digits].reshape(V, -1)
        return tfsw.fsw_lazy_refresh(model.slices, model.freqs, points, digits, x, group)
    return tfsw.fsw_lazy_refresh_pergenome(model.slices, model.freqs, model.lookup, x, group)


def _lazy_inputs(route, n=5):
    if route == "shared":
        return _vocab_weights(7, n)
    return _point_sets(7, lengths=(40, 17, 48, 1, 33)[:n])


@pytest.mark.parametrize("route", ["pergenome", "shared"])
def test_lazy_refresh_matches_jax(route):
    """S (n, C, k, 4) and g2 (n, C) of both refreshes, over groups of 2 with
    a partial last group (n = 5)."""
    params = _params(8)
    x = _lazy_inputs(route)
    s_ref, g2_ref = (np.asarray(a) for a in _jax_lazy(route, params, x))
    s, g2 = _port_lazy(route, params_from_jax(params), x)
    assert s.shape == (5, D_OUT, K, 4) and g2.shape == (5, D_OUT)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-4, atol=1e-5 * np.abs(s_ref).max())
    np.testing.assert_allclose(g2.numpy(), g2_ref, rtol=1e-4, atol=1e-5 * np.abs(g2_ref).max())
    assert not s.requires_grad and not g2.requires_grad


@pytest.mark.parametrize("route", ["pergenome", "shared"])
def test_lazy_apply_at_a_fresh_permutation_equals_the_exact_forward(route):
    """The JAX contract of tests/test_fsw_lazy.py: value and every gradient,
    the frequencies' included, of fsw_lazy_apply on a fresh refresh equal
    those of the exact forward (same tolerances as the JAX package's test:
    atol 1e-4 on values, 2e-3 of the largest element on gradients)."""
    params = _params(9)
    x = _lazy_inputs(route, n=B)
    cot = np.random.default_rng(10).normal(size=(B, E)).astype(np.float32)
    exact, g_exact = _port_value_and_grad(lambda m: m(torch.from_numpy(x)),
                                          params_from_jax(params), cot)
    model = params_from_jax(params)
    s, g2 = _port_lazy(route, model, x, group=8)
    lazy, g_lazy = _port_value_and_grad(lambda m: tfsw.fsw_lazy_apply(m, s, g2), model, cot)
    np.testing.assert_allclose(lazy, exact, atol=1e-4)
    for (name, a), (_, b) in zip(_leaves(g_lazy), _leaves(g_exact)):
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 * scale, err_msg=name)
    assert np.abs(g_lazy["fsw"]["freqs"]).max() > 0


@pytest.mark.parametrize("hbm_gib", [0.001, 0.05, 1, 16, 80])
@pytest.mark.parametrize("d_out,vocab", [(512, 8192), (512, 131_072), (16, 136), (512, 640)])
def test_lazy_gate_equals_jax(monkeypatch, hbm_gib, d_out, vocab):
    """The shared route's gate counts the port's own refresh
    (``shared_refresh_bytes``), about three times the JAX package's (3G + 4)
    buffers of (C, V): its group is never larger, and where the port takes
    the lazy route the JAX package does too."""
    monkeypatch.setenv("KF2VEC_HBM_BYTES", str(int(hbm_gib * (1 << 30))))
    group = tlazy.pick_refresh_group(d_out, vocab, "cpu", items=64)
    assert group <= jlazy.pick_refresh_group(d_out, vocab)
    if tlazy.lazy_applicable(d_out, vocab, "cpu", items=64):
        assert jlazy.lazy_applicable(64, d_out, vocab)
    assert tlazy.refresh_transient_bytes(d_out, vocab, 3, items=64) > jlazy.refresh_transient_bytes(
        d_out, vocab, 3)
    assert tlazy.REFRESH_GROUP == jlazy.REFRESH_GROUP


@pytest.mark.parametrize("k,n_points,batch", [
    (7, 8192, 16), (7, 2731, 16), (7, 2730, 16), (9, 131_072, 16), (10, 4 << 20, 16),
    (7, 8192, 64), (7, 8192, 65), (3, 128, 4), (5, 128, 16), (0, 128, 16)])
def test_shared_vocab_gate_equals_jax(k, n_points, batch):
    assert tfsw.shared_vocab_applicable(k, n_points, batch) == jfsw.shared_vocab_applicable(
        k, n_points, batch)


def test_point_sets_to_vocab_weights_equals_jax():
    x = _point_sets(11, lengths=(40, 17, 1, 136), n=136)
    mats = [x[i, : int((x[i, :, K] > 0).sum())] for i in range(4)]
    mats[1] = np.concatenate([mats[1], mats[1][:3]])  # duplicate rows: their mass sums
    got = point_sets_to_vocab_weights(mats, K)
    np.testing.assert_array_equal(got, jax_vocab_weights(mats, K))
    assert got.shape == (4, V) and got.dtype == np.float32
    assert (got[1] > 0).sum() == 17


@pytest.mark.parametrize("bad", ["digit_4", "digit_negative", "non_canonical"])
def test_point_sets_to_vocab_weights_refuses_what_jax_refuses(bad):
    m = _point_sets(12, lengths=(5,), n=5)[0]
    if bad == "digit_4":
        m[0, 0] = 4
    elif bad == "digit_negative":
        m[0, 0] = -1
    else:
        codes = set(canonical_vocab_codes(K).tolist())
        code = next(c for c in range(4**K) if c not in codes)
        m[0, :K] = codes_to_digit_matrix(np.array([code]), K, FSW_BASE_MAP)[0]
    for fn in (point_sets_to_vocab_weights, jax_vocab_weights):
        with pytest.raises(ValueError):
            fn([m], K)


def test_fsw_adam_state_carries_every_moment_both_ways():
    """The Adam moments of lookup, fsw/slices and fsw/freqs cross between
    the packages as the Linear layers' do; one step from a carried state
    equals the JAX package's adam_update."""
    from kf2vecfsw_tpu.train.step import adam_update

    rng = np.random.default_rng(13)
    params = _params(13)
    state = {"count": np.int32(3),
             "mu": jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params),
             "nu": jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), params)}
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    model = params_from_jax(params)
    opt = make_adam(model, 1e-3)
    adam_state_from_jax(opt, model, state)
    back = adam_state_to_jax(opt, model)
    assert int(back["count"]) == 3
    for m in ("mu", "nu"):
        got, ref = dict(_leaves(back[m])), dict(_leaves(state[m]))
        assert sorted(got) == sorted(ref) == ["fc1/b", "fc1/w", "fc2/b", "fc2/w", "fsw/freqs",
                                              "fsw/slices", "lookup"]
        for name in ref:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    g = params_from_jax(grads)
    for p, gp in zip(model.parameters(), g.parameters()):
        p.grad = gp.detach().clone()
    opt.step()
    p_ref, s_ref = adam_update(params, grads, state, 1e-3)
    from kf2vecfsw_tpu_torch.models.mlp import params_to_jax

    got = dict(_leaves(params_to_jax(model)))
    for name, ref in _leaves(jax.device_get(p_ref)):
        np.testing.assert_allclose(got[name], ref, rtol=1e-6, atol=1e-7, err_msg=name)
    after = adam_state_to_jax(opt, model)
    assert int(after["count"]) == int(s_ref["count"]) == 4
    for (name, a), (_, b) in zip(_leaves(after["mu"]), _leaves(jax.device_get(s_ref["mu"]))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)
