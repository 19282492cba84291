"""The port's FSW distance model against the JAX package's on the same numpy
parameters and point sets (k=5, base_dim 3, d_out 24, H 16, E 8, B 3).

Tolerance rtol 1e-4 / atol 1e-5: the projections, the weight sums, the
prefix sums (a blocked triangular matmul in the JAX package, torch.cumsum
here) and the row sums run in another order, and cos(pi xi cbar) with xi up
to 23 multiplies the prefix sums' rounding by up to ~72."""

import jax
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.models.fsw import _auto_slice_chunk as jax_auto_slice_chunk
from kf2vecfsw_tpu.models.fsw import fsw_dist_embed_apply, init_fsw_dist_embed
from kf2vecfsw_tpu_torch.models.fsw import (
    FSWDistEmbed,
    auto_slice_chunk,
    fsw_embed,
    init_fsw_dist_embed_,
)
from kf2vecfsw_tpu_torch.models.mlp import params_from_jax, params_to_jax

torch.set_num_threads(1)

K, BASE_DIM, D_OUT, H, E, B = 5, 3, 24, 16, 8, 3


def _params(rng):
    def linear(n_in, n_out):
        bound = 1.0 / np.sqrt(n_in)
        return {"w": rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                "b": rng.uniform(-bound, bound, (n_out,)).astype(np.float32)}

    return {
        "lookup": rng.normal(size=(4, BASE_DIM)).astype(np.float32),
        "fsw": {"slices": rng.normal(size=(D_OUT, K * BASE_DIM)).astype(np.float32),
                "freqs": np.arange(D_OUT, dtype=np.float32)},
        "fc1": linear(D_OUT, H),
        "fc2": linear(H, E),
    }


def _point_sets(rng, lengths=(40, 17, 1), n=48):
    """(B, n, k+1) get_kmers-like rows, zero-padded past each set's length."""
    x = np.zeros((len(lengths), n, K + 1), np.float32)
    for i, m in enumerate(lengths):
        x[i, :m, :K] = rng.integers(0, 4, (m, K))
        w = rng.random(m) + 0.01
        x[i, :m, K] = w / w.sum()
    return x


def _port(params, x, **kw):
    with torch.no_grad():
        return params_from_jax(params)(torch.from_numpy(x), **kw).numpy()


@pytest.mark.parametrize("slice_chunk", [None, 8])
def test_fsw_forward_matches_jax(slice_chunk):
    rng = np.random.default_rng(0)
    params, x = _params(rng), _point_sets(rng)
    ref = np.asarray(fsw_dist_embed_apply(params, x, slice_chunk=0))
    got = _port(params, x, slice_chunk=slice_chunk)
    assert got.shape == (B, E)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_fsw_forward_matches_jax_on_jax_initialised_params():
    params = jax.device_get(init_fsw_dist_embed(jax.random.PRNGKey(5), K, BASE_DIM, D_OUT, H, E))
    x = _point_sets(np.random.default_rng(1))
    ref = np.asarray(fsw_dist_embed_apply(params, x))
    np.testing.assert_allclose(_port(params, x), ref, rtol=1e-4, atol=1e-5)


def _embed(module, points, weights):
    with torch.no_grad():
        return fsw_embed(module.slices, module.freqs, torch.from_numpy(points),
                         torch.from_numpy(weights))


@pytest.mark.parametrize("invariant", ["permutation", "zero_weight_padding", "weight_scale"])
def test_fsw_invariants(invariant):
    rng = np.random.default_rng(2)
    module = params_from_jax(_params(rng))
    points = rng.normal(size=(2, 20, K * BASE_DIM)).astype(np.float32)
    weights = (rng.random((2, 20)) + 0.01).astype(np.float32)
    e1 = _embed(module, points, weights)
    if invariant == "permutation":
        perm = rng.permutation(20)
        e2 = _embed(module, points[:, perm], weights[:, perm])
    elif invariant == "zero_weight_padding":
        pad = rng.normal(size=(2, 7, K * BASE_DIM)).astype(np.float32)
        e2 = _embed(module, np.concatenate([points, pad], 1),
                    np.concatenate([weights, np.zeros((2, 7), np.float32)], 1))
    else:
        e2 = _embed(module, points, weights * np.float32(7.5))
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), atol=1e-5)


def test_fsw_params_round_trip_exactly():
    params = _params(np.random.default_rng(3))
    module = params_from_jax(params)
    assert isinstance(module, FSWDistEmbed)
    back = params_to_jax(module)
    assert sorted(back) == sorted(params) and sorted(back["fsw"]) == ["freqs", "slices"]
    flat = lambda p: {f"{a}/{b}": v for a, d in p.items()
                      for b, v in (d.items() if isinstance(d, dict) else [("", d)])}
    for key, ref in flat(params).items():
        got = flat(back)[key]
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_init_draws_orthonormal_blocks_and_even_freqs_from_the_generator():
    a = init_fsw_dist_embed_(FSWDistEmbed(K, BASE_DIM, D_OUT, H, E), torch.Generator().manual_seed(4))
    b = init_fsw_dist_embed_(FSWDistEmbed(K, BASE_DIM, D_OUT, H, E), torch.Generator().manual_seed(4))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    d_in = K * BASE_DIM
    s = a.slices.detach()
    for start in range(0, D_OUT, d_in):
        blk = s[start : start + d_in]
        torch.testing.assert_close(blk @ blk.T, torch.eye(blk.shape[0]), atol=1e-5, rtol=0)
    assert torch.equal(a.freqs.detach(), torch.arange(D_OUT, dtype=torch.float32))
    assert a.fc1.weight.abs().max() <= 1 / np.sqrt(D_OUT)


@pytest.mark.parametrize("hbm_gib", [1, 16, 80])
@pytest.mark.parametrize("n", [8192, 131_072])
def test_auto_slice_chunk_equals_jax(monkeypatch, hbm_gib, n):
    monkeypatch.setenv("KF2VEC_HBM_BYTES", str(hbm_gib << 30))
    assert auto_slice_chunk(16, n, 512, "cpu") == jax_auto_slice_chunk(16, n, 512)
