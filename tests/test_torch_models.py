"""The port's dense models and exact cdist against the JAX package on the same
numpy parameters and inputs.

Tolerances: fp32 sums taken in another order (XLA:CPU vs PyTorch's CPU
GEMM and reduction) differ in the last bits, so forward passes compare at
rtol 1e-5 / atol 1e-6 (about 100 ulp at the output scale) and distances at
rtol 1e-5 / atol 1e-5. Identical rows must give exactly 0."""

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.models.mlp import classifier_apply, dist_embed_apply
from kf2vecfsw_tpu.ops.pairwise import cdist_exact_blocked as jax_cdist
from kf2vecfsw_tpu.ops.pairwise import squared_clamped as jax_squared_clamped
from kf2vecfsw_tpu_torch.models.mlp import (
    Classifier,
    DistEmbed,
    init_params_,
    params_from_jax,
    params_to_jax,
)
from kf2vecfsw_tpu_torch.ops.pairwise import cdist_exact_blocked, squared_clamped

torch.set_num_threads(1)

V, H, E, C = 512, 32, 16, 5


def _linear(rng, n_in, n_out):
    bound = 1.0 / np.sqrt(n_in)
    return {
        "w": rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
        "b": rng.uniform(-bound, bound, (n_out,)).astype(np.float32),
    }


def _features(rng, n):
    # .kf-like inputs: frequencies scaled by FEATURES_SCALER
    x = rng.random((n, V)).astype(np.float32)
    return (x / x.sum(axis=1, keepdims=True) * np.float32(1e4)).astype(np.float32)


def test_dist_embed_forward_matches_jax():
    rng = np.random.default_rng(0)
    params = {"fc1": _linear(rng, V, H), "fc2": _linear(rng, H, E)}
    x = _features(rng, 9)
    module = params_from_jax(params)
    assert isinstance(module, DistEmbed)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    ref = np.asarray(dist_embed_apply(params, x))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_classifier_forward_matches_jax():
    rng = np.random.default_rng(1)
    params = {"fc1": _linear(rng, V, H), "fc3": _linear(rng, H, C)}
    x = _features(rng, 7)
    module = params_from_jax(params)
    assert isinstance(module, Classifier)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    ref = np.asarray(classifier_apply(params, x))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("out_name,out_dim", [("fc2", E), ("fc3", C)])
def test_params_round_trip_exactly(out_name, out_dim):
    rng = np.random.default_rng(2)
    params = {"fc1": _linear(rng, V, H), out_name: _linear(rng, H, out_dim)}
    back = params_to_jax(params_from_jax(params))
    assert sorted(back) == sorted(params)
    for layer in params:
        assert sorted(back[layer]) == ["b", "w"]
        for leaf in ("w", "b"):
            assert back[layer][leaf].dtype == params[layer][leaf].dtype
            np.testing.assert_array_equal(back[layer][leaf], params[layer][leaf])


def test_params_from_jax_rejects_unknown_layout():
    with pytest.raises(ValueError, match="not a dense"):
        params_from_jax({"fc1": {"w": np.zeros((2, 2)), "b": np.zeros(2)}})


def test_init_params_uses_linear_bounds_and_generator():
    a = init_params_(DistEmbed(V, H, E), torch.Generator().manual_seed(3))
    b = init_params_(DistEmbed(V, H, E), torch.Generator().manual_seed(3))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert a.fc1.weight.abs().max() <= 1 / np.sqrt(V)
    assert a.fc2.bias.abs().max() <= 1 / np.sqrt(H)


@pytest.mark.parametrize("n,block", [(5, 128), (130, 64), (64, 64), (1, 1)])
def test_cdist_and_clamp_match_jax(n, block):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, E)).astype(np.float32)
    y = rng.normal(size=(23, E)).astype(np.float32)
    y[3] = x[0]  # an identical pair: exactly 0 after square + clamp
    got = squared_clamped(cdist_exact_blocked(torch.from_numpy(x), torch.from_numpy(y), block))
    ref = np.asarray(jax_squared_clamped(jax_cdist(x, y, block)))
    assert got.shape == (n, 23)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert got[0, 3].item() == 0.0


def test_cdist_identical_rows_give_exact_zero():
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(200, E)).astype(np.float32) * 1e3)
    d = cdist_exact_blocked(x, x, block=64)
    assert torch.all(torch.diagonal(d) == 0)
    sq = squared_clamped(torch.tensor([0.0, 9e-4, 1e-3, 2.0]))
    assert sq.tolist() == [0.0, 0.0, pytest.approx(1e-6), 4.0]
