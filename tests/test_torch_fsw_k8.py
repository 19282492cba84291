"""FSW at k = 8 on the CPU, the port against the JAX package: get_kmers'
`.npy` point sets byte for byte on genomes of 20-40 kb, and the FSW forward
on the same numpy parameters at narrow widths (16 slices, base_dim 2, H 16,
E 8) on both routes: shared-vocab over all V = 32,896 canonical 8-mers, and
per-genome on point sets of 20,000 and 17,000 k-mers. Such rows are longer
than one thread block's tile (16,384), so on the card they take
``sort_rows``' cluster path; here both packages sort with their plain
versions.

Tolerance rtol 1e-4 / atol 1e-5, as in ``tests/test_torch_fsw.py``: the
projections, weight sums and prefix sums run in another order, and cos(pi xi
cbar) with xi up to 15 multiplies the prefix sums' rounding."""

import os

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.ingest.kmers import get_kmers as jax_get_kmers
from kf2vecfsw_tpu.models import fsw as jfsw
from kf2vecfsw_tpu_torch.ingest.kmers import get_kmers, point_sets_to_vocab_weights
from kf2vecfsw_tpu_torch.kmer.vocab import (
    FSW_BASE_MAP,
    canonical_vocab_codes,
    canonical_vocab_size,
    codes_to_digit_matrix,
)
from kf2vecfsw_tpu_torch.models.mlp import params_from_jax

torch.set_num_threads(1)

K, BASE_DIM, D_OUT, H, E = 8, 2, 16, 16, 8
V = canonical_vocab_size(K)
TILE = 16_384  # the rows a thread block sorts alone on the card


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


def _point_sets(rng, lengths=(20_000, 17_000)):
    """(B, max length, k+1) point sets of distinct canonical 8-mers with
    positive weights summing to 1, zero-padded past each set's length."""
    codes = canonical_vocab_codes(K)
    x = np.zeros((len(lengths), max(lengths), K + 1), np.float32)
    for i, m in enumerate(lengths):
        x[i, :m, :K] = codes_to_digit_matrix(rng.choice(codes, m, replace=False), K, FSW_BASE_MAP)
        w = rng.random(m) + 0.01
        x[i, :m, K] = w / w.sum()
    return x


def test_point_sets_are_long_rows():
    x = _point_sets(np.random.default_rng(0))
    assert V == 32_896 and (x[:, :, K] > 0).sum(axis=1).tolist() == [20_000, 17_000]
    assert min(20_000, 17_000) > TILE


def test_get_kmers_k8_npy_bytes_equal_jax(tmp_path):
    src = tmp_path / "genomes"
    src.mkdir()
    rng = np.random.default_rng(8)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    for i in range(6):
        n = int(rng.integers(20_000, 40_001))
        seq = letters[rng.choice(5, size=n, p=(0.2475, 0.2475, 0.2475, 0.2475, 0.01))]
        (src / f"g{i}.fna").write_bytes(b">g%d\n%s\n" % (i, seq.tobytes()))
    ref, port = tmp_path / "jax", tmp_path / "port"
    jax_get_kmers(str(src), str(ref), k=K)
    get_kmers(str(src), str(port), k=K, threads=2, device="cpu")
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == [f"g{i}_k8.npy" for i in range(6)]
    for f in os.listdir(ref):
        assert (port / f).read_bytes() == (ref / f).read_bytes(), f
    sizes = [np.load(port / f).shape[0] for f in os.listdir(port)]
    assert 10_000 < min(sizes) and max(sizes) < V  # 20-40 kb hold a third to two thirds of V


def test_fsw_forward_k8_shared_vocab_matches_jax():
    rng = np.random.default_rng(1)
    params, x = _params(rng), _point_sets(rng)
    w = point_sets_to_vocab_weights([x[0, :20_000], x[1, :17_000]], K)
    assert w.shape == (2, V)
    ref = np.asarray(jfsw.fsw_dist_embed_apply_shared(params, w, jfsw._vocab_digits_dev(K),
                                                       slice_chunk=0))
    with torch.no_grad():
        got = params_from_jax(params)(torch.from_numpy(w), slice_chunk=0).numpy()
    assert got.shape == (2, E)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("slice_chunk", [0, 8])
def test_fsw_forward_k8_pergenome_matches_jax(slice_chunk):
    rng = np.random.default_rng(2)
    params, x = _params(rng), _point_sets(rng)
    ref = np.asarray(jfsw.fsw_dist_embed_apply(params, x, slice_chunk=slice_chunk))
    with torch.no_grad():
        model = params_from_jax(params)
        got = model(torch.from_numpy(x), slice_chunk=slice_chunk).numpy()
        shared = model(torch.from_numpy(point_sets_to_vocab_weights(
            [x[0, :20_000], x[1, :17_000]], K)), slice_chunk=slice_chunk).numpy()
    assert got.shape == (2, E)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(shared, got, rtol=1e-4, atol=1e-5)  # one function, two routes
