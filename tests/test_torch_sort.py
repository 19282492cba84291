"""The port's row sort on the CPU (its plain version) against the JAX
package's Pallas bitonic sort (B3) in interpret mode and against numpy.

Sorted keys must be bit-for-bit equal. The port's sort is stable, so its
permutation equals numpy's stable argsort on every row, ties included. B3
is unstable, so a permutation is compared with B3's only on rows without
tied keys; on every row it must be a permutation that maps the keys and the
payload to the sorted outputs exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.kernels.sort import sort_rows as jax_sort_rows
from kf2vecfsw_tpu.models.fsw import _f2i_keys as jax_f2i_keys
from kf2vecfsw_tpu_torch.kernels import sort as sort_mod
from kf2vecfsw_tpu_torch.kernels.sort import (
    f2i_keys,
    i2f_keys,
    sort_rows,
    sort_rows_reference,
)

torch.set_num_threads(1)


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _tie_free(row):
    return np.unique(_bits(row)).size == row.size


def _port(keys, payload):
    sk, sp, perm = sort_rows(torch.from_numpy(keys), torch.from_numpy(payload))
    return sk.numpy(), sp.numpy(), perm.numpy()


def _check_consistent(keys, payload, sk, sp, perm):
    r, n = keys.shape
    group = r // payload.shape[0]
    assert perm.dtype == np.int32 and sk.shape == sp.shape == perm.shape == (r, n)
    for i in range(r):
        np.testing.assert_array_equal(np.sort(perm[i]), np.arange(n))
        np.testing.assert_array_equal(_bits(keys[i][perm[i]]), _bits(sk[i]))
        np.testing.assert_array_equal(_bits(payload[i // group][perm[i]]), _bits(sp[i]))


@pytest.mark.parametrize("r,n", [(8, 128), (4, 1024)])
def test_plain_sort_equals_pallas_b3(r, n):
    rng = np.random.default_rng(n)
    keys = rng.normal(size=(r, n)).astype(np.float32)
    idx = np.broadcast_to(np.arange(n, dtype=np.int32), (r, n)).copy()
    ks, ix = jax_sort_rows((jnp.asarray(keys), jnp.asarray(idx)), block_rows=min(r, 32),
                           interpret=True)
    sk, sp, perm = _port(keys, keys.copy())
    np.testing.assert_array_equal(_bits(sk), _bits(np.asarray(ks)))
    _check_consistent(keys, keys, sk, sp, perm)
    for i in range(r):
        if _tie_free(keys[i]):
            np.testing.assert_array_equal(perm[i], np.asarray(ix)[i])


def test_plain_sort_equals_pallas_b3_three_operands():
    rng = np.random.default_rng(1)
    r, n = 8, 512
    keys = rng.normal(size=(r, n)).astype(np.float32)
    w = rng.random((r, n)).astype(np.float32)
    idx = np.broadcast_to(np.arange(n, dtype=np.int32), (r, n)).copy()
    ks, ws, ix = jax_sort_rows((jnp.asarray(keys), jnp.asarray(w), jnp.asarray(idx)),
                               block_rows=8, interpret=True)
    sk, sp, perm = _port(keys, w)
    np.testing.assert_array_equal(_bits(sk), _bits(np.asarray(ks)))
    np.testing.assert_array_equal(_bits(sp), _bits(np.asarray(ws)))
    np.testing.assert_array_equal(perm, np.asarray(ix))


def _keys(kind, rng, r, n):
    if kind == "normal":
        return rng.normal(size=(r, n)).astype(np.float32)
    if kind == "ties_and_signed_zeros":  # many exact ties, -0.0 and +0.0
        keys = np.round(rng.normal(size=(r, n)), 1).astype(np.float32)
        keys[rng.random((r, n)) < 0.1] = -0.0
        return keys
    if kind == "sorted":
        return np.sort(rng.normal(size=(r, n)).astype(np.float32), axis=1)
    return np.sort(rng.normal(size=(r, n)).astype(np.float32), axis=1)[:, ::-1].copy()


@pytest.mark.parametrize("kind", ["normal", "ties_and_signed_zeros", "sorted", "reversed"])
@pytest.mark.parametrize("n", [1, 7, 100, 2080])
@pytest.mark.parametrize("p", [8, 2, 1])
def test_plain_sort_equals_numpy_at_any_length_and_shared_payload(kind, n, p):
    rng = np.random.default_rng(n * 10 + p)
    r = 8
    keys = _keys(kind, rng, r, n)
    payload = rng.random((p, n)).astype(np.float32)
    sk, sp, perm = _port(keys, payload)
    # numpy on the same integer order: sort the f2i integers, map back
    ref = i2f_keys(torch.from_numpy(np.sort(f2i_keys(torch.from_numpy(keys)).numpy(), axis=1)))
    np.testing.assert_array_equal(_bits(sk), _bits(ref.numpy()))
    _check_consistent(keys, payload, sk, sp, perm)
    if kind == "ties_and_signed_zeros" and n > 7:
        assert (_bits(sk) == _bits(np.float32(-0.0))).any()
        # -0.0 sorts before +0.0 (the integer order of f2i_keys)
        for row in sk:
            neg = np.flatnonzero(_bits(row) == _bits(np.float32(-0.0)))
            pos = np.flatnonzero(_bits(row) == 0)
            if neg.size and pos.size:
                assert neg.max() < pos.min()
    ints = f2i_keys(torch.from_numpy(keys)).numpy()
    for i in range(r):
        np.testing.assert_array_equal(perm[i], np.argsort(ints[i], kind="stable"))


def test_f2i_keys_equals_jax_and_inverts():
    rng = np.random.default_rng(3)
    x = rng.normal(size=1000).astype(np.float32) * np.float32(1e30)
    x[:6] = [0.0, -0.0, np.inf, -np.inf, np.finfo(np.float32).max, np.finfo(np.float32).tiny]
    got = f2i_keys(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_f2i_keys(jnp.asarray(x))))
    np.testing.assert_array_equal(_bits(i2f_keys(got).numpy()), _bits(x))
    assert int(got[1]) < int(got[0])  # -0.0 < +0.0


def test_wrapper_on_cpu_tensors_never_touches_the_kernel(monkeypatch):
    def no_kernel():
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(sort_mod, "_lib", no_kernel)
    before = sort_rows.launches
    rng = np.random.default_rng(4)
    keys = torch.from_numpy(rng.normal(size=(6, 33)).astype(np.float32))
    payload = torch.from_numpy(rng.random((3, 33)).astype(np.float32))
    for a, b in zip(sort_rows(keys, payload), sort_rows_reference(keys, payload)):
        assert torch.equal(a, b)
    assert sort_rows.launches == before


@pytest.mark.parametrize("n", [16_385, 32_896, 131_073])
def test_long_rows_on_cpu_take_the_plain_version_and_count_no_launch(monkeypatch, n):
    """Rows past one block's tile (the kernel's cluster and radix paths on
    the card) are the plain version on CPU tensors, stable like every row."""
    def no_kernel():
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(sort_mod, "_lib", no_kernel)
    before = (sort_rows.launches, sort_rows.long_launches, sort_rows.radix_launches)
    rng = np.random.default_rng(n)
    keys = np.round(rng.normal(size=(2, n)) * 8).astype(np.float32) + np.float32(0)  # ties, no -0.0
    payload = rng.random((1, n)).astype(np.float32)
    sk, sp, perm = _port(keys, payload)
    _check_consistent(keys, payload, sk, sp, perm)
    for i in range(2):
        np.testing.assert_array_equal(perm[i], np.argsort(keys[i], kind="stable"))
    assert (sort_rows.launches, sort_rows.long_launches, sort_rows.radix_launches) == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    keys = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="float32"):
        sort_rows(keys.double(), keys)
    with pytest.raises(ValueError, match="contiguous"):
        sort_rows(torch.zeros((8, 4)).T, keys)
    with pytest.raises(ValueError, match="% P == 0"):
        sort_rows(keys, torch.zeros((3, 8)))
    with pytest.raises(ValueError, match="% P == 0"):
        sort_rows(keys, torch.zeros((4, 7)))
    with pytest.raises(ValueError, match="R >= 1"):
        sort_rows(torch.zeros((0, 8)), torch.zeros((1, 8)))
