"""The port's model zoo (``models/zoo.py``) and the other functions the JAX
package defines and never calls, against the JAX package on the CPU.

Every forward runs on weights the JAX package initialised and
``zoo_params_from_jax`` carried over, on inputs from a numpy seed, at the
shapes of tests/test_zoo.py: rtol 1e-5 / atol 1e-6 for the MLPs, the
classifiers and the CNN, rtol 1e-4 / atol 1e-5 for the transformer and the
BiRNN (softmax, LayerNorm and the LSTM's recurrence reorder more sums).
Gradients of a scalar loss are held to ``jax.grad`` at the same tolerances,
BatchNorm's running state after a training step to ``mlp_bn_apply``'s, and
dropout statistically (its masks come from another generator)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.io.fasta import remove_gaps as jax_remove_gaps
from kf2vecfsw_tpu.kmer.vocab import codes_to_strings as jax_codes_to_strings
from kf2vecfsw_tpu.models import zoo as jz
from kf2vecfsw_tpu.ops import losses as jlosses
from kf2vecfsw_tpu.train.chunks import ChunkStore as JaxChunkStore
from kf2vecfsw_tpu_torch.io.fasta import remove_gaps
from kf2vecfsw_tpu_torch.io.kf import write_kf
from kf2vecfsw_tpu_torch.kmer.vocab import codes_to_strings
from kf2vecfsw_tpu_torch.models import zoo
from kf2vecfsw_tpu_torch.ops import losses
from kf2vecfsw_tpu_torch.train.chunks import ChunkStore

torch.set_num_threads(1)

TIGHT = {"rtol": 1e-5, "atol": 1e-6}
LOOSE = {"rtol": 1e-4, "atol": 1e-5}


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(b.detach() if isinstance(b, torch.Tensor) else b),
                               np.asarray(a), **tol)


def _leaves(tree, prefix=""):
    """{path: array} of a JAX-layout tree (dicts and lists)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for key, value in items:
        out.update(_leaves(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _grads_to_jax(module):
    """The module's gradients in the JAX layout (each parameter's .grad in
    its place)."""
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(p.grad)
    return zoo.zoo_params_to_jax(module)


# (kind, JAX init, JAX apply returning a tuple, input, torch call, tolerance)
CASES = {
    "mlp_2": ("mlp", lambda k: jz.init_mlp(k, [16, 8, 4]), jz.mlp_apply, (4, 16), TIGHT),
    "mlp_3": ("mlp", lambda k: jz.init_mlp(k, [16, 12, 8, 4]), jz.mlp_apply, (4, 16), TIGHT),
    "mlp_4": ("mlp", lambda k: jz.init_mlp(k, [16, 12, 10, 8, 4]), jz.mlp_apply, (4, 16), TIGHT),
    "classifier_embed": ("classifier_embed", lambda k: jz.init_classifier_embed(k, 16, 8, 6, 3),
                         jz.classifier_embed_apply, (5, 16), TIGHT),
    "classifier_forked": ("classifier_forked", lambda k: jz.init_classifier_forked(k, 16, 8, 6, 3),
                          jz.classifier_forked_apply, (5, 16), TIGHT),
    "cnn": ("cnn", lambda k: jz.init_cnn(k, 16, 8, 4), jz.cnn_apply, (3, 16), TIGHT),
    "cnn_double": ("cnn", lambda k: jz.init_cnn(k, 16, 8, 4, double=True), jz.cnn_apply, (3, 16),
                   TIGHT),
    "classifier_trans": ("classifier_trans",
                         lambda k: jz.init_classifier_trans(k, 16, 8, 32, 3, n_heads=4, ffn_size=16),
                         lambda p, x: jz.classifier_trans_apply(p, x, n_heads=4), (7, 16), LOOSE),
    "birnn": ("birnn", lambda k: jz.init_birnn(k, 6, 5, 2, 4), jz.birnn_apply, (3, 9, 6), LOOSE),
}


def _case(name, seed=0):
    kind, init, apply, shape, tol = CASES[name]
    params = init(jax.random.PRNGKey(seed))
    module = zoo.zoo_params_from_jax(kind, params, n_heads=4)
    return params, apply, module, _x(seed + 1, *shape), tol


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_equals_jax(name):
    params, apply, module, x, tol = _case(name)
    want = apply(params, jnp.asarray(x))
    got = module(torch.from_numpy(x))
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, tol)
    # carried back, every leaf is the JAX package's own
    back, orig = _leaves(zoo.zoo_params_to_jax(module)), _leaves(params)
    assert sorted(back) == sorted(orig)
    for path in orig:
        np.testing.assert_array_equal(back[path], orig[path], err_msg=path)


@pytest.mark.parametrize("name", ["mlp_3", "classifier_trans", "birnn"])
def test_gradients_equal_jax(name):
    params, apply, module, x, tol = _case(name, seed=3)

    def jloss(p):
        out = apply(p, jnp.asarray(x))
        return sum(jnp.sum(o ** 2) for o in (out if isinstance(out, tuple) else (out,)))

    want = _leaves(jax.grad(jloss)(params))
    out = module(torch.from_numpy(x))
    sum(torch.sum(o ** 2) for o in (out if isinstance(out, tuple) else (out,))).backward()
    got = _leaves(_grads_to_jax(module))
    assert sorted(got) == sorted(want)
    for path in want:
        scale = max(float(np.abs(want[path]).max()), 1e-6)
        np.testing.assert_allclose(got[path], want[path], rtol=tol["rtol"],
                                   atol=tol["atol"] * scale, err_msg=path)


def test_mlp_bn_train_step_equals_jax():
    """Training mode: the output, the gradients and the running state after
    the step; eval mode on that state: the output."""
    params, state = jz.init_mlp_bn(jax.random.PRNGKey(2), [16, 12, 8, 4])
    x = _x(5, 6, 16)
    module = zoo.zoo_params_from_jax("mlp_bn", params, state)
    module.train()
    out = module(torch.from_numpy(x))
    want, new_state = jz.mlp_bn_apply(params, state, jnp.asarray(x), train=True)
    _close(want, out, TIGHT)
    torch.sum(out ** 2).backward()
    jgrad = _leaves(jax.grad(lambda p: jnp.sum(jz.mlp_bn_apply(p, state, jnp.asarray(x),
                                                                train=True)[0] ** 2))(params))
    got = _leaves(_grads_to_jax(module))
    # a bias before BatchNorm has a true gradient of 0 (the batch mean takes
    # it out): both sides are rounding there, so atol scales with the largest
    # gradient of the model
    scale = max(float(np.abs(g).max()) for g in jgrad.values())
    for path in jgrad:
        np.testing.assert_allclose(got[path], jgrad[path], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=path)
    got_state = zoo.zoo_state_to_jax(module)
    assert sorted(got_state) == sorted(new_state) == ["bn1", "bn2"]
    for name in new_state:
        for stat in ("mean", "var"):
            _close(new_state[name][stat], got_state[name][stat], TIGHT)
    assert not np.allclose(got_state["bn1"]["mean"], np.asarray(state["bn1"]["mean"]))
    # eval mode reads the carried state
    module = zoo.zoo_params_from_jax("mlp_bn", params, new_state).eval()
    want_eval, _ = jz.mlp_bn_apply(params, new_state, jnp.asarray(x), train=False)
    _close(want_eval, module(torch.from_numpy(x)), TIGHT)


def test_mlp_dropout_eval_and_rate_zero_are_the_mlp():
    params = jz.init_mlp_dropout(jax.random.PRNGKey(4), [16, 8, 4])
    x = torch.from_numpy(_x(6, 6, 16))
    plain = zoo.zoo_params_from_jax("mlp", params)(x)
    _close(jz.mlp_dropout_apply(params, jnp.asarray(x.numpy()), train=False), plain, TIGHT)
    gen = torch.Generator().manual_seed(0)
    drop = zoo.zoo_params_from_jax("mlp_dropout", params)
    assert torch.equal(drop.eval()(x, gen), plain)
    assert torch.equal(drop.train()(x), plain)  # no generator: no masks
    assert torch.equal(zoo.zoo_params_from_jax("mlp_dropout", params, rate=0.0).train()(x, gen),
                       plain)


def test_mlp_dropout_masks_statistically():
    """Every hidden unit 1 before the dropout and fc2 the identity: the
    output is the mask. Over 131,072 units the dropped share is within 5
    sigma of the rate, and the kept units are 1 / (1 - rate)."""
    rate, width, rows = 0.2, 512, 256
    module = zoo.MLPDropout([4, width, width], rate=rate)
    with torch.no_grad():
        module.fc1.weight.zero_()
        module.fc1.bias.fill_(1.0)
        module.fc2.weight.copy_(torch.eye(width))
        module.fc2.bias.zero_()
    out = module.train()(torch.zeros(rows, 4), torch.Generator().manual_seed(1))
    dropped = float((out == 0).float().mean())
    sigma = np.sqrt(rate * (1 - rate) / out.numel())
    assert abs(dropped - rate) <= 5 * sigma
    kept = out[out != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / (1 - rate)), rtol=1e-6, atol=0)


def _changed(before: dict, after: dict) -> set[str]:
    return {path for path in before if not np.array_equal(before[path], after[path])}


@pytest.mark.parametrize("kind,init", [
    ("mlp", lambda k: (jz.init_mlp(k, [8, 4, 2]), None)),
    ("mlp_bn", lambda k: jz.init_mlp_bn(k, [8, 6, 4, 2])),
    ("classifier_embed", lambda k: (jz.init_classifier_embed(k, 8, 6, 4, 3), None)),
    ("cnn", lambda k: (jz.init_cnn(k, 8, 6, 4, double=True), None)),
    ("classifier_trans", lambda k: (jz.init_classifier_trans(k, 8, 6, 8, 3, n_heads=4,
                                                             ffn_size=4), None)),
    ("birnn", lambda k: (jz.init_birnn(k, 8, 4, 2, 3), None))])
def test_weight_init_uniform_touches_what_jax_touches(kind, init):
    key = jax.random.PRNGKey(7)
    params, state = init(key)
    jax_changed = _changed(_leaves(params), _leaves(jz.weight_init_uniform(params, key)))
    module = zoo.zoo_params_from_jax(kind, params, state, n_heads=4)
    before = _leaves(zoo.zoo_params_to_jax(module))
    zoo.weight_init_uniform(module, torch.Generator().manual_seed(7))
    after = _leaves(zoo.zoo_params_to_jax(module))
    assert _changed(before, after) == jax_changed
    assert jax_changed and all(re.search(r"(^|/)(fc\d*|ffn\d+|qkv|out)/[wb]$", p)
                               for p in jax_changed)
    for path in jax_changed:
        if path.endswith("/b"):
            assert np.all(after[path] == 0), path
        else:
            assert after[path].min() >= 0.0 and after[path].max() <= 0.001, path


def test_modules_from_a_generator_have_the_jax_layout():
    """A module drawn from a torch generator has the JAX init's tree, shapes
    and bounds (U(+-1/sqrt(fan_in)), norms at ones and zeros)."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    pairs = [
        (zoo.MLP([16, 12, 8, 4], gen), jz.init_mlp(key, [16, 12, 8, 4])),
        (zoo.MLPBN([16, 8, 4], generator=gen), jz.init_mlp_bn(key, [16, 8, 4])[0]),
        (zoo.ClassifierForked(16, 8, 6, 3, gen), jz.init_classifier_forked(key, 16, 8, 6, 3)),
        (zoo.CNN(16, 8, 4, double=True, generator=gen), jz.init_cnn(key, 16, 8, 4, double=True)),
        (zoo.ClassifierTrans(16, 8, 32, 3, 4, 16, gen),
         jz.init_classifier_trans(key, 16, 8, 32, 3, n_heads=4, ffn_size=16)),
        (zoo.BiRNN(6, 5, 2, 4, gen), jz.init_birnn(key, 6, 5, 2, 4)),
    ]
    for module, params in pairs:
        got, want = _leaves(zoo.zoo_params_to_jax(module)), _leaves(params)
        assert {p: v.shape for p, v in got.items()} == {p: v.shape for p, v in want.items()}
        for path, value in got.items():
            if path.endswith(("scale", "bias")):
                assert np.array_equal(value, want[path]), path
                continue
            bound = float(np.abs(want[path]).max())
            assert np.abs(value).max() <= 1.0 / np.sqrt(_fan_in(path, want)) + 1e-7, path
            assert np.abs(value).max() > bound / 4, path  # drawn, not left at zero


def _fan_in(path: str, leaves: dict) -> int:
    w = leaves[path[: -1] + "w"]
    return w.shape[0]


def test_classifier_trans_raises_on_heads():
    with pytest.raises(ValueError, match="not divisible"):
        zoo.ClassifierTrans(16, 8, 30, 3, n_heads=4)
    with pytest.raises(ValueError):
        jz.classifier_trans_apply(jz.init_classifier_trans(jax.random.PRNGKey(0), 16, 8, 30, 3,
                                                           n_heads=4, ffn_size=8),
                                  jnp.zeros((2, 16)), n_heads=4)


def test_new_parameter():
    p = zoo.new_parameter((3, 4))
    assert isinstance(p, torch.nn.Parameter) and p.requires_grad
    assert p.dtype == torch.float32 and torch.equal(p.detach(), torch.ones(3, 4))
    np.testing.assert_array_equal(np.asarray(jz.new_parameter((3, 4))), p.detach().numpy())


def test_unused_losses_equal_jax():
    rng = np.random.default_rng(0)
    td = np.abs(rng.normal(size=(6, 6))).astype(np.float32)
    td[np.arange(6), np.arange(6)] = 0.0
    td[0, 1] = td[1, 0] = 0.0  # a within-genome pair off the diagonal
    md = np.abs(rng.normal(size=(6, 6))).astype(np.float32)
    ma = np.abs(rng.normal(size=(6, 6))).astype(np.float32)
    lam = rng.uniform(0.5, 1.5, size=6).astype(np.float32)
    for a_const in (0.0, 0.7):
        want = jlosses.contigs_weighted_sqrt_mse(jnp.asarray(md), jnp.asarray(td), jnp.asarray(ma),
                                                 a_const)
        got = losses.contigs_weighted_sqrt_mse(torch.from_numpy(md), torch.from_numpy(td),
                                               torch.from_numpy(ma), a_const)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want = jlosses.lambda_weighted_sqrt_mse(jnp.asarray(md), jnp.asarray(td), jnp.asarray(lam))
    got = losses.lambda_weighted_sqrt_mse(torch.from_numpy(md), torch.from_numpy(td),
                                          torch.from_numpy(lam))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_codes_to_strings_and_remove_gaps_equal_jax():
    rng = np.random.default_rng(1)
    for k in (1, 3, 7, 12):
        codes = rng.integers(0, 4 ** k, size=50)
        assert codes_to_strings(codes, k) == jax_codes_to_strings(codes, k)
    assert codes_to_strings(np.array([0, 7, 27]), 3) == ["AAA", "ACT", "CGT"]
    for seq in (b"", b"ACGT", b"AC-G.T N", b"--..  ", b"a-c.g t"):
        assert remove_gaps(seq) == jax_remove_gaps(seq)


def test_sample_one_uniform_equals_jax(tmp_path):
    """The legacy uniform spans, drawn from one numpy generator by both
    packages' host stores: the same vectors bit for bit."""
    rng = np.random.default_rng(2)
    paths = []
    for g, c in enumerate((1, 2, 7, 12)):
        rows = rng.integers(0, 30, size=(c, 32)).astype(np.float64)
        rows[0, :] = 0 if g == 2 else rows[0, :]  # an all-zero window
        path = str(tmp_path / f"g{g}.kf")
        write_kf(path, [(f"g{g}_{i}", row) for i, row in enumerate(rows)])
        paths.append(path)
    port, ref = ChunkStore(paths), JaxChunkStore(paths)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(6):
        for gi in range(len(paths)):
            got, want = port.sample_one_uniform(r1, gi), ref.sample_one_uniform(r2, gi)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
