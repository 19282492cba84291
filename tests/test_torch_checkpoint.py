"""A `.ckpt` written by either package loads in the other with equal params,
meta and model_name."""

import numpy as np
import pytest
import torch

from kf2vecfsw_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from kf2vecfsw_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from kf2vecfsw_tpu_torch.models.mlp import DistEmbed, params_from_jax, params_to_jax
from kf2vecfsw_tpu_torch.train.checkpoint import (
    fsw_k_from_meta,
    load_checkpoint,
    load_checkpoint_meta,
    save_checkpoint,
)

torch.set_num_threads(1)

META = {"model_input_size": 32, "model_hidden_size_fc1": 8, "model_embedding_size": 4,
        "best_epoch": 3, "best_loss": 0.25}


def _params(rng):
    return {
        "fc1": {"w": rng.normal(size=(32, 8)).astype(np.float32),
                "b": rng.normal(size=(8,)).astype(np.float32)},
        "fc2": {"w": rng.normal(size=(8, 4)).astype(np.float32),
                "b": rng.normal(size=(4,)).astype(np.float32)},
    }


def _assert_params_equal(a, b):
    assert sorted(a) == sorted(b)
    for layer in a:
        assert sorted(a[layer]) == sorted(b[layer])
        for leaf in a[layer]:
            np.testing.assert_array_equal(np.asarray(a[layer][leaf]), np.asarray(b[layer][leaf]))


@pytest.mark.parametrize("model_name", ["NeuralNet", "NeuralNetClassifierOnly"])
def test_jax_checkpoint_loads_in_port(tmp_path, model_name):
    params = _params(np.random.default_rng(0))
    path = str(tmp_path / "m.ckpt")
    jax_save_checkpoint(path, model_name, META, params)
    name, meta, got = load_checkpoint(path)
    assert name == model_name and meta == META
    _assert_params_equal(got, params)
    assert load_checkpoint_meta(path) == (model_name, META)


def test_port_checkpoint_loads_in_jax(tmp_path):
    module = DistEmbed(32, 8, 4)
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, "NeuralNet", META, params_to_jax(module))
    name, meta, got = jax_load_checkpoint(path)
    assert name == "NeuralNet" and meta == META
    _assert_params_equal(got, params_to_jax(module))
    # and back into a module with the same weights
    again = params_from_jax(got)
    for pa, pb in zip(module.parameters(), again.parameters()):
        assert torch.equal(pa, pb)


def test_jax_fsw_checkpoint_round_trips_through_port(tmp_path):
    """The nested fsw/slices and fsw/freqs keys of a JAX FSW checkpoint load
    in the port, build an FSWDistEmbed, and save back to what JAX reads."""
    from kf2vecfsw_tpu_torch.models.fsw import FSWDistEmbed

    rng = np.random.default_rng(3)
    params = {"lookup": rng.normal(size=(4, 2)).astype(np.float32),
              "fsw": {"slices": rng.normal(size=(6, 10)).astype(np.float32),
                      "freqs": np.arange(6, dtype=np.float32)}, **_params(rng)}
    params["fc1"]["w"] = params["fc1"]["w"][:6]
    meta = {"model_input_size": 6, "fsw_k": 5, "fsw_base_dim": 2, "fsw_out_dim": 6}
    path, back = str(tmp_path / "fsw.ckpt"), str(tmp_path / "back.ckpt")
    jax_save_checkpoint(path, "NeuralNetFSW", meta, params)
    name, got_meta, got = load_checkpoint(path)
    assert name == "NeuralNetFSW" and got_meta == meta and fsw_k_from_meta(got_meta) == 5
    assert sorted(got) == ["fc1", "fc2", "fsw", "lookup"] and sorted(got["fsw"]) == ["freqs", "slices"]
    module = params_from_jax(got)
    assert isinstance(module, FSWDistEmbed)
    save_checkpoint(back, name, got_meta, params_to_jax(module))
    name2, meta2, again = jax_load_checkpoint(back)
    assert (name2, meta2) == (name, meta)
    np.testing.assert_array_equal(again["lookup"], params["lookup"])
    _assert_params_equal({k: v for k, v in again.items() if k != "lookup"},
                         {k: v for k, v in params.items() if k != "lookup"})
    assert fsw_k_from_meta({"model_input_size": 8}) == 7  # no fsw_k: input width - 1


@pytest.mark.parametrize("classifier", [False, True])
def test_reference_torch_checkpoint_loads_like_jax(tmp_path, classifier):
    rng = np.random.default_rng(4)
    out = "fc3" if classifier else "fc2"
    sd = {
        "module.fc1.weight": torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32)),
        "module.fc1.bias": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32)),
        f"{out}.weight": torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32)),
        f"{out}.bias": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32)),
    }
    state = {"state_dict": sd, "epoch": 7, "model_input_size": 32}
    if classifier:
        state["model_class_count"] = 3
    path = str(tmp_path / "ref.ckpt")
    torch.save(state, path)
    name, meta, params = load_checkpoint(path)
    ref_name, ref_meta, ref_params = jax_load_checkpoint(path)
    assert name == ref_name == ("NeuralNetClassifierOnly" if classifier else "NeuralNet")
    assert meta == ref_meta
    _assert_params_equal(params, ref_params)
    np.testing.assert_array_equal(params["fc1"]["w"], sd["module.fc1.weight"].numpy().T)


def test_port_saves_tensors_and_refuses_garbage(tmp_path):
    params = {"fc1": {"w": torch.ones(3, 2), "b": torch.zeros(2)}}
    path = str(tmp_path / "t.ckpt")
    save_checkpoint(path, "NeuralNet", {}, params)
    _, _, got = load_checkpoint(path)
    np.testing.assert_array_equal(got["fc1"]["w"], np.ones((3, 2), np.float32))
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="neither"):
        load_checkpoint(str(bad))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "missing.ckpt"))
