"""The dense models of kf2vec as ``nn.Module``s.

- DistEmbed   = NeuralNet (reference models.py:35-49):
                Linear(V,H) -> ReLU -> Linear(H,E)
- Classifier  = NeuralNetClassifierOnly (reference models.py:117-132):
                Linear(V,H) -> ReLU -> Linear(H,C) -> log_softmax

Checkpoints hold the JAX package's parameter layout: nested dicts of numpy
arrays ``{"fc1": {"w": (in, out), "b": (out,)}, ...}``, and for the FSW
model (``models/fsw.py``) also ``"lookup"`` and ``"fsw": {"slices",
"freqs"}``. ``params_from_jax`` and ``params_to_jax`` convert between that
layout and a module, whose ``nn.Linear`` stores ``weight`` as (out, in).
``adam_state_from_jax`` and ``adam_state_to_jax`` do the same for the JAX
package's Adam state ``{"count", "mu", "nu"}`` and ``torch.optim.Adam``'s
``step`` / ``exp_avg`` / ``exp_avg_sq``, so a trainer state autosaved by
either package resumes in the other.

Training is plain autograd through ``nn.Linear``: no kernel of the port is
on the dense models' training step.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class DistEmbed(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, embedding_size: int):
        super().__init__()
        self.fc1 = nn.Linear(input_size, hidden_size)
        self.fc2 = nn.Linear(hidden_size, embedding_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class Classifier(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, num_classes: int):
        super().__init__()
        self.fc1 = nn.Linear(input_size, hidden_size)
        self.fc3 = nn.Linear(hidden_size, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.fc3(F.relu(self.fc1(x))), dim=-1)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every Linear from ``generator`` with torch.nn.Linear's bounds,
    U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for weights and biases (the JAX
    package's ``_linear_init``). The generator must live on the module's
    device."""
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            bound = 1.0 / math.sqrt(layer.in_features)
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)
    return module


def params_from_jax(params: dict) -> nn.Module:
    """JAX-layout params -> a CPU module: FSWDistEmbed if it has ``fsw``,
    Classifier if it has ``fc3``, else DistEmbed."""
    w1 = np.asarray(params["fc1"]["w"])
    if "fsw" in params:
        from .fsw import FSWDistEmbed

        base_dim = np.shape(params["lookup"])[1]
        d_out, d_in = np.shape(params["fsw"]["slices"])
        out_name = "fc2"
        module: nn.Module = FSWDistEmbed(
            d_in // base_dim, base_dim, d_out, w1.shape[1], np.shape(params["fc2"]["w"])[1]
        )
        with torch.no_grad():
            module.lookup.copy_(_tensor(params["lookup"]))
            module.slices.copy_(_tensor(params["fsw"]["slices"]))
            module.freqs.copy_(_tensor(params["fsw"]["freqs"]))
    elif "fc3" in params:
        out_name = "fc3"
        module = Classifier(w1.shape[0], w1.shape[1], np.shape(params["fc3"]["w"])[1])
    elif "fc2" in params:
        out_name = "fc2"
        module = DistEmbed(w1.shape[0], w1.shape[1], np.shape(params["fc2"]["w"])[1])
    else:
        raise ValueError(f"not a dense or FSW kf2vec model: top-level keys {sorted(params)}")
    with torch.no_grad():
        for name in ("fc1", out_name):
            layer = getattr(module, name)
            layer.weight.copy_(_tensor(params[name]["w"]).T)
            layer.bias.copy_(_tensor(params[name]["b"]))
    return module


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def params_to_jax(module: nn.Module) -> dict:
    """A module -> JAX-layout params (numpy float32, weights (in, out))."""
    params = {
        name: {"w": _numpy(layer.weight.T), "b": _numpy(layer.bias)}
        for name, layer in module.named_children()
        if isinstance(layer, nn.Linear)
    }
    from .fsw import FSWDistEmbed

    if isinstance(module, FSWDistEmbed):
        params["lookup"] = _numpy(module.lookup)
        params["fsw"] = {"slices": _numpy(module.slices), "freqs": _numpy(module.freqs)}
    return params


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def _param_slots(module: nn.Module):
    """(path in the JAX layout, parameter, stored transposed) of every
    parameter: the FSW model's lookup, slices and freqs, then each Linear."""
    from .fsw import FSWDistEmbed

    if isinstance(module, FSWDistEmbed):
        yield ("lookup",), module.lookup, False
        yield ("fsw", "slices"), module.slices, False
        yield ("fsw", "freqs"), module.freqs, False
    for name, layer in module.named_children():
        if isinstance(layer, nn.Linear):
            yield (name, "w"), layer.weight, True
            yield (name, "b"), layer.bias, False


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


@torch.no_grad()
def adam_state_from_jax(opt: torch.optim.Optimizer, module: nn.Module, state: dict) -> None:
    """Load the JAX package's Adam state (``count``, and ``mu`` / ``nu`` in
    the params' layout) into ``opt``, an Adam over ``module``'s parameters.
    ``step`` is a CPU float32 tensor, as torch.optim.Adam keeps it outside
    capturable and fused mode."""
    count = float(np.asarray(state["count"]))
    for path, p, transposed in _param_slots(module):
        mu, nu = (_tensor(_get(state[m], path)) for m in ("mu", "nu"))
        if transposed:
            mu, nu = mu.T, nu.T
        opt.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu.contiguous().to(p.device),
            "exp_avg_sq": nu.contiguous().to(p.device),
        }


def adam_state_to_jax(opt: torch.optim.Optimizer, module: nn.Module) -> dict:
    """``opt``'s Adam state over ``module`` -> the JAX package's
    ``{"count": int32, "mu": params-like, "nu": params-like}`` (numpy, (in,
    out) weights); zeros and count 0 before the first step."""
    count = 0
    mu: dict = {}
    nu: dict = {}
    for path, p, transposed in _param_slots(module):
        st = opt.state.get(p)
        if st:
            count = int(st["step"])
            m, v = st["exp_avg"], st["exp_avg_sq"]
        else:
            m = v = torch.zeros_like(p)
        if transposed:
            m, v = m.T, v.T
        _put(mu, path, _numpy(m))
        _put(nu, path, _numpy(v))
    return {"count": np.int32(count), "mu": mu, "nu": nu}
