"""The dense models of kf2vec as ``nn.Module``s.

- DistEmbed   = NeuralNet (reference models.py:35-49):
                Linear(V,H) -> ReLU -> Linear(H,E)
- Classifier  = NeuralNetClassifierOnly (reference models.py:117-132):
                Linear(V,H) -> ReLU -> Linear(H,C) -> log_softmax

Checkpoints hold the JAX package's parameter layout: nested dicts of numpy
arrays ``{"fc1": {"w": (in, out), "b": (out,)}, ...}``. ``params_from_jax``
and ``params_to_jax`` convert between that layout and a module, whose
``nn.Linear`` stores ``weight`` as (out, in).
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
    """JAX-layout params -> a CPU module (Classifier if it has ``fc3``,
    else DistEmbed)."""
    w1 = np.asarray(params["fc1"]["w"])
    if "fc3" in params:
        out_name = "fc3"
        module: nn.Module = Classifier(w1.shape[0], w1.shape[1], np.shape(params["fc3"]["w"])[1])
    elif "fc2" in params:
        out_name = "fc2"
        module = DistEmbed(w1.shape[0], w1.shape[1], np.shape(params["fc2"]["w"])[1])
    else:
        raise ValueError(f"not a dense kf2vec model: top-level keys {sorted(params)}")
    with torch.no_grad():
        for name in ("fc1", out_name):
            layer = getattr(module, name)
            w = torch.from_numpy(np.asarray(params[name]["w"], dtype=np.float32))
            layer.weight.copy_(w.T)
            layer.bias.copy_(torch.from_numpy(np.asarray(params[name]["b"], dtype=np.float32)))
    return module


def params_to_jax(module: nn.Module) -> dict:
    """A module -> JAX-layout params (numpy float32, weights (in, out))."""
    return {
        name: {
            "w": layer.weight.detach().T.cpu().numpy().copy(),
            "b": layer.bias.detach().cpu().numpy().copy(),
        }
        for name, layer in module.named_children()
        if isinstance(layer, nn.Linear)
    }
