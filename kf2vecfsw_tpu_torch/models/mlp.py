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

The model axis (``parallel.mesh.make_mesh`` with n_model > 1) cuts a model
Megatron-style over its hidden dimension, as the JAX package's
``dist_embed_specs`` / ``classifier_specs`` do: fc1 is column-parallel (its
weight's output rows and its bias are cut), fc2 / fc3 row-parallel (the
weight's input columns are cut, the bias stays whole). ``model_axis_specs``
says which dimension of each parameter is cut; ``parallel.mesh.
shard_module`` cuts a module and sets its ``model_axis``, and the forward
then sums the row-parallel product over the model group
(``row_parallel``: all-reduce forward, identity backward). Every rank of a
model group holds the same rows of data and computes the same loss, so the
identity backward hands each rank its cut's true gradient and the whole
bias's: no parameter's gradient is n_model times the true one (the JAX
package's ``shard_map`` with ``check_rep`` off transposes its forward
``psum`` into another ``psum``, which does scale them).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import DataMesh, all_reduce_, gather_cuts


class _SumOverModelAxis(torch.autograd.Function):
    """Forward: the sum of ``x`` over the model group; backward: identity
    (every rank of the group receives the same cotangent of the sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        out = x.contiguous().clone()
        return all_reduce_(out, mesh.model_group) if out.numel() else out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterModelAxis(torch.autograd.Function):
    """The conjugate of ``_SumOverModelAxis``: forward identity, backward the
    sum of the cotangent over the model group. A whole parameter that feeds
    every rank's cut (FSW's ``lookup``) enters through it, so each rank's
    gradient is the sum of every cut's part: the true gradient, the same on
    every rank of the group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh.model_group), None


def row_parallel(layer: nn.Linear, h: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """``layer(h)``, or, with a model axis, the row-parallel product of the
    rank's input columns summed over the model group plus the whole bias."""
    if mesh is None:
        return layer(h)
    return _SumOverModelAxis.apply(F.linear(h, layer.weight), mesh) + layer.bias


def enter_model_axis(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """``x`` itself, or, with a model axis, ``x`` whose gradient is summed
    over the model group (``_EnterModelAxis``)."""
    return x if mesh is None else _EnterModelAxis.apply(x, mesh)


class DistEmbed(nn.Module):
    model_axis: DataMesh | None = None  # set by parallel.mesh.shard_module

    def __init__(self, input_size: int, hidden_size: int, embedding_size: int):
        super().__init__()
        self.fc1 = nn.Linear(input_size, hidden_size)
        self.fc2 = nn.Linear(hidden_size, embedding_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_parallel(self.fc2, F.relu(self.fc1(x)), self.model_axis)


class Classifier(nn.Module):
    model_axis: DataMesh | None = None  # set by parallel.mesh.shard_module

    def __init__(self, input_size: int, hidden_size: int, num_classes: int):
        super().__init__()
        self.fc1 = nn.Linear(input_size, hidden_size)
        self.fc3 = nn.Linear(hidden_size, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(row_parallel(self.fc3, F.relu(self.fc1(x)), self.model_axis), dim=-1)


def model_axis_specs(module: nn.Module) -> dict[str, int | None]:
    """The dimension the model axis cuts of each parameter (by its name in
    ``module``, in the torch (out, in) layout of ``nn.Linear``), None for a
    whole one: the counterpart of the JAX package's ``dist_embed_specs``,
    ``classifier_specs`` and ``fsw_dist_embed_specs``. FSW cuts its slices
    and frequencies and the input columns of fc1 (row-parallel); the
    lookup, fc1's bias and fc2 stay whole."""
    from .fsw import FSWDistEmbed

    if isinstance(module, FSWDistEmbed):
        return {"lookup": None, "slices": 0, "freqs": 0, "fc1.weight": 1, "fc1.bias": None,
                "fc2.weight": None, "fc2.bias": None}
    out = "fc3" if isinstance(module, Classifier) else "fc2"
    return {"fc1.weight": 0, "fc1.bias": 0, f"{out}.weight": 1, f"{out}.bias": None}


def model_axis_extent(module: nn.Module) -> tuple[str, int]:
    """What the model axis cuts and its full size: the hidden size of a
    dense model or classifier, the slice count d_out of an FSW model."""
    from .fsw import FSWDistEmbed

    if isinstance(module, FSWDistEmbed):
        return "d_out", module.slices.shape[0]
    return "hidden size", module.fc1.out_features


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
    """A module -> JAX-layout params (numpy float32, weights (in, out)); a
    module cut over a model axis is gathered first (``parallel.mesh.
    gather_module``)."""
    if module.model_axis is not None:
        raise ValueError("params_to_jax of a model-axis cut: gather_module it first")
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
    """(path in the JAX layout, parameter, stored transposed, the dimension
    the model axis cuts or None) of every parameter: the FSW model's lookup,
    slices and freqs, then each Linear."""
    from .fsw import FSWDistEmbed

    specs = model_axis_specs(module)
    if isinstance(module, FSWDistEmbed):
        yield ("lookup",), module.lookup, False, specs["lookup"]
        yield ("fsw", "slices"), module.slices, False, specs["slices"]
        yield ("fsw", "freqs"), module.freqs, False, specs["freqs"]
    for name, layer in module.named_children():
        if isinstance(layer, nn.Linear):
            yield (name, "w"), layer.weight, True, specs[f"{name}.weight"]
            yield (name, "b"), layer.bias, False, specs[f"{name}.bias"]


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
    the params' layout, full size) into ``opt``, an Adam over ``module``'s
    parameters; a module cut over a model axis takes its cut of the
    moments. ``step`` is a CPU float32 tensor, as torch.optim.Adam keeps it
    outside capturable and fused mode."""
    count = float(np.asarray(state["count"]))
    mesh = module.model_axis
    for path, p, transposed, dim in _param_slots(module):
        mu, nu = (_tensor(_get(state[m], path)) for m in ("mu", "nu"))
        if transposed:
            mu, nu = mu.T, nu.T
        if mesh is not None and dim is not None:
            mu, nu = (t.chunk(mesh.n_model, dim)[mesh.model_rank] for t in (mu, nu))
        opt.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu.contiguous().to(p.device),
            "exp_avg_sq": nu.contiguous().to(p.device),
        }


def adam_state_to_jax(opt: torch.optim.Optimizer, module: nn.Module) -> dict:
    """``opt``'s Adam state over ``module`` -> the JAX package's
    ``{"count": int32, "mu": params-like, "nu": params-like}`` (numpy, (in,
    out) weights); zeros and count 0 before the first step. The moments of
    a module cut over a model axis are gathered to full size: a collective,
    which every rank of the model group calls."""
    count = 0
    mu: dict = {}
    nu: dict = {}
    mesh = module.model_axis
    for path, p, transposed, dim in _param_slots(module):
        st = opt.state.get(p)
        if st:
            count = int(st["step"])
            m, v = st["exp_avg"], st["exp_avg_sq"]
        else:
            m = v = torch.zeros_like(p)
        if mesh is not None:
            m, v = gather_cuts([(m, dim), (v, dim)], mesh)
        if transposed:
            m, v = m.T, v.T
        _put(mu, path, _numpy(m))
        _put(nu, path, _numpy(v))
    return {"count": np.int32(count), "mu": mu, "nu": nu}
