"""The model zoo (the JAX package's ``models/zoo.py``): the reference's
architectures that no CLI path trains (models.py: BiRNN :13-32,
NeuralNetClassifier :70-89, NeuralNetClassifierForked :92-113,
NeuralNetClassifierTrans :136-171, NeuralNet_2layer :176-192, CNN_network/_2
:197-266, NeuralNet_3layer :269-291, NeuralNet_4layer :294-320,
NeuralNet_2l_drop :323-348, NeuralNet_2l_bn :351-373), as ``nn.Module``s
named after their JAX counterparts.

Each constructor draws its weights from an explicit CPU or device
``torch.Generator`` as the JAX package's ``init_*`` do: every linear layer
U(-1/sqrt(fan_in), +1/sqrt(fan_in)), each LSTM's input and hidden products
with the fan-in of each, norms at ones and zeros. Without a generator the
weights are left for ``zoo_params_from_jax`` to fill. ``MLPDropout`` draws
its masks from the generator passed to ``forward``.

Layout: the modules keep the JAX package's parameter names, so
``zoo_params_to_jax`` / ``zoo_params_from_jax`` carry weights both ways
(linear weights transposed, the LSTM's ``layers[i]["fwd" | "bwd"]``, norm
``scale``/``bias``), and ``zoo_state_to_jax`` the BatchNorm running
statistics. Plain torch ops throughout (no hand kernel: the JAX zoo has no
Pallas kernel).
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .mlp import init_params_

# the layers weight_init_uniform re-draws: linear layers of these names
_LINEAR_NAME = re.compile(r"^(fc\d*|ffn\d+|qkv|out)$")


def _linears(sizes: list[int]) -> dict[str, nn.Linear]:
    if len(sizes) < 2:
        raise ValueError(f"sizes [in, ..., out] needs at least 2 entries, got {sizes}")
    return {f"fc{i + 1}": nn.Linear(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)}


@torch.no_grad()
def _init_(module: nn.Module, generator: torch.Generator | None) -> None:
    """Every Linear (``init_params_``) and every LSTM weight from the
    generator: the input product's U(+-1/sqrt(d_in)), the hidden product's
    U(+-1/sqrt(hidden)), as the JAX package's ``_linear_init`` of ``wi`` and
    ``wh``."""
    if generator is None:
        return
    init_params_(module, generator)
    for layer in module.modules():
        if isinstance(layer, nn.LSTM):
            for name, p in layer.named_parameters():
                fan_in = layer.hidden_size if "_hh_" in name else (
                    layer.input_size if "_l0" in name else 2 * layer.hidden_size)
                bound = 1.0 / math.sqrt(fan_in)
                p.uniform_(-bound, bound, generator=generator)


class MLP(nn.Module):
    """``init_mlp`` / ``mlp_apply`` (NeuralNet_{2,3,4}layer): sizes = [in,
    h1, ..., out], ReLU between the layers, a linear head; any depth >= 1."""

    def __init__(self, sizes: list[int], generator: torch.Generator | None = None):
        super().__init__()
        for name, layer in _linears(sizes).items():
            self.add_module(name, layer)
        _init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self.children())
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                x = F.relu(x)
        return x


class ClassifierEmbed(nn.Module):
    """NeuralNetClassifier: (emb, log_softmax) with fc3 on relu(emb)."""

    def __init__(self, input_size: int, hidden_size: int, embedding_size: int,
                 num_classes: int, generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = nn.Linear(input_size, hidden_size)
        self.fc2 = nn.Linear(hidden_size, embedding_size)
        self.fc3 = nn.Linear(embedding_size, num_classes)
        _init_(self, generator)

    def forward(self, x: torch.Tensor):
        emb = self.fc2(F.relu(self.fc1(x)))
        return emb, F.log_softmax(self.fc3(F.relu(emb)), dim=-1)


class ClassifierForked(nn.Module):
    """NeuralNetClassifierForked: (emb, log_softmax) with fc3 on the hidden
    layer, beside fc2."""

    def __init__(self, input_size: int, hidden_size: int, embedding_size: int,
                 num_classes: int, generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = nn.Linear(input_size, hidden_size)
        self.fc2 = nn.Linear(hidden_size, embedding_size)
        self.fc3 = nn.Linear(hidden_size, num_classes)
        _init_(self, generator)

    def forward(self, x: torch.Tensor):
        h = F.relu(self.fc1(x))
        return self.fc2(h), F.log_softmax(self.fc3(h), dim=-1)


class MLPDropout(MLP):
    """NeuralNet_2l_drop (``mlp_dropout_apply``): inverted dropout at
    ``rate`` after each hidden ReLU, in training mode and only when
    ``forward`` is given a generator (on x's device) for the masks."""

    def __init__(self, sizes: list[int], rate: float = 0.2,
                 generator: torch.Generator | None = None):
        super().__init__(sizes, generator)
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        layers = list(self.children())
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                x = F.relu(x)
                if self.training and generator is not None:
                    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - self.rate
                    x = torch.where(keep, x / (1 - self.rate), torch.zeros_like(x))
        return x


class MLPBN(nn.Module):
    """NeuralNet_2l_bn (``init_mlp_bn`` / ``mlp_bn_apply``): each hidden
    linear layer, then BatchNorm, then ReLU. In training mode the batch is
    normalised with its biased variance and the running statistics track the
    unbiased one, new = momentum * old + (1 - momentum) * batch: the JAX
    argument's ``momentum`` (0.9) is torch's 1 - momentum (0.1). The running
    statistics are buffers (``zoo_state_to_jax``)."""

    def __init__(self, sizes: list[int], momentum: float = 0.9, eps: float = 1e-5,
                 generator: torch.Generator | None = None):
        super().__init__()
        linears = _linears(sizes)
        for i, (name, layer) in enumerate(linears.items()):
            self.add_module(name, layer)
            if i < len(linears) - 1:
                self.add_module(f"bn{i + 1}",
                                nn.BatchNorm1d(sizes[i + 1], eps=eps, momentum=1 - momentum))
        _init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
            if isinstance(layer, nn.BatchNorm1d):
                x = F.relu(x)
        return x


class CNN(nn.Module):
    """CNN_network / CNN_network_2: the reference's Conv1d(kernel_size=1)
    over a length-1 signal is a linear layer on the features, so ``conv1``
    (and with ``double`` ``conv2``, both 2 x input wide) are linear: sigmoid
    after each, fc1 with CELU(alpha 1), fc2."""

    def __init__(self, input_size: int, hidden_size: int, embedding_size: int,
                 double: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        mid = 2 * input_size if double else input_size
        self.conv1 = nn.Linear(input_size, mid)
        self.conv2 = nn.Linear(mid, mid) if double else None
        self.fc1 = nn.Linear(mid, hidden_size)
        self.fc2 = nn.Linear(hidden_size, embedding_size)
        _init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.sigmoid(self.conv1(x))
        if self.conv2 is not None:
            h = torch.sigmoid(self.conv2(h))
        return self.fc2(F.celu(self.fc1(h)))


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.out = nn.Linear(d, d)


class ClassifierTrans(nn.Module):
    """NeuralNetClassifierTrans (``classifier_trans_apply``): fc1, ReLU, fc2
    give the embedding (B, d); one post-norm encoder layer attends ACROSS
    THE BATCH (the batch is the sequence, as the reference's
    ``out.unsqueeze(0)``): ``n_heads`` heads of qkv and out projections, a
    ReLU FFN of ``ffn_size``, two LayerNorms (eps 1e-5); fc3 and
    log_softmax. Returns (emb, encoded, log_softmax). The projections are
    ``nn.Linear``s (not ``nn.MultiheadAttention``), so they carry the JAX
    weights one to one and ``weight_init_uniform`` finds ``qkv`` and
    ``out``."""

    def __init__(self, input_size: int, hidden_size: int, embedding_size: int,
                 num_classes: int, n_heads: int = 16, ffn_size: int = 2048,
                 generator: torch.Generator | None = None):
        super().__init__()
        if embedding_size % n_heads:
            raise ValueError(f"embedding size {embedding_size} not divisible by n_heads {n_heads}")
        d = embedding_size
        self.n_heads = n_heads
        self.fc1 = nn.Linear(input_size, hidden_size)
        self.fc2 = nn.Linear(hidden_size, d)
        self.attn = _Attention(d)
        self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.ffn1 = nn.Linear(d, ffn_size)
        self.ffn2 = nn.Linear(ffn_size, d)
        self.ln2 = nn.LayerNorm(d, eps=1e-5)
        self.fc3 = nn.Linear(d, num_classes)
        _init_(self, generator)

    def forward(self, x: torch.Tensor):
        emb = self.fc2(F.relu(self.fc1(x)))  # (B, d)
        b, d = emb.shape
        hd = d // self.n_heads
        q, k, v = (t.reshape(b, self.n_heads, hd).transpose(0, 1)
                   for t in self.attn.qkv(emb).split(d, dim=-1))
        scores = torch.einsum("hqd,hkd->hqk", q, k) / math.sqrt(hd)
        ctx = torch.einsum("hqk,hkd->hqd", torch.softmax(scores, dim=-1), v)
        ctx = self.attn.out(ctx.transpose(0, 1).reshape(b, d))
        h2 = self.ln1(emb + ctx)
        trans = self.ln2(h2 + self.ffn2(F.relu(self.ffn1(h2))))
        return emb, trans, F.log_softmax(self.fc3(trans), dim=-1)


class BiRNN(nn.Module):
    """BiRNN (``birnn_apply``): a bidirectional LSTM of ``num_layers``
    (gates i, f, g, o with an input and a hidden bias, ``nn.LSTM``'s own
    layout) over x (B, T, D); fc on the last time step of the stacked
    forward and backward outputs."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, num_classes: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.rnn = nn.LSTM(input_size, hidden_size, num_layers, batch_first=True,
                           bidirectional=True)
        self.fc = nn.Linear(2 * hidden_size, num_classes)
        _init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, _ = self.rnn(x)
        return self.fc(out[:, -1])


@torch.no_grad()
def weight_init_uniform(module: nn.Module, generator: torch.Generator, low: float = 0.0,
                        high: float = 0.001) -> nn.Module:
    """Re-draw the linear layers named fc*, ffn*, qkv or out: weights
    U(low, high) from ``generator``, biases 0 (the reference's optional
    weight_init, train_model_set.py:381); BatchNorm and LayerNorm, the LSTM
    and the CNN's conv layers keep their values, as in the JAX package."""
    for name, layer in module.named_modules():
        if isinstance(layer, nn.Linear) and _LINEAR_NAME.match(name.rsplit(".", 1)[-1]):
            layer.weight.uniform_(low, high, generator=generator)
            layer.bias.zero_()
    return module


def new_parameter(shape) -> nn.Parameter:
    """An all-ones float32 parameter (parameter_inits.py:7-13)."""
    return nn.Parameter(torch.ones(shape, dtype=torch.float32))


# -- weights carried to and from the JAX package's layout ----------------------


def _slots(module: nn.Module):
    """(JAX path, tensor, stored transposed) of every parameter; the LSTM's
    ``weight_ih_l{i}[_reverse]`` go to ``layers[i]["fwd" | "bwd"]["wi"]``."""
    for name, layer in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(layer, nn.Linear):
            yield path + ("w",), layer.weight, True
            yield path + ("b",), layer.bias, False
        elif isinstance(layer, (nn.BatchNorm1d, nn.LayerNorm)):
            yield path + ("scale",), layer.weight, False
            yield path + ("bias",), layer.bias, False
        elif isinstance(layer, nn.LSTM):
            for i in range(layer.num_layers):
                for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
                    for cell, kind in (("wi", "ih"), ("wh", "hh")):
                        at = ("layers", i, direction, cell)
                        yield at + ("w",), getattr(layer, f"weight_{kind}_l{i}{suffix}"), True
                        yield at + ("b",), getattr(layer, f"bias_{kind}_l{i}{suffix}"), False


def _put(tree, path: tuple, value) -> None:
    """tree[path] = value, making the dicts and (for an int key) lists on
    the way."""
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(tree) <= key:
                tree.append({})
            tree = tree[key]
        else:
            tree = tree.setdefault(key, [] if isinstance(nxt, int) else {})
    tree[path[-1]] = value


def _get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def zoo_params_to_jax(module: nn.Module) -> dict:
    """A zoo module's params in the JAX package's layout (numpy float32,
    linear weights (in, out)); the LSTM's layers as a list."""
    params: dict = {}
    for path, t, transposed in _slots(module):
        _put(params, path, _numpy(t.T if transposed else t))
    return params


def zoo_state_to_jax(module: nn.Module) -> dict:
    """The BatchNorm running statistics as the JAX package's state
    ``{"bn{i}": {"mean", "var"}}`` (empty for the other models)."""
    return {name: {"mean": _numpy(bn.running_mean), "var": _numpy(bn.running_var)}
            for name, bn in module.named_children() if isinstance(bn, nn.BatchNorm1d)}


def _fc_sizes(params: dict, prefix: str = "fc") -> list[int]:
    n = sum(1 for key in params if re.fullmatch(prefix + r"\d+", key))
    return ([np.shape(params[f"{prefix}1"]["w"])[0]]
            + [np.shape(params[f"{prefix}{i + 1}"]["w"])[1] for i in range(n)])


def zoo_params_from_jax(kind: str, params: dict, state: dict | None = None,
                        n_heads: int = 16, rate: float = 0.2) -> nn.Module:
    """A CPU zoo module of ``kind`` (the JAX function's stem: ``mlp``,
    ``classifier_embed``, ``classifier_forked``, ``mlp_dropout``,
    ``mlp_bn``, ``cnn``, ``classifier_trans`` or ``birnn``) holding the JAX
    layout's ``params`` and, for ``mlp_bn``, its ``state``; the transformer's
    heads and the dropout rate, which the params do not fix, default to the
    JAX functions'."""
    shape = lambda *path: np.shape(_get(params, path))  # noqa: E731
    if kind in ("mlp", "mlp_dropout", "mlp_bn"):
        sizes = _fc_sizes(params)
        module = {"mlp": lambda: MLP(sizes), "mlp_dropout": lambda: MLPDropout(sizes, rate),
                  "mlp_bn": lambda: MLPBN(sizes)}[kind]()
    elif kind in ("classifier_embed", "classifier_forked"):
        cls = ClassifierEmbed if kind == "classifier_embed" else ClassifierForked
        module = cls(*shape("fc1", "w"), shape("fc2", "w")[1], shape("fc3", "w")[1])
    elif kind == "cnn":
        module = CNN(shape("conv1", "w")[0], shape("fc1", "w")[1], shape("fc2", "w")[1],
                     double="conv2" in params)
    elif kind == "classifier_trans":
        module = ClassifierTrans(*shape("fc1", "w"), shape("fc2", "w")[1], shape("fc3", "w")[1],
                                 n_heads, shape("ffn1", "w")[1])
    elif kind == "birnn":
        module = BiRNN(shape("layers", 0, "fwd", "wi", "w")[0],
                       shape("layers", 0, "fwd", "wh", "w")[0], len(params["layers"]),
                       shape("fc", "w")[1])
    else:
        raise ValueError(f"unknown zoo model kind {kind!r}")
    with torch.no_grad():
        for path, t, transposed in _slots(module):
            value = torch.tensor(np.asarray(_get(params, path), dtype=np.float32))
            t.copy_(value.T if transposed else value)
        for name, st in (state or {}).items():
            bn = getattr(module, name)
            bn.running_mean.copy_(torch.tensor(np.asarray(st["mean"], dtype=np.float32)))
            bn.running_var.copy_(torch.tensor(np.asarray(st["var"], dtype=np.float32)))
    return module
