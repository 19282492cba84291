"""Process groups and the collective helpers of training over ranks (the
port's counterpart of the JAX package's ``parallel/mesh.py``).

One process per card, the ``torchrun`` idiom: a launcher starts N ranks
with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set, and ``initialize_distributed`` joins them into one
``torch.distributed`` process group. The backend follows the device: NCCL
between cards, gloo on the CPU. NCCL takes one card per rank; an explicit
``backend="gloo"`` (or ``KF2VEC_DIST_BACKEND=gloo`` for the CLI) is the
only way to put several ranks on one card, and nothing switches backend
quietly.

``DataMesh`` is the grid of ranks, the JAX package's ``make_mesh(n_data,
n_model)`` with its ``data`` and ``model`` axes. Rank r sits at data index
r // n_model and model index r % n_model (the JAX package's
``reshape(n_data, n_model)``). ``data_mesh`` is the grid (world, 1): every
rank embeds its rows of every batch, and the gradients are summed across
ranks. ``make_mesh(n_data, n_model)`` adds the model axis: the ranks of a
data index (its model group) each hold a cut of the model, tensor-parallel
over the MLP's hidden dimension and the FSW slices (``shard_module``,
``gather_module``; ``models/mlp.py`` says which dimension each parameter is
cut on), and the ranks of a model index (its data group) split the batch
rows and sum their gradients. The collectives of the sharded batch plan
run on the data group; the model's own run on the model group.

The collectives are all-reduces only (NCCL, gloo on the CPU and gloo on
CUDA tensors, which it stages through the host, all carry them). A
gather is an all-reduce of a zero buffer in which each rank fills its own
rows, the JAX package's own trick (``train/chunks.py:
sample_chunk_batch_sharded``); it is exact, since x + 0 = x (``gather_module``
sums the float bits as int32, so even -0.0 comes back whole).

``put_global``, ``put_global_rows`` and ``replicated`` have no counterpart:
they place host arrays under a GSPMD sharding, and here every rank already
holds identical host values (the same seed draws the same weights and
batches on every rank). ``shard_params`` is ``shard_module`` (the full
weights in, this rank's cut out) and ``fetch_replicated`` is
``gather_module`` (the cuts in, the full weights out on every rank).
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device

BACKEND_ENV = "KF2VEC_DIST_BACKEND"
BACKENDS = ("nccl", "gloo")


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def _cluster_detectable() -> bool:
    """A multi-task launch that a cluster's own variables show: SLURM or
    OpenMPI with more than one task (the JAX package's
    ``_cluster_detectable``; the TPU pod's variables have no card
    counterpart)."""
    env = os.environ
    try:
        if env.get("SLURM_JOB_ID") and int(env.get("SLURM_NTASKS") or 1) > 1:
            return True
        if int(env.get("OMPI_COMM_WORLD_SIZE") or 1) > 1:
            return True
    except ValueError:
        pass
    return False


def nccl_card(local_rank: int, local_world: int | None, n_cards: int) -> int:
    """The card of a rank under NCCL, one card per rank; raises when the host
    starts more ranks than it has visible cards (NCCL refuses two ranks on
    one device)."""
    ranks = max(local_rank + 1, local_world or 0)
    if ranks > n_cards:
        raise RuntimeError(
            f"{ranks} local ranks but {n_cards} visible CUDA device(s): NCCL takes one card "
            f"per rank. Start at most {n_cards} rank(s) on this host, or share a card with "
            f"backend='gloo' ({BACKEND_ENV}=gloo for the CLI)"
        )
    return local_rank


def initialize_distributed(backend: str | None = None, device: str = DEFAULT_DEVICE) -> bool:
    """Join the launcher's process group; returns True when one exists.

    Idempotent, like the JAX package's ``initialize_distributed``: one
    process may run several stages. Without ``MASTER_ADDR`` the process
    trains alone, unless SLURM or OpenMPI started several tasks: then it
    raises rather than train N independent copies that race the output
    directory. ``backend`` defaults to ``KF2VEC_DIST_BACKEND``, else NCCL
    for ``device="cuda"`` and gloo for ``"cpu"``. On the card each rank
    makes ``cuda:LOCAL_RANK`` its current device before any tensor is made
    (under gloo, ranks beyond the visible cards share them in turn), so
    ``-device cuda`` means the rank's own card."""
    if dist.is_initialized():
        return True
    world = _env_int("WORLD_SIZE")
    if not os.environ.get("MASTER_ADDR"):
        if _cluster_detectable() or (world or 1) > 1:
            raise RuntimeError(
                "a launch of more than one task without MASTER_ADDR: set MASTER_ADDR and "
                "MASTER_PORT (torchrun does) so the ranks join one process group, instead of "
                "training independent copies that race the output directory"
            )
        return False
    rank = _env_int("RANK")
    if world is None or rank is None:
        raise RuntimeError("MASTER_ADDR is set but RANK or WORLD_SIZE is not")
    local_rank = _env_int("LOCAL_RANK") or 0
    dev = resolve_device(device)
    backend = backend or os.environ.get(BACKEND_ENV) or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: use one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend carries CUDA tensors only; the CPU takes gloo")
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if backend == "nccl":
            torch.cuda.set_device(nccl_card(local_rank, _env_int("LOCAL_WORLD_SIZE"), n_cards))
        else:
            torch.cuda.set_device(local_rank % n_cards)
    dist.init_process_group(backend, rank=rank, world_size=world)
    return True


def shutdown_distributed() -> None:
    """Leave the process group at the end of a process: every rank waits for
    the others, then destroys the group, so that no rank exits while a peer
    still holds its connections (a gloo rank whose peer vanished first may
    abort at exit). Nothing without a group."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


@dataclass(frozen=True)
class DataMesh:
    """A grid of ``world_size`` ranks, ``n_data`` x ``n_model``: this rank's
    ``rank`` and ``device``, and the process groups of its data and model
    indices. ``distributed`` says that a process group carries the
    collectives; the trainers then take the sharded batch plan, at world
    size 1 too. ``data_group`` None is the whole world (the grid (world,
    1)); ``model_group`` is None when n_model is 1."""

    world_size: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    distributed: bool = False
    n_model: int = 1
    data_group: object = None
    model_group: object = None

    @property
    def n_data(self) -> int:
        return self.world_size // self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    def __deepcopy__(self, memo):
        return self  # process groups are not copied: a module's copy shares its grid


def data_mesh(device: torch.device) -> DataMesh:
    """The grid (world, 1) of the process group this process joined (a mesh
    of one without a group); ``device`` is resolved to the rank's current
    card."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return DataMesh(1, 0, device, False)
    return DataMesh(dist.get_world_size(), dist.get_rank(), device, True)


def trainer_mesh(mesh: DataMesh | None, device: torch.device) -> DataMesh:
    """A trainer's grid: ``mesh`` when the caller passed one (its device must
    be of ``device``'s type), else ``data_mesh(device)``."""
    if mesh is None:
        return data_mesh(device)
    if mesh.device.type != device.type:
        raise ValueError(f"the grid is on {mesh.device} but the trainer runs on {device}")
    return mesh


_GROUP_LABELS: dict[int, str] = {}  # id of a group make_mesh made -> "data" or "model"


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: str | torch.device = DEFAULT_DEVICE) -> DataMesh:
    """The grid ``n_data`` x ``n_model`` over the joined process group (the
    JAX package's ``make_mesh``): raises unless n_data * n_model is the
    world size (``n_data`` None: world // n_model). With n_model > 1 it
    makes the data groups (one per model index) and the model groups (one
    per data index) with ``torch.distributed.new_group``, which every rank
    must call for every group in the same order: so every rank of the world
    calls ``make_mesh`` with the same shape. n_model = 1 is ``data_mesh``."""
    base = data_mesh(resolve_device(device))
    world = base.world_size
    n_data = world // max(n_model, 1) if n_data is None else n_data
    if n_model < 1 or n_data < 1 or n_data * n_model != world:
        raise ValueError(f"a grid of {n_data} x {n_model} (data x model) ranks needs "
                         f"{n_data * n_model} ranks, but the world has {world}")
    if n_model == 1:
        return base
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    mesh = replace(base, n_model=n_model, data_group=data_groups[base.rank % n_model],
                   model_group=model_groups[base.rank // n_model])
    _GROUP_LABELS[id(mesh.data_group)] = "data"
    _GROUP_LABELS[id(mesh.model_group)] = "model"
    return mesh


def mesh_line(mesh: DataMesh) -> str:
    """The ``Ranks:`` line of a trainer's run log over ranks."""
    return (f"Ranks: {mesh.world_size} ({dist.get_backend()}), grid {mesh.n_data} x "
            f"{mesh.n_model} (data x model), this one {mesh.rank} (data {mesh.data_rank}, "
            f"model {mesh.model_rank}) on {mesh.device}")


def is_coordinator() -> bool:
    """True on the rank that owns file writes: rank 0, or the only process
    without a group (``kf2vecfsw_tpu/train/resume.py:is_coordinator``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_row_slice(n_rows: int, mesh: DataMesh) -> slice:
    """The contiguous [lo, hi) rows of an array split evenly over the data
    axis that this rank's data index owns; raises when the rows do not
    divide (pad first)."""
    per, rem = divmod(n_rows, mesh.n_data)
    if rem:
        raise ValueError(
            f"process_row_slice: {n_rows} rows not divisible by {mesh.n_data} ranks "
            "- pad the leading axis first"
        )
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (None: the world; nothing without a
    process group, nor over a group of one rank that ``make_mesh`` made);
    counts the calls and bytes in ``all_reduce_.calls`` and
    ``all_reduce_.bytes``, and the bytes by group ("world", "data",
    "model") in ``all_reduce_.bytes_by``."""
    if dist.is_initialized() and (group is None or dist.get_world_size(group) > 1):
        dist.all_reduce(t, group=group)
        n_bytes = t.numel() * t.element_size()
        label = "world" if group is None else _GROUP_LABELS.get(id(group), "group")
        all_reduce_.calls += 1
        all_reduce_.bytes += n_bytes
        all_reduce_.bytes_by[label] = all_reduce_.bytes_by.get(label, 0) + n_bytes
    return t


all_reduce_.calls = 0  # all-reduces in this process
all_reduce_.bytes = 0
all_reduce_.bytes_by = {}


def gather_rows(own: torch.Tensor, lo: int, n_rows: int, group=None) -> torch.Tensor:
    """(n_rows, ...): rows [lo, lo + len(own)) from this rank's ``own``, the
    others from the other ranks of ``group`` (None: the world; disjoint
    ranges that cover every row), by one all-reduce of a zero buffer.
    ``own`` is not differentiated."""
    out = torch.zeros((n_rows, *own.shape[1:]), dtype=own.dtype, device=own.device)
    out[lo : lo + own.shape[0]] = own.detach()
    return all_reduce_(out, group)


def rank_rows(row: torch.Tensor, mesh: DataMesh, group=None) -> torch.Tensor:
    """(ranks, ...) of every rank's ``row`` in ``group`` (None: the world),
    in the group's rank order."""
    if group is None or not mesh.distributed:
        return gather_rows(row[None], mesh.rank, mesh.world_size)
    return gather_rows(row[None], dist.get_rank(group), dist.get_world_size(group), group)


def barrier(mesh: DataMesh, group=None) -> None:
    """Wait until every rank of ``group`` (None: the world) has reached this
    call (an all-reduce whose result is fetched)."""
    if mesh.distributed:
        all_reduce_(torch.zeros(1, device=mesh.device), group).item()


# -- the model axis ----------------------------------------------------------------


def _cut_dims(module: nn.Module) -> list[tuple[str, nn.Parameter, int | None]]:
    """(name, parameter, the dimension the model axis cuts or None) of every
    parameter, from ``models.mlp.model_axis_specs``."""
    from ..models.mlp import model_axis_specs

    specs = model_axis_specs(module)
    return [(name, p, specs[name]) for name, p in module.named_parameters()]


def _sync_linear_sizes(module: nn.Module) -> None:
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            layer.out_features, layer.in_features = layer.weight.shape


@torch.no_grad()
def shard_module(module: nn.Module, mesh: DataMesh | None) -> nn.Module:
    """This rank's cut of ``module`` (full weights, the same on every rank)
    over ``mesh``'s model axis: a copy whose cut parameters hold the
    model-rank-th of n_model equal parts along their dimension, with
    ``model_axis`` set to the mesh so the forward joins the model group
    (the JAX package's ``shard_params``). ``module`` itself without a model
    axis (n_model 1). Raises when the cut dimension does not divide by
    n_model: the model is never quietly replicated."""
    if mesh is None or mesh.n_model == 1:
        return module
    from ..models.mlp import model_axis_extent

    what, size = model_axis_extent(module)
    if size % mesh.n_model:
        raise ValueError(f"the model axis cuts the {what} of {type(module).__name__}: "
                         f"{what} {size} does not divide by n_model {mesh.n_model}")
    out = copy.deepcopy(module)
    for _, p, dim in _cut_dims(out):
        if dim is not None:
            p.data = p.data.chunk(mesh.n_model, dim)[mesh.model_rank].contiguous()
    _sync_linear_sizes(out)
    out.model_axis = mesh
    return out


def gather_cuts(pieces: list[tuple[torch.Tensor, int | None]], mesh: DataMesh) -> list[torch.Tensor]:
    """The full tensors of the cuts ``pieces`` (this rank's part, the
    dimension the model axis cuts, None for a whole tensor, returned as it
    is) by one all-reduce over the model group of a zero buffer of their
    float32 bits as int32, each rank filling its own part: bit-exact.
    Every rank of the model group calls it with the same pieces."""
    fulls = []
    for t, dim in pieces:
        if dim is not None:
            shape = list(t.shape)
            shape[dim] *= mesh.n_model
            buf = torch.zeros(shape, dtype=torch.int32, device=t.device)
            buf.narrow(dim, mesh.model_rank * t.shape[dim], t.shape[dim]).copy_(
                t.detach().contiguous().view(torch.int32))
            fulls.append(buf)
    if not fulls:
        return [t for t, _ in pieces]
    flat = all_reduce_(torch.cat([b.reshape(-1) for b in fulls]), mesh.model_group)
    whole = iter(f.view(b.shape).view(torch.float32)
                 for f, b in zip(flat.split([b.numel() for b in fulls]), fulls))
    return [t if dim is None else next(whole) for t, dim in pieces]


@torch.no_grad()
def gather_module(module: nn.Module) -> nn.Module:
    """The full weights of a module cut by ``shard_module`` on every rank of
    its model group (the JAX package's ``fetch_replicated``): a copy without
    a model axis, whose forward is the unsharded one. A collective: every
    rank of the model group calls it. ``module`` itself when it is not cut."""
    mesh = getattr(module, "model_axis", None)
    if mesh is None:
        return module
    dims = _cut_dims(module)
    fulls = gather_cuts([(p, dim) for _, p, dim in dims], mesh)
    out = copy.deepcopy(module)
    for (_, p, _), full in zip(_cut_dims(out), fulls):
        p.data = full.clone()
    _sync_linear_sizes(out)
    out.model_axis = None
    return out


def params_checksum(module: nn.Module) -> torch.Tensor:
    """(4,) int64 sums of the parameters' bits, as 16-bit halves, plain and
    weighted by position: equal for bit-equal parameters, exact (no sum
    reaches 2^63 below 2^40 parameters) and independent of summation order."""
    out = torch.zeros(4, dtype=torch.int64, device=next(module.parameters()).device)
    offset = 0
    for p in module.parameters():
        bits = p.detach().reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        weight = (torch.arange(bits.numel(), device=bits.device) + offset) % 127 + 1
        for i, half in enumerate((bits & 0xFFFF, bits >> 16)):
            out[i] += half.sum()
            out[2 + i] += (half * weight).sum()
        offset += bits.numel()
    return out


def check_replicas(module: nn.Module, mesh: DataMesh, what: str) -> str:
    """Raise unless every rank holds bit-equal parameters in ``module``
    (their checksums, gathered by one all-reduce over the world, agree);
    returns the log line that says they do. On a grid with a model axis
    ``module`` is the gathered full model (``gather_module``): a rank's cut
    differs from its model group's by design, so comparing cuts across the
    world would be wrong."""
    sums = rank_rows(params_checksum(module), mesh).cpu()
    if not bool((sums == sums[0]).all()):
        raise RuntimeError(f"{what}: the ranks' parameters differ (checksums {sums.tolist()})")
    return (f"Replicas: {what} bit-equal on {mesh.world_size} rank(s) "
            f"(checksum {' '.join(str(v) for v in sums[0].tolist())})")
