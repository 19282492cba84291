"""Process groups and the collective helpers of data-parallel training (the
port's counterpart of the JAX package's ``parallel/mesh.py``).

One process per card, the ``torchrun`` idiom: a launcher starts N ranks
with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set, and ``initialize_distributed`` joins them into one
``torch.distributed`` process group. The backend follows the device: NCCL
between cards, gloo on the CPU. NCCL takes one card per rank; an explicit
``backend="gloo"`` (or ``KF2VEC_DIST_BACKEND=gloo`` for the CLI) is the
only way to put several ranks on one card, and nothing switches backend
quietly. ``DataMesh`` (world size, rank, device) stands in for the JAX
package's ``make_mesh()`` and its ``data`` axis: each rank embeds its rows
of every batch, and the gradients are summed across ranks.

The collectives are all-reduces only (NCCL, gloo on the CPU and gloo on
CUDA tensors, which it stages through the host, all carry them). A
gather is an all-reduce of a zero buffer in which each rank fills its own
rows, the JAX package's own trick (``train/chunks.py:
sample_chunk_batch_sharded``); it is exact, since x + 0 = x.

``put_global``, ``put_global_rows``, ``shard_params``, ``replicated`` and
``fetch_replicated`` have no counterpart: they place host arrays under a
GSPMD sharding, and here every rank already holds identical host values
(the same seed draws the same weights and batches on every rank). The
``model`` axis (tensor parallelism of the MLP's hidden dimension and of the
FSW slices) is not ported: no CLI path of the JAX package reaches it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

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
    """The data axis: ``world_size`` ranks, this one's ``rank`` and
    ``device``. ``distributed`` says that a process group carries the
    collectives; the trainers then take the sharded batch plan, at world
    size 1 too."""

    world_size: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    distributed: bool = False


def data_mesh(device: torch.device) -> DataMesh:
    """The mesh of the process group this process joined (a mesh of one
    without a group); ``device`` is resolved to the rank's current card."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return DataMesh(1, 0, device, False)
    return DataMesh(dist.get_world_size(), dist.get_rank(), device, True)


def mesh_line(mesh: DataMesh) -> str:
    """The ``Ranks:`` line of a trainer's run log over ranks."""
    return (f"Ranks: {mesh.world_size} ({dist.get_backend()}), this one {mesh.rank} "
            f"on {mesh.device}")


def is_coordinator() -> bool:
    """True on the rank that owns file writes: rank 0, or the only process
    without a group (``kf2vecfsw_tpu/train/resume.py:is_coordinator``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_row_slice(n_rows: int, mesh: DataMesh) -> slice:
    """The contiguous [lo, hi) rows of an array split evenly over the ranks
    that this rank owns; raises when the rows do not divide (pad first)."""
    per, rem = divmod(n_rows, mesh.world_size)
    if rem:
        raise ValueError(
            f"process_row_slice: {n_rows} rows not divisible by {mesh.world_size} ranks "
            "- pad the leading axis first"
        )
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the group in place (nothing without a group); counts
    the calls and bytes in ``all_reduce_.calls`` and ``all_reduce_.bytes``."""
    if dist.is_initialized():
        dist.all_reduce(t)
        all_reduce_.calls += 1
        all_reduce_.bytes += t.numel() * t.element_size()
    return t


all_reduce_.calls = 0  # all-reduces in this process
all_reduce_.bytes = 0


def gather_rows(own: torch.Tensor, lo: int, n_rows: int) -> torch.Tensor:
    """(n_rows, ...): rows [lo, lo + len(own)) from this rank's ``own``, the
    others from the other ranks' (disjoint ranges that cover every row), by
    one all-reduce of a zero buffer. ``own`` is not differentiated."""
    out = torch.zeros((n_rows, *own.shape[1:]), dtype=own.dtype, device=own.device)
    out[lo : lo + own.shape[0]] = own.detach()
    return all_reduce_(out)


def rank_rows(row: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """(world_size, ...) of every rank's ``row``, in rank order."""
    return gather_rows(row[None], mesh.rank, mesh.world_size)


def barrier(mesh: DataMesh) -> None:
    """Wait until every rank has reached this call (an all-reduce whose
    result is fetched)."""
    if mesh.distributed:
        all_reduce_(torch.zeros(1, device=mesh.device)).item()


def params_checksum(module: torch.nn.Module) -> torch.Tensor:
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


def check_replicas(module: torch.nn.Module, mesh: DataMesh, what: str) -> str:
    """Raise unless every rank holds bit-equal parameters in ``module``
    (their checksums, gathered by one all-reduce, agree); returns the log
    line that says they do."""
    sums = rank_rows(params_checksum(module), mesh).cpu()
    if not bool((sums == sums[0]).all()):
        raise RuntimeError(f"{what}: the ranks' parameters differ (checksums {sums.tolist()})")
    return (f"Replicas: {what} bit-equal on {mesh.world_size} rank(s) "
            f"(checksum {' '.join(str(v) for v in sums[0].tolist())})")
