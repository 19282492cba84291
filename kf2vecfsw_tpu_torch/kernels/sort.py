"""Row sort with a gathered payload: the CUDA kernel and its plain PyTorch version.

``sort_rows(keys, payload)`` sorts each row of ``keys`` (R, N) ascending and
returns the sorted keys, the payload gathered by the same permutation and
the permutation itself. Row r carries payload row ``r // (R // P)`` of
``payload`` (P, N), so the FSW embedding passes one weight row per genome
for its C slice rows instead of broadcasting it. It replaces the JAX
package's Pallas bitonic sort (``_bitonic_kernel`` in kf2vecfsw_tpu/kernels/
sort.py, B3) and the ``lax.sort`` calls of its FSW embedding with one
hand-written kernel, ``csrc/sort_rows.cu``.

The order is that of ``f2i_keys`` (an integer total order on the float
bits, so -0.0 sorts before +0.0). The sort is stable: equal keys come out
in column order, so ``perm`` is fully determined, ties included. (B3 and
``lax.sort(is_stable=False)`` may order ties otherwise: the sorted keys
agree on every row, the payload and ``perm`` on rows without ties.)

The kernel's one entry point takes a row by its length, one algorithm a
length band: up to ``tile_elems()`` (16,384) one thread block sorts it in
shared memory; up to ``cluster_elems()`` (131,072: the k = 8 and k = 9
point sets and vocabularies) one thread block cluster sorts it in
distributed shared memory; longer rows take an LSD radix sort through
device memory: one histogram of all four digits, a scan, and 4 passes over
tiles of ``RADIX_TILE`` that find their digits' offsets by a look-back over
the row's earlier tiles. ``sort_rows.launches`` counts every launch,
``sort_rows.long_launches`` those of the cluster path and
``sort_rows.radix_launches`` those of the radix path.

Memory: a launch allocates its three outputs and, on the radix path, a
scratch of 32-bit keys and columns per element and a row's counts
(``launch_buffers``: the look-back status, 256 words a tile, the digit
counts of every 16 tiles and of the row). ``sort_transient_bytes`` sums
them; the FSW memory budgets (``models.fsw.auto_slice_chunk``,
``train.fsw_lazy.pick_refresh_group``) count the sort through it, and on
the CPU too, where the kernel library is not built: ``TILE_ELEMS``,
``CLUSTER_ELEMS``, ``RADIX_TILE`` and ``radix_counts_words`` mirror the
kernel's ``kTile``, ``kClusterElems``, ``kRadixTile`` and ``RadixShape``.

On a CUDA tensor the wrapper launches that kernel or raises; on a CPU tensor
it runs ``sort_rows_reference``, the same function in plain tensor ops.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

MAX_N = 1 << 30  # columns and perm are int32
TILE_ELEMS = 16_384  # kTile of csrc/sort_rows.cu: the longest row a block sorts
CLUSTER_ELEMS = 131_072  # kClusterElems of csrc/sort_rows.cu: longer rows take the radix path
RADIX = 256  # digits of a radix pass
RADIX_PASSES = 4  # passes of 8-bit digits
RADIX_TILE = 8_192  # kRadixTile of csrc/sort_rows.cu: a tile a radix downsweep block ranks
RADIX_HIST_TILES = 16  # kHistTiles: tiles a radix histogram block counts


def f2i_keys(x: torch.Tensor) -> torch.Tensor:
    """Monotone bijection f32 -> int32 (the JAX package's ``_f2i_keys``):
    negative floats get their magnitude bits flipped, so integer order is
    float order with -0.0 < +0.0."""
    i = x.view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def i2f_keys(k: torch.Tensor) -> torch.Tensor:
    """Inverse of ``f2i_keys``."""
    return torch.where(k < 0, k ^ 0x7FFFFFFF, k).view(torch.float32)


def _check(keys: torch.Tensor, payload: torch.Tensor) -> None:
    for name, t in (("keys", keys), ("payload", payload)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D float32 tensor")
    if payload.device != keys.device:
        raise ValueError(f"keys on {keys.device} but payload on {payload.device}")
    (r, n), p = keys.shape, payload.shape[0]
    if r < 1 or not 1 <= n <= MAX_N:
        raise ValueError(f"sort_rows takes R >= 1 rows of 1 <= N <= {MAX_N}, got {(r, n)}")
    if payload.shape[1] != n or p < 1 or r % p:
        raise ValueError(f"payload {tuple(payload.shape)} must be (P, {n}) with {r} % P == 0")


def unsort(d: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The transpose of a row permutation: out[..., perm[..., j]] = d[..., j]."""
    return torch.empty_like(d).scatter_(-1, perm.long().expand(d.shape), d)


def sort_rows_reference(keys: torch.Tensor, payload: torch.Tensor):
    """Plain-ops version: a stable ``torch.sort`` of the ``f2i_keys``
    integers, then a gather of each row's payload row. Returns (sorted keys
    f32, sorted payload f32, perm int32), all (R, N)."""
    r, p = keys.shape[0], payload.shape[0]
    sk, idx = torch.sort(f2i_keys(keys), dim=-1, stable=True)
    src = (torch.arange(r, device=keys.device) // (r // p))[:, None]
    return i2f_keys(sk), payload[src, idx], idx.to(torch.int32)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (pointers and
    the stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    from .build import load

    lib = load("sort_rows")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sort_rows_launch.argtypes = [p] * 8 + [i64, i64, i64, p]
    lib.sort_rows_radix_step.argtypes = [p] * 8 + [i64, i64, i64, i32, p]
    for name in ("sort_rows_launch", "sort_rows_radix_step"):
        getattr(lib, name).restype = ctypes.c_int
    lib.sort_rows_error_string.argtypes = [ctypes.c_int]
    lib.sort_rows_error_string.restype = ctypes.c_char_p
    lib.sort_rows_cluster_shape.argtypes = [i64] + [ctypes.POINTER(i64)] * 5
    lib.sort_rows_cluster_shape.restype = ctypes.c_int
    for name in ("sort_rows_tile_elems", "sort_rows_cluster_elems", "sort_rows_items_per_thread"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int64
    lib.sort_rows_radix_counts_words.argtypes = [i64]
    lib.sort_rows_radix_counts_words.restype = ctypes.c_int64
    return lib


def tile_elems() -> int:
    """Elements a thread block sorts in shared memory; longer rows take the
    kernel's cluster path."""
    return int(_lib().sort_rows_tile_elems())


def cluster_elems() -> int:
    """Elements a thread block cluster sorts in distributed shared memory;
    longer rows take the kernel's radix path (``CLUSTER_ELEMS``, the host's
    copy, which the card-only tests hold to it)."""
    return int(_lib().sort_rows_cluster_elems())


def cluster_shape(n: int) -> dict[str, int]:
    """The cluster path's launch for rows of N (tile_elems() < N <=
    cluster_elems()) on the current card: blocks a cluster, threads a block,
    items a thread, shared memory bytes a block and the clusters the card
    holds at a time."""
    lib = _lib()
    out = [ctypes.c_int64() for _ in range(5)]
    err = lib.sort_rows_cluster_shape(n, *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"sort_rows cluster shape at N={n}: "
                           f"{lib.sort_rows_error_string(err).decode()} ({err})")
    keys = ("blocks", "threads", "items", "smem_bytes", "active_clusters")
    return dict(zip(keys, (v.value for v in out)))


def items_per_thread() -> int:
    """Keys each thread of a row's block holds: a row of N <= tile_elems()
    goes to the smallest power-of-two block of at least 32 threads with
    threads * items_per_thread() >= N."""
    return int(_lib().sort_rows_items_per_thread())


def radix_counts_words(n: int) -> int:
    """32-bit words of the radix path's counts a row of N: the look-back
    status (RADIX a tile of RADIX_TILE), the histogram's partial counts
    (RADIX_PASSES * RADIX a histogram block of RADIX_HIST_TILES tiles), the
    digit starts (RADIX_PASSES * RADIX) and a tile counter a pass."""
    tiles = -(-n // RADIX_TILE)
    hist_blocks = -(-tiles // RADIX_HIST_TILES)
    return RADIX * tiles + RADIX_PASSES * RADIX * (hist_blocks + 1) + RADIX_PASSES


def radix_counts_words_on_card(n: int) -> int:
    """``radix_counts_words`` as the kernel computes it (the card-only tests
    hold the host's copy to it)."""
    return int(_lib().sort_rows_radix_counts_words(n))


def launch_buffers(r: int, n: int) -> dict[str, tuple[tuple[int, int], torch.dtype]]:
    """(shape, dtype) of each buffer one ``sort_rows`` launch on (R, N) keys
    allocates, in the C entry point's argument order: the sorted keys and
    payload, ``perm`` and, past ``CLUSTER_ELEMS``, the radix path's (R, N)
    keys and columns and its (R, radix_counts_words(N)) counts, all
    32-bit."""
    out = {"keys": ((r, n), torch.float32), "payload": ((r, n), torch.float32),
           "perm": ((r, n), torch.int32)}
    if n > CLUSTER_ELEMS:
        out["scratch_keys"] = ((r, n), torch.int32)
        out["scratch_index"] = ((r, n), torch.int32)
        out["counts"] = ((r, radix_counts_words(n)), torch.int32)
    return out


def sort_transient_bytes(r: int, n: int, p: int) -> int:
    """Bytes a ``sort_rows`` launch on (R, N) keys with (P, N) payload rows
    allocates beyond its inputs: the three outputs, 12 B an element, and
    past ``CLUSTER_ELEMS`` the radix path's scratch, 8 B an element, and its
    counts (``radix_counts_words``): 4 B a digit of a tile (1/8 B an
    element), 4 KiB a histogram block (1/32 B an element), and 4 KiB of digit
    starts and 16 B of tile counters a row."""
    if r < 1 or not 1 <= n <= MAX_N or p < 1 or r % p:
        raise ValueError(f"sort_rows takes R >= 1 rows of 1 <= N <= {MAX_N} with R % P == 0, "
                         f"got {(r, n, p)}")
    return sum(math.prod(shape) * dtype.itemsize for shape, dtype in launch_buffers(r, n).values())


def sort_rows(keys: torch.Tensor, payload: torch.Tensor):
    """(sorted_keys, sorted_payload, perm) of ``keys`` (R, N) f32 and
    ``payload`` (P, N) f32 with R % P == 0: ``perm[r, j]`` is the column of
    ``keys[r]`` at sorted position j, ``sorted_payload[r, j] =
    payload[r // (R // P), perm[r, j]]``."""
    _check(keys, payload)
    if keys.device.type == "cpu":
        return sort_rows_reference(keys, payload)
    if keys.device.type != "cuda":
        raise ValueError(f"sort_rows runs on cuda or cpu tensors, not {keys.device}")
    return _launch(keys, payload)


sort_rows.launches = 0  # kernel launches in this process
sort_rows.long_launches = 0  # those of them on the cluster path
sort_rows.radix_launches = 0  # those of them on the radix path


def _launch(keys: torch.Tensor, payload: torch.Tensor):
    """Buffers allocated (``launch_buffers``) and one launch of
    ``sort_rows_launch`` on the current stream of the keys' card, counted in
    ``sort_rows``' launch counts; raises on a launch error."""
    (r, n), p = keys.shape, payload.shape[0]
    bufs = [torch.empty(shape, dtype=dtype, device=keys.device)
            for shape, dtype in launch_buffers(r, n).values()]
    ptrs = [t.data_ptr() for t in bufs]
    ptrs += [None] * (6 - len(ptrs))  # null scratch up to CLUSTER_ELEMS
    lib = _lib()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.sort_rows_launch(keys.data_ptr(), payload.data_ptr(), *ptrs, r, n, p, stream)
    if err != 0:
        raise RuntimeError(
            f"sort_rows launch failed: {lib.sort_rows_error_string(err).decode()} ({err})"
        )
    sort_rows.launches += 1
    if n > CLUSTER_ELEMS:
        sort_rows.radix_launches += 1
    elif n > TILE_ELEMS:
        sort_rows.long_launches += 1
    return tuple(bufs[:3])
