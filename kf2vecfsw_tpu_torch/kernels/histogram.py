"""Canonical k-mer histogram: the CUDA kernel and its plain PyTorch version.

``kmer_hist(bases, offsets, k)`` counts, for each genome g of a batch laid
end to end in ``bases``, every window of k bases that are all < 4 (INVALID
bases and record separators break windows) into the bin of its canonical
code min(fwd, revcomp). It replaces the JAX package's two Pallas kernels
(``_hist_kernel_batch`` and ``_hist_kernel`` in kf2vecfsw_tpu/kernels/
histogram.py) with one hand-written kernel, ``csrc/kmer_hist.cu``.

On a CUDA tensor the wrapper launches that kernel or raises; on a CPU tensor
it runs ``kmer_hist_reference``, the same function in plain tensor ops.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..io.fasta import INVALID
from ..kmer.vocab import MAX_DENSE_K

MIN_K = 2
MAX_K = MAX_DENSE_K  # 4^13 int32 bins per genome is the largest dense row
MAX_BASES = 1 << 31  # so that no genome reaches 2^31 windows (int32 bins)


def _check(bases: torch.Tensor, offsets: torch.Tensor, k: int) -> None:
    if not MIN_K <= k <= MAX_K:
        raise ValueError(f"kmer_hist supports {MIN_K} <= k <= {MAX_K}, got k={k}")
    if bases.dtype != torch.uint8 or bases.dim() != 1 or not bases.is_contiguous():
        raise ValueError("bases must be a contiguous 1-D uint8 tensor")
    if offsets.dtype != torch.int64 or offsets.dim() != 1 or not offsets.is_contiguous():
        raise ValueError("offsets must be a contiguous 1-D int64 tensor")
    if offsets.numel() < 1:
        raise ValueError("offsets needs G + 1 >= 1 entries")
    if offsets.device != bases.device:
        raise ValueError(f"bases on {bases.device} but offsets on {offsets.device}")
    if bases.numel() >= MAX_BASES:
        raise ValueError(
            f"a batch of {bases.numel()} bases is beyond the kernel's int32 bins "
            f"(< {MAX_BASES}); count it in smaller batches"
        )


def kmer_hist_reference(bases: torch.Tensor, offsets: torch.Tensor, k: int) -> torch.Tensor:
    """Plain-ops version: codes of every window of the concatenated stream,
    windows that straddle genomes or hold an INVALID base dropped, then one
    ``bincount`` over ``g * 4^k + code``. Returns int32 (G, 4^k)."""
    g = offsets.numel() - 1
    n_bins = 4**k
    n = bases.numel() - k + 1
    if g == 0 or n <= 0:
        return torch.zeros((g, n_bins), dtype=torch.int32, device=bases.device)
    b = bases.long()
    fwd = torch.zeros(n, dtype=torch.int64, device=bases.device)
    rc = torch.zeros_like(fwd)
    valid = torch.ones(n, dtype=torch.bool, device=bases.device)
    for i in range(k):
        d = b[i : i + n]
        fwd += d << (2 * (k - 1 - i))
        rc += (3 - d) << (2 * i)
        valid &= d < INVALID
    pos = torch.arange(n, device=bases.device)
    genome = torch.searchsorted(offsets, pos, right=True) - 1
    valid &= pos + k <= offsets[genome + 1]  # the window ends inside its genome
    idx = genome * n_bins + torch.minimum(fwd, rc)
    counts = torch.bincount(idx[valid], minlength=g * n_bins)
    return counts.view(g, n_bins).to(torch.int32)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (pointers and
    the stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    from .build import load

    lib = load("kmer_hist")
    p = ctypes.c_void_p
    lib.kmer_hist_launch.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, p]
    lib.kmer_hist_launch.restype = ctypes.c_int
    lib.kmer_hist_error_string.argtypes = [ctypes.c_int]
    lib.kmer_hist_error_string.restype = ctypes.c_char_p
    lib.kmer_hist_tile_windows.argtypes = []
    lib.kmer_hist_tile_windows.restype = ctypes.c_int64
    lib.kmer_hist_span_windows.argtypes = [ctypes.c_int64]
    lib.kmer_hist_span_windows.restype = ctypes.c_int64
    return lib


def tile_windows() -> int:
    """Window starts per tile of the CUDA kernel: tiles lie on a lattice of
    this step in the batch's concatenated bases (a seam)."""
    return int(_lib().kmer_hist_tile_windows())


def span_windows(n_total: int) -> int:
    """Window starts per thread block of the CUDA kernel in a batch of
    ``n_total`` bases on the current card: block b takes the stream's
    positions [b * span, (b + 1) * span) (a seam; a whole number of tiles)."""
    span = int(_lib().kmer_hist_span_windows(n_total))
    if span < 1:
        raise RuntimeError("kmer_hist: the card's SM count could not be read")
    return span


def kmer_hist(bases: torch.Tensor, offsets: torch.Tensor, k: int) -> torch.Tensor:
    """int32 (G, 4^k) canonical k-mer counts of the G genomes
    ``bases[offsets[g]:offsets[g+1]]``. ``offsets`` must run from 0 to
    ``bases.numel()`` without decreasing (the CUDA path cannot check that
    without a device sync; ``KmerCounter`` builds it so)."""
    _check(bases, offsets, k)
    if bases.device.type == "cpu":
        return kmer_hist_reference(bases, offsets, k)
    if bases.device.type != "cuda":
        raise ValueError(f"kmer_hist runs on cuda or cpu tensors, not {bases.device}")
    g = offsets.numel() - 1
    counts = torch.zeros((g, 4**k), dtype=torch.int32, device=bases.device)
    if g == 0 or bases.numel() == 0:
        return counts  # nothing to count: no launch
    lib = _lib()
    with torch.cuda.device(bases.device):
        stream = torch.cuda.current_stream(bases.device).cuda_stream
        err = lib.kmer_hist_launch(
            bases.data_ptr(), offsets.data_ptr(), counts.data_ptr(), g, k,
            bases.numel(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"kmer_hist launch failed: {lib.kmer_hist_error_string(err).decode()} ({err})"
        )
    kmer_hist.launches += 1
    return counts


kmer_hist.launches = 0  # kernel launches in this process
