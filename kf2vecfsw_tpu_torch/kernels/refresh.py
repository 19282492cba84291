"""The shared lazy refresh's planes: the CUDA kernel and its plain PyTorch version.

``refresh_planes(ps, perm, wn, freqs, digits, group)`` computes the planes of
the shared-vocab lazy FSW route (``models.fsw.fsw_lazy_refresh``) from one
row sort of the shared (C, V) projections: for every item i and slice c,
walking slice c's sorted order p, with w_p = wn[i, perm[c, p]] and
xi = freqs[c],

    cbar_p = sum_{q <= p} w_q - w_p / 2,
    delta_p = sqrt(2) w_p cos(pi xi cbar_p) sinc(xi w_p / 2),
    g2[i, c] = sum_p ps[c, p] d delta_p / d xi,
    S[i, c, j, a] = sum_p delta_p [digit j of vocab entry perm[c, p] == a].

It replaces no Pallas kernel (the JAX package's refresh is XLA,
kf2vecfsw_tpu/models/fsw.py:337): ``csrc/lazy_refresh.cu`` fuses the
gather, the coefficients, their xi-derivative, g2 and the segment sums into
one walk that writes only S and g2.

On a CUDA tensor the wrapper launches that kernel or raises, under the span
``fsw.refresh.planes``; on a CPU tensor it runs ``refresh_planes_reference``,
the same function in plain tensor ops, in groups of ``group`` items (the
spans ``fsw.refresh.gather``, ``.jvp`` and ``.reduce`` per group).
``refresh_planes.launches`` counts the kernel's launches, one a refresh.
The coefficients' plain formula (``quantile_coefficients``) lives here too:
the exact FSW forward (``models.fsw``) uses it as well.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ..utils.phases import phase
from .sort import unsort

_SQRT2 = math.sqrt(2.0)
MAX_K = 9  # 2 bits a base in the kernel's 32-bit codes: the shared route's k
MAX_VOCAB = 1 << 18  # models.fsw.FSW_SHARED_VOCAB_MAX, the shared route's largest vocab


def quantile_coefficients(ws: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """delta = sqrt(2) w cos(pi xi cbar) sinc(xi w / 2) of sorted weights ws
    (..., N), xi broadcast against them; E = sum(ps * delta, -1). Evaluated
    so that at most three buffers of ws's size live beside ws at a time
    (cbar is dropped before the sinc; ws (xi / 2) equals (xi ws) / 2 bit for
    bit), which keeps the sliced forward's peak at its sort."""
    cos = torch.cos(math.pi * xi * (torch.cumsum(ws, dim=-1) - ws / 2.0))
    head = _SQRT2 * ws * cos
    del cos
    return head * torch.sinc(ws * (xi / 2.0))


def delta_and_gdelta(ws: torch.Tensor, freqs: torch.Tensor, xi_shape):
    """delta = quantile_coefficients(ws, xi) and d delta / d xi, by jvp."""
    return torch.func.jvp(lambda xi: quantile_coefficients(ws, xi.view(xi_shape)),
                          (freqs.detach(),), (torch.ones_like(freqs),))


def refresh_groups(n: int, group: int):
    return (slice(g0, min(g0 + max(group, 1), n)) for g0 in range(0, n, max(group, 1)))


def _check(ps, perm, wn, freqs, digits) -> None:
    for name, t, dtype in (("ps", ps, torch.float32), ("wn", wn, torch.float32),
                           ("freqs", freqs, torch.float32), ("digits", digits, torch.int64)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor")
    perm_types = (torch.int32,) if perm.device.type == "cuda" else (torch.int32, torch.int64)
    if perm.dtype not in perm_types or not perm.is_contiguous():
        raise ValueError(f"perm must be a contiguous tensor of {perm_types} on {perm.device}")
    for name, t in (("perm", perm), ("wn", wn), ("freqs", freqs), ("digits", digits)):
        if t.device != ps.device:
            raise ValueError(f"ps on {ps.device} but {name} on {t.device}")
    if ps.dim() != 2 or wn.dim() != 2 or digits.dim() != 2 or freqs.dim() != 1:
        raise ValueError("refresh_planes takes ps (C, V), perm (C, V), wn (n, V), freqs (C,) "
                         "and digits (V, k)")
    (c, v), (n, vw), k = ps.shape, wn.shape, digits.shape[1]
    if perm.shape != ps.shape or vw != v or digits.shape[0] != v or freqs.shape[0] != c:
        raise ValueError(f"shapes ps {tuple(ps.shape)}, perm {tuple(perm.shape)}, wn "
                         f"{tuple(wn.shape)}, freqs {tuple(freqs.shape)} and digits "
                         f"{tuple(digits.shape)} do not agree on C and V")
    if n < 1 or c < 1 or not 1 <= v <= MAX_VOCAB or not 1 <= k <= MAX_K:
        raise ValueError(f"refresh_planes takes n >= 1 items, C >= 1 slices, 1 <= V <= "
                         f"{MAX_VOCAB} and 1 <= k <= {MAX_K}, got {(n, c, v, k)}")


def refresh_planes_reference(ps: torch.Tensor, perm: torch.Tensor, wn: torch.Tensor,
                             freqs: torch.Tensor, digits: torch.Tensor, group: int = 8):
    """Plain-ops version, per group of ``group`` items: the sorted weights
    gathered by ``perm`` (G, C, V), delta and d delta / d xi by jvp, g2 as
    the row sum against ps, S as the unsorted delta times the (V, 4k)
    one-hot digit matrix. ``perm`` may be the sort's int32 or already int64:
    ``models.fsw.fsw_lazy_refresh`` casts it where the sort's int32 dies, so
    that the refresh holds one copy, as ``train.fsw_lazy.
    shared_refresh_bytes`` counts."""
    n, v = wn.shape
    c, k = ps.shape[0], digits.shape[1]
    perm = perm.long()
    onehot = F.one_hot(digits, 4).reshape(v, 4 * k).to(torch.float32)
    s_out, g2_out = [], []
    for rows in refresh_groups(n, group):
        with phase("fsw.refresh.gather"):
            wsb = wn[rows][:, perm]  # (G, C, V) sorted weights
        with phase("fsw.refresh.jvp"):
            delta, gdelta = delta_and_gdelta(wsb, freqs, (1, -1, 1))
        with phase("fsw.refresh.reduce"):
            g2_out.append(torch.sum(ps[None] * gdelta, dim=-1))
            s_out.append(unsort(delta, perm) @ onehot)
    return torch.cat(s_out).reshape(n, c, k, 4), torch.cat(g2_out)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (pointers and
    the stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    from .build import load

    lib = load("lazy_refresh")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.lazy_refresh_launch.argtypes = [p] * 8 + [i64, i64, i64, ctypes.c_int, i64, p]
    lib.lazy_refresh_launch.restype = ctypes.c_int
    lib.lazy_refresh_error_string.argtypes = [ctypes.c_int]
    lib.lazy_refresh_error_string.restype = ctypes.c_char_p
    lib.lazy_refresh_staged_vocab_max.argtypes = []
    lib.lazy_refresh_staged_vocab_max.restype = i64
    return lib


def record_len(v: int) -> int:
    """Entries of a slice's records in the kernel's scratch: V rounded up to
    a multiple of 32 (a warp's lanes)."""
    return 32 * -(-v // 32)


def staged_vocab_max() -> int:
    """The largest V whose four weight rows a block of the kernel stages in
    shared memory on the current card; longer rows are gathered from device
    memory."""
    got = int(_lib().lazy_refresh_staged_vocab_max())
    if got < 0:
        raise RuntimeError("lazy_refresh: the card's shared memory could not be read")
    return got


def scratch_bytes(c: int, v: int) -> int:
    """Bytes the kernel's launch allocates beyond its inputs and outputs: the
    records, three 32-bit words a sorted position."""
    return 12 * c * record_len(v)


def refresh_planes(ps: torch.Tensor, perm: torch.Tensor, wn: torch.Tensor, freqs: torch.Tensor,
                   digits: torch.Tensor, group: int = 8):
    """(S (n, C, k, 4), g2 (n, C)) of ``ps`` (C, V) sorted projections and
    ``perm`` (C, V) their int32 columns (``sort_rows``), ``wn`` (n, V)
    normalised weight rows, ``freqs`` (C,) and ``digits`` (V, k) int64 bases
    in 0..3 of the vocab. ``group`` sizes the plain version's groups only.
    On the card ``perm`` must be a permutation of each row's columns and the
    digits in range: the kernel cannot check either without a sync."""
    _check(ps, perm, wn, freqs, digits)
    if ps.device.type == "cpu":
        return refresh_planes_reference(ps, perm, wn, freqs, digits, group)
    if ps.device.type != "cuda":
        raise ValueError(f"refresh_planes runs on cuda or cpu tensors, not {ps.device}")
    (c, v), n, k = ps.shape, wn.shape[0], digits.shape[1]
    lib = _lib()
    with phase("fsw.refresh.planes"), torch.cuda.device(ps.device):
        rec = record_len(v)
        records = torch.empty((3, c, rec), dtype=torch.int32, device=ps.device)
        s = torch.empty((n, c, k, 4), dtype=torch.float32, device=ps.device)
        g2 = torch.empty((n, c), dtype=torch.float32, device=ps.device)
        stream = torch.cuda.current_stream(ps.device).cuda_stream
        err = lib.lazy_refresh_launch(
            wn.data_ptr(), ps.data_ptr(), perm.data_ptr(), digits.data_ptr(), freqs.data_ptr(),
            records.data_ptr(), s.data_ptr(), g2.data_ptr(), n, c, v, k, rec, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lazy_refresh launch failed: {lib.lazy_refresh_error_string(err).decode()} ({err})"
        )
    refresh_planes.launches += 1
    return s, g2


refresh_planes.launches = 0  # kernel launches in this process, one a refresh
