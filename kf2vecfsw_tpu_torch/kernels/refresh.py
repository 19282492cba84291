"""The lazy refresh's planes: the CUDA kernels and their plain PyTorch versions.

``refresh_planes(ps, perm, wn, freqs, digits, group)`` computes the planes of
the shared-vocab lazy FSW route (``models.fsw.fsw_lazy_refresh``) from one
row sort of the shared (C, V) projections: for every item i and slice c,
walking slice c's sorted order p, with w_p = wn[i, perm[c, p]] and
xi = freqs[c],

    cbar_p = sum_{q <= p} w_q - w_p / 2,
    delta_p = sqrt(2) w_p cos(pi xi cbar_p) sinc(xi w_p / 2),
    g2[i, c] = sum_p ps[c, p] d delta_p / d xi,
    S[i, c, j, a] = sum_p delta_p [digit j of vocab entry perm[c, p] == a].

``pergenome_planes(ps, ws, perm, digits, freqs)`` computes the same planes
on the per-genome route (``models.fsw.fsw_lazy_refresh_pergenome``), where
each of G items owns its N points: from the sort of the G*C projection rows
(row g*C + c: item g, slice c) with their sorted weights ws, w_p =
ws[g*C + c, p] and the bases digits[g, perm[g*C + c, p]].

Neither replaces a Pallas kernel (the JAX package's refreshes are XLA,
kf2vecfsw_tpu/models/fsw.py:337 and :468): ``csrc/lazy_refresh.cu`` fuses
the coefficients, their xi-derivative, g2 and the segment sums into walks
that write only S and g2 (and, per genome, each tile's sums), with one entry
point a route: the shared route's many items over one order, the per-genome
route's few long rows.

On a CUDA tensor each wrapper launches its kernel or raises, under the span
``fsw.refresh.planes``; on a CPU tensor it runs its plain version
(``refresh_planes_reference`` in groups of ``group`` items with the spans
``fsw.refresh.gather``, ``.jvp`` and ``.reduce`` per group;
``pergenome_planes_reference`` with the spans ``.jvp`` and ``.reduce``).
``refresh_planes.launches`` counts the shared kernel's launches, one a
refresh; ``pergenome_planes.launches`` the per-genome kernel's, one a
refresh group. The coefficients' plain formula (``quantile_coefficients``)
lives here too: the exact FSW forward (``models.fsw``) runs it on the CPU.

The exact forwards' coefficients on the card, from the same source: for row
r (item b, slice c) of a sort, its sorted projections ps and weights, xi =
freqs[c] and the cotangent gE[b, c],

    forward:  E[b, c] = sum_p ps[r, p] delta_p,
    backward: d_ps[r, p] = gE[b, c] delta_p,
              d_xi[c] = sum_b gE[b, c] sum_p ps[r, p] d delta_p / d xi,

the weights getting no gradient. ``exact_coefficients`` and
``exact_coefficients_grad`` take the per-genome route's (B*C, N) rows (row
b*C + c, each item its own weights; the backward reuses the forward's tile
sums), ``exact_coefficients_shared`` and ``exact_coefficients_shared_grad``
the shared route's (C, V) rows with ``perm`` and the items' (n, V) weights
(d_ps summed over the items). They run on CUDA tensors only, and raise on
any other or on one they cannot take: their plain versions are
``exact_coefficients_reference`` and ``exact_coefficients_grad_reference``,
and the CPU's exact forward is the plain chain. ``exact_coefficients.
launches`` counts the four entry points' calls, forward or backward.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ..utils.phases import phase
from .sort import MAX_N, unsort

_SQRT2 = math.sqrt(2.0)
MAX_K = 9  # 2 bits a base in the kernel's 32-bit codes: the shared route's k
MAX_VOCAB = 1 << 18  # models.fsw.FSW_SHARED_VOCAB_MAX, the shared route's largest vocab
PERGENOME_MAX_K = 31  # 2 bits a base in the per-genome kernel's 64-bit codes: defaults.MAX_K_LEN
PERGENOME_TILE = 4096  # kPgTile of csrc/lazy_refresh.cu: the positions of a tile of a row
EXACT_SHARED_TILE = 512  # kExTile of csrc/lazy_refresh.cu: a shared-route tile's positions


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


def exact_coefficients_reference(ps: torch.Tensor, ws: torch.Tensor,
                                 freqs: torch.Tensor) -> torch.Tensor:
    """Plain-ops version of the exact forwards' coefficients: E (B, C) = sum_p
    ps delta over sorted weights ws (B, C, N), freqs (C,) and sorted
    projections ps (B, C, N), or (C, N) shared by every item."""
    return torch.sum(ps * quantile_coefficients(ws, freqs[:, None]), dim=-1)


def exact_coefficients_grad_reference(ps: torch.Tensor, ws: torch.Tensor, freqs: torch.Tensor,
                                      grad: torch.Tensor):
    """Plain-ops version of their backward for the cotangent grad (B, C):
    (d_ps, d_xi), d_ps = grad delta in ps's shape (summed over the items
    where ps is shared) and d_xi[c] = sum_b grad[b, c] sum_p ps d delta /
    d xi, the derivative by jvp."""
    delta, gdelta = delta_and_gdelta(ws, freqs, (-1, 1))
    d_ps = (grad[..., None] * delta).sum_to_size(ps.shape)
    return d_ps, torch.sum(grad * torch.sum(ps * gdelta, dim=-1), dim=0)


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
    lib.lazy_refresh_pergenome_launch.argtypes = [p] * 10 + [i64, i64, i64, ctypes.c_int, i64, p]
    lib.lazy_refresh_pergenome_launch.restype = ctypes.c_int
    lib.lazy_refresh_pergenome_tile.argtypes = []
    lib.lazy_refresh_pergenome_tile.restype = i64
    lib.lazy_refresh_exact_rows_launch.argtypes = [p] * 8 + [i64] * 4 + [p]
    lib.lazy_refresh_exact_rows_launch.restype = ctypes.c_int
    lib.lazy_refresh_exact_shared_tile.argtypes = []
    lib.lazy_refresh_exact_shared_tile.restype = i64
    lib.lazy_refresh_exact_shared_scratch.argtypes = [i64] * 3
    lib.lazy_refresh_exact_shared_scratch.restype = i64
    lib.lazy_refresh_exact_shared_launch.argtypes = [p] * 8 + [i64] * 4 + [p]
    lib.lazy_refresh_exact_shared_launch.restype = ctypes.c_int
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


def pack_codes(digits: torch.Tensor) -> torch.Tensor:
    """(..., ) int64 codes of (..., k) int64 bases in 0..3, base j in bits 2j
    and 2j + 1: the plain version of the per-genome kernel's code table."""
    shifts = 2 * torch.arange(digits.shape[-1], device=digits.device)
    return ((digits & 3) << shifts).sum(-1)


def pergenome_tiles(n: int) -> int:
    """Tiles of a row of N positions in the per-genome kernel."""
    return -(-n // PERGENOME_TILE)


def pergenome_tile() -> int:
    """The per-genome kernel's tile (``PERGENOME_TILE``, the host's copy,
    which the card-only tests hold to it)."""
    return int(_lib().lazy_refresh_pergenome_tile())


def pergenome_scratch_bytes(g: int, c: int, n: int, k: int) -> int:
    """Bytes a per-genome launch allocates beyond its inputs and outputs:
    the code table (8 B a point), and for each tile its weights' sum in
    double and its 3k + 2 float sums."""
    tiles = g * c * pergenome_tiles(n)
    return 8 * g * n + 8 * tiles + 4 * (3 * k + 2) * tiles


def _check_pergenome(ps, ws, perm, digits, freqs) -> None:
    for name, t, dtype in (("ps", ps, torch.float32), ("ws", ws, torch.float32),
                           ("perm", perm, torch.int32), ("digits", digits, torch.int64),
                           ("freqs", freqs, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor")
    for name, t in (("ws", ws), ("perm", perm), ("digits", digits), ("freqs", freqs)):
        if t.device != ps.device:
            raise ValueError(f"ps on {ps.device} but {name} on {t.device}")
    if ps.dim() != 2 or digits.dim() != 3 or freqs.dim() != 1:
        raise ValueError("pergenome_planes takes ps, ws and perm (G*C, N), digits (G, N, k) "
                         "and freqs (C,)")
    (rows, n), (g, nd, k), c = ps.shape, digits.shape, freqs.shape[0]
    if ws.shape != ps.shape or perm.shape != ps.shape or nd != n or rows != g * c:
        raise ValueError(f"shapes ps {tuple(ps.shape)}, ws {tuple(ws.shape)}, perm "
                         f"{tuple(perm.shape)}, digits {tuple(digits.shape)} and freqs "
                         f"{tuple(freqs.shape)} do not agree on G, C and N")
    if g < 1 or c < 1 or not 1 <= n <= MAX_N or not 1 <= k <= PERGENOME_MAX_K:
        raise ValueError(f"pergenome_planes takes G >= 1 items, C >= 1 slices, 1 <= N <= "
                         f"{MAX_N} and 1 <= k <= {PERGENOME_MAX_K}, got {(g, c, n, k)}")


def pergenome_planes_reference(ps: torch.Tensor, ws: torch.Tensor, perm: torch.Tensor,
                               digits: torch.Tensor, freqs: torch.Tensor):
    """Plain-ops version: delta and d delta / d xi by jvp over the (G, C, N)
    sorted weights, g2 as the row sum against ps, S as the unsorted delta
    times each item's (N, 4k) one-hot digit matrix. It drops ws once the jvp
    is done and ps once g2 is; where it holds the only references (as
    ``pergenome_planes`` hands them on) that frees them, as ``train.
    fsw_lazy.pergenome_refresh_bytes`` counts."""
    g, n, k = digits.shape
    c = freqs.shape[0]
    ps, ws, perm = ps.view(g, c, n), ws.view(g, c, n), perm.view(g, c, n)
    with phase("fsw.refresh.jvp"):
        delta, gdelta = delta_and_gdelta(ws, freqs, (1, -1, 1))
    del ws
    with phase("fsw.refresh.reduce"):
        g2 = torch.sum(ps * gdelta, dim=-1)
        del ps, gdelta
        onehot = F.one_hot(digits, 4).reshape(g, n, 4 * k).to(torch.float32)
        s = torch.bmm(unsort(delta, perm), onehot)
    return s.reshape(g, c, k, 4), g2


def _released(held: list) -> tuple:
    """The items of ``held``, the list emptied: passed on as a call's
    arguments they are the callee's only references."""
    out = tuple(held)
    held.clear()
    return out


def pergenome_planes(ps: torch.Tensor, ws: torch.Tensor, perm: torch.Tensor,
                     digits: torch.Tensor, freqs: torch.Tensor):
    """(S (G, C, k, 4), g2 (G, C)) of one per-genome refresh group from its
    ``sort_rows``: ``ps`` and ``ws`` (G*C, N) the sorted projections and
    weights (row g*C + c: item g, slice c), ``perm`` (G*C, N) their int32
    columns, ``digits`` (G, N, k) int64 bases in 0..3 of each item's points
    and ``freqs`` (C,). On the card ``perm`` must index each row's points
    and the digits be in range: the kernel cannot check either without a
    sync."""
    _check_pergenome(ps, ws, perm, digits, freqs)
    if ps.device.type == "cpu":
        held = [ps, ws, perm]
        del ps, ws, perm  # the plain version frees ws and ps once spent
        return pergenome_planes_reference(*_released(held), digits, freqs)
    if ps.device.type != "cuda":
        raise ValueError(f"pergenome_planes runs on cuda or cpu tensors, not {ps.device}")
    (g, n, k), c = digits.shape, freqs.shape[0]
    tiles = pergenome_tiles(n)
    lib = _lib()
    with phase("fsw.refresh.planes"), torch.cuda.device(ps.device):
        dev = ps.device
        codes = torch.empty((g, n), dtype=torch.int64, device=dev)
        tile_sums = torch.empty((g * c, tiles), dtype=torch.float64, device=dev)
        partials = torch.empty((g * c, tiles, 3 * k + 2), dtype=torch.float32, device=dev)
        s = torch.empty((g, c, k, 4), dtype=torch.float32, device=dev)
        g2 = torch.empty((g, c), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lazy_refresh_pergenome_launch(
            ps.data_ptr(), ws.data_ptr(), perm.data_ptr(), digits.data_ptr(), freqs.data_ptr(),
            codes.data_ptr(), tile_sums.data_ptr(), partials.data_ptr(), s.data_ptr(),
            g2.data_ptr(), g, c, n, k, tiles, stream,
        )
    if err != 0:
        raise RuntimeError(f"lazy_refresh_pergenome launch failed: "
                           f"{lib.lazy_refresh_error_string(err).decode()} ({err})")
    pergenome_planes.launches += 1
    return s, g2


pergenome_planes.launches = 0  # kernel launches in this process, one a refresh group


# -- the exact forwards' coefficients -------------------------------------------


def exact_shared_tile() -> int:
    """The shared-route kernel's tile (``EXACT_SHARED_TILE``, the host's copy,
    which the card-only tests hold to it)."""
    return int(_lib().lazy_refresh_exact_shared_tile())


def exact_rows_scratch_bytes(rows: int, n: int) -> int:
    """Bytes a per-genome launch allocates beyond its inputs and outputs: for
    each tile its weights' sum in double (the forward's, kept for the
    backward) and its float partial."""
    return 12 * rows * pergenome_tiles(n)


def exact_shared_scratch_bytes(n: int, c: int, v: int) -> int:
    """Bytes a shared-route launch allocates beyond its inputs and outputs on
    the current card: none where its blocks stage the weights, else each
    tile's weights of each item in double."""
    got = int(_lib().lazy_refresh_exact_shared_scratch(n, c, v))
    if got < 0:
        raise RuntimeError("lazy_refresh: the card's shared memory could not be read")
    return 8 * got


def _check_tensors(fn: str, tensors: dict) -> None:
    """Every tensor contiguous, of its dtype, on one device."""
    first = next(iter(tensors.values()))[0]
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor")
        if t.device != first.device:
            raise ValueError(f"{fn}: tensors on {first.device} and {name} on {t.device}")


def _check_card(fn: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda tensors, not {t.device}: the CPU's exact "
                         "forward is the plain chain (models.fsw)")


def _check_rows(ps, ws, freqs, grad=None, tile_sums=None) -> None:
    tensors = {"ps": (ps, torch.float32), "ws": (ws, torch.float32),
               "freqs": (freqs, torch.float32)}
    if grad is not None:
        tensors.update(grad=(grad, torch.float32), tile_sums=(tile_sums, torch.float64))
    _check_tensors("exact_coefficients", tensors)
    if ps.dim() != 2 or freqs.dim() != 1 or ws.shape != ps.shape:
        raise ValueError(f"exact_coefficients takes ps and ws (B*C, N) and freqs (C,), got "
                         f"{tuple(ps.shape)}, {tuple(ws.shape)} and {tuple(freqs.shape)}")
    (rows, n), c = ps.shape, freqs.shape[0]
    if c < 1 or rows < 1 or rows % c or not 1 <= n <= MAX_N:
        raise ValueError(f"exact_coefficients takes B*C >= 1 rows of 1 <= N <= {MAX_N} over C "
                         f">= 1 slices, got {rows} rows of {n} and {c} slices")
    if grad is not None and (grad.shape != (rows // c, c)
                             or tile_sums.shape != (rows, pergenome_tiles(n))):
        raise ValueError(f"grad {tuple(grad.shape)} and tile_sums {tuple(tile_sums.shape)} do "
                         f"not fit {rows} rows of {n} over {c} slices")
    _check_card("exact_coefficients", ps)


def _check_shared(ps, perm, wn, freqs, grad=None) -> None:
    tensors = {"ps": (ps, torch.float32), "perm": (perm, torch.int32),
               "wn": (wn, torch.float32), "freqs": (freqs, torch.float32)}
    if grad is not None:
        tensors["grad"] = (grad, torch.float32)
    _check_tensors("exact_coefficients_shared", tensors)
    if ps.dim() != 2 or wn.dim() != 2 or freqs.dim() != 1:
        raise ValueError("exact_coefficients_shared takes ps and perm (C, V), wn (n, V) and "
                         "freqs (C,)")
    (c, v), n = ps.shape, wn.shape[0]
    if perm.shape != ps.shape or wn.shape[1] != v or freqs.shape[0] != c or (
            grad is not None and grad.shape != (n, c)):
        raise ValueError(f"shapes ps {tuple(ps.shape)}, perm {tuple(perm.shape)}, wn "
                         f"{tuple(wn.shape)}, freqs {tuple(freqs.shape)} and grad "
                         f"{None if grad is None else tuple(grad.shape)} do not agree")
    if n < 1 or c < 1 or not 1 <= v <= MAX_VOCAB:
        raise ValueError(f"exact_coefficients_shared takes n >= 1 items, C >= 1 slices and "
                         f"1 <= V <= {MAX_VOCAB}, got {(n, c, v)}")
    _check_card("exact_coefficients_shared", ps)


def _launched(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           f"{_lib().lazy_refresh_error_string(err).decode()} ({err})")
    exact_coefficients.launches += 1


def _rows_launch(ps, ws, freqs, grad, tile_sums, d_ps, out) -> None:
    (rows, n), c = ps.shape, freqs.shape[0]
    tiles = pergenome_tiles(n)
    with torch.cuda.device(ps.device):
        partials = torch.empty((rows, tiles), dtype=torch.float32, device=ps.device)
        err = _lib().lazy_refresh_exact_rows_launch(
            ps.data_ptr(), ws.data_ptr(), freqs.data_ptr(),
            None if grad is None else grad.data_ptr(), tile_sums.data_ptr(), partials.data_ptr(),
            None if d_ps is None else d_ps.data_ptr(), out.data_ptr(), rows, c, n, tiles,
            torch.cuda.current_stream(ps.device).cuda_stream,
        )
    _launched(err, "exact_coefficients")


def exact_coefficients(ps: torch.Tensor, ws: torch.Tensor, freqs: torch.Tensor):
    """(E (B, C), tile_sums) of the per-genome route's sort: ``ps`` and ``ws``
    (B*C, N) the sorted projections and weights (row b*C + c: item b, slice
    c), ``freqs`` (C,). ``tile_sums`` (B*C, tiles) f64, each tile's weights,
    is the backward's."""
    _check_rows(ps, ws, freqs)
    (rows, n), c = ps.shape, freqs.shape[0]
    tile_sums = torch.empty((rows, pergenome_tiles(n)), dtype=torch.float64, device=ps.device)
    e = torch.empty((rows // c, c), dtype=torch.float32, device=ps.device)
    _rows_launch(ps, ws, freqs, None, tile_sums, None, e)
    return e, tile_sums


def exact_coefficients_grad(ps: torch.Tensor, ws: torch.Tensor, freqs: torch.Tensor,
                            tile_sums: torch.Tensor, grad: torch.Tensor):
    """(d_ps (B*C, N), d_xi (C,)) of ``exact_coefficients``' E for the
    cotangent ``grad`` (B, C), from its inputs and ``tile_sums``."""
    _check_rows(ps, ws, freqs, grad, tile_sums)
    d_ps = torch.empty_like(ps)
    d_xi = torch.empty_like(freqs)
    _rows_launch(ps, ws, freqs, grad, tile_sums, d_ps, d_xi)
    return d_ps, d_xi


def _shared_launch(ps, perm, wn, freqs, grad, d_ps, out) -> None:
    (c, v), n = ps.shape, wn.shape[0]
    with torch.cuda.device(ps.device):
        entries = exact_shared_scratch_bytes(n, c, v) // 8
        scratch = (torch.empty(entries, dtype=torch.float64, device=ps.device)
                   if entries else None)
        err = _lib().lazy_refresh_exact_shared_launch(
            ps.data_ptr(), perm.data_ptr(), wn.data_ptr(), freqs.data_ptr(),
            None if grad is None else grad.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if d_ps is None else d_ps.data_ptr(), out.data_ptr(), n, c, v, entries,
            torch.cuda.current_stream(ps.device).cuda_stream,
        )
    _launched(err, "exact_coefficients_shared")


def exact_coefficients_shared(ps: torch.Tensor, perm: torch.Tensor, wn: torch.Tensor,
                              freqs: torch.Tensor) -> torch.Tensor:
    """E (n, C) of the shared route's sort: ``ps`` (C, V) the sorted
    projections, ``perm`` (C, V) their int32 columns, ``wn`` (n, V) the
    items' normalised weights, ``freqs`` (C,). ``perm`` must be a
    permutation of each row's columns: the kernel cannot check it without a
    sync."""
    _check_shared(ps, perm, wn, freqs)
    e = torch.empty((wn.shape[0], ps.shape[0]), dtype=torch.float32, device=ps.device)
    _shared_launch(ps, perm, wn, freqs, None, None, e)
    return e


def exact_coefficients_shared_grad(ps: torch.Tensor, perm: torch.Tensor, wn: torch.Tensor,
                                   freqs: torch.Tensor, grad: torch.Tensor):
    """(d_ps (C, V), d_xi (C,)) of ``exact_coefficients_shared``' E for the
    cotangent ``grad`` (n, C), d_ps summed over the items."""
    _check_shared(ps, perm, wn, freqs, grad)
    d_ps = torch.empty_like(ps)
    d_xi = torch.empty_like(freqs)
    _shared_launch(ps, perm, wn, freqs, grad, d_ps, d_xi)
    return d_ps, d_xi


exact_coefficients.launches = 0  # calls of the four entry points in this process
