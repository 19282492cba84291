"""The lazy refresh's planes (``kernels.refresh.refresh_planes`` and
``pergenome_planes``) on the CPU, where the wrappers run their plain versions.

- The plain version against a float64 reference written from the formulas
  (``tests/torch_refresh_cases.py``) at k in {3, 7} and C in {16, 128}, n
  not a multiple of the group, with a heavy item (u = xi w / 2 past the
  sinc's series) and an all-zero item, which gives S = 0 and g2 = 0.
- The wrapper refusing a wrong dtype, a wrong shape, a non-contiguous input,
  mixed devices and a device other than cuda or cpu, and counting no launch
  on the CPU.
- The per-genome plain version against a float64 reference at k in
  {1, 10, 31}, with zero-weight padding rows, a heavy item and an
  all-padding item (S = 0, g2 = 0); the per-genome kernel's packed codes
  round-tripping at k in {1, 10, 31}; its wrapper refusing a wrong dtype, a
  wrong shape, mixed devices and k outside 1..31 before it loads the library.
The kernels themselves run only on the card (``tests/test_torch_kernels_cuda.py``)."""

import pytest
import torch

from kf2vecfsw_tpu_torch.kernels import refresh
from kf2vecfsw_tpu_torch.defaults import MAX_K_LEN
from kf2vecfsw_tpu_torch.kernels.refresh import (
    MAX_K,
    MAX_VOCAB,
    PERGENOME_MAX_K,
    PERGENOME_TILE,
    pack_codes,
    pergenome_planes,
    pergenome_scratch_bytes,
    pergenome_tiles,
    record_len,
    refresh_planes,
    scratch_bytes,
)
from kf2vecfsw_tpu_torch.models import fsw

from .torch_refresh_cases import (
    pergenome_inputs,
    pergenome_planes_float64,
    plane_tolerance,
    planes_float64,
    refresh_inputs,
    rel_err,
)


@pytest.mark.parametrize("k,c,n,group", [(3, 16, 5, 2), (3, 128, 7, 4), (7, 16, 6, 4),
                                         (7, 128, 3, 2)])
def test_plain_version_equals_float64_reference(k, c, n, group):
    ps, perm, wn, freqs, digits = refresh_inputs(k, c, n, 100 * k + c, "cpu")
    s, g2 = refresh_planes(ps, perm, wn, freqs, digits, group)
    s64, g64 = planes_float64(ps, perm, wn, freqs, digits)
    assert s.shape == (n, c, k, 4) and g2.shape == (n, c)
    assert s.dtype == g2.dtype == torch.float32
    for i in range(n - 1):
        assert rel_err(s[i], s64[i]) <= plane_tolerance(c), i
        assert rel_err(g2[i], g64[i]) <= plane_tolerance(c), i
    assert torch.equal(s[-1], torch.zeros_like(s[-1]))  # the all-zero item
    assert torch.equal(g2[-1], torch.zeros_like(g2[-1]))


def test_plain_version_takes_the_sorts_int32_or_int64_perm():
    ps, perm, wn, freqs, digits = refresh_inputs(3, 8, 3, 5, "cpu")
    assert perm.dtype == torch.int32
    s32, g32 = refresh_planes(ps, perm, wn, freqs, digits, 2)
    s64, g64 = refresh_planes(ps, perm.long(), wn, freqs, digits, 2)
    assert torch.equal(s32, s64) and torch.equal(g32, g64)


def test_fsw_lazy_refresh_is_the_sort_then_the_planes():
    """The model's refresh hands the wrapper its sort's order: equal to the
    wrapper on the sort's outputs, bit for bit, and no kernel launch here."""
    k, c, n = 3, 8, 5
    gen = torch.Generator().manual_seed(3)
    digits = fsw.vocab_digits(k, torch.device("cpu"))
    slices, freqs = torch.randn(c, 2 * k, generator=gen), torch.arange(c).float()
    points = fsw.lookup_points(torch.randn(4, 2, generator=gen), digits)
    w = torch.rand(n, digits.shape[0], generator=gen)
    launches = refresh_planes.launches
    s, g2 = fsw.fsw_lazy_refresh(slices, freqs, points, digits, w, 2)
    wn = fsw._normalized(w)
    ps, _, perm = fsw.sort_rows((slices @ points.T).contiguous(), wn[:1])
    s_ref, g2_ref = refresh_planes(ps, perm, wn, freqs, digits, 2)
    assert torch.equal(s, s_ref) and torch.equal(g2, g2_ref)
    assert refresh_planes.launches == launches


def test_limits_agree_with_the_shared_route():
    assert MAX_VOCAB == fsw.FSW_SHARED_VOCAB_MAX
    assert MAX_K == max(k for k in range(1, 14)
                        if fsw.canonical_vocab_size(k) <= fsw.FSW_SHARED_VOCAB_MAX)
    assert [record_len(v) for v in (1, 2, 10, 32, 33, 8192, 32_896, 131_072)] == [
        32, 32, 32, 32, 64, 8192, 32_896, 131_072]
    assert scratch_bytes(512, 8192) == 12 * 512 * 8192


def _good(device="cpu"):
    c, v, n, k = 4, 32, 3, 3
    return {"ps": torch.zeros(c, v, device=device),
            "perm": torch.zeros(c, v, dtype=torch.int32, device=device),
            "wn": torch.zeros(n, v, device=device), "freqs": torch.zeros(c, device=device),
            "digits": torch.zeros(v, k, dtype=torch.int64, device=device)}


BAD = {
    "ps float64": ("ps", lambda t: t.double()),
    "perm float32": ("perm", lambda t: t.float()),
    "perm int16": ("perm", lambda t: t.short()),
    "wn float64": ("wn", lambda t: t.double()),
    "freqs float64": ("freqs", lambda t: t.double()),
    "digits int32": ("digits", lambda t: t.int()),
    "ps transposed": ("ps", lambda t: t.reshape(t.shape[1], t.shape[0]).T),
    "wn strided": ("wn", lambda t: torch.zeros(t.shape[0], 2 * t.shape[1])[:, ::2]),
    "perm strided": ("perm", lambda t: torch.zeros(t.shape[0], 2 * t.shape[1],
                                                   dtype=t.dtype)[:, ::2]),
    "digits strided": ("digits", lambda t: torch.zeros(2 * t.shape[0], t.shape[1],
                                                       dtype=t.dtype)[::2]),
    "ps one column short": ("ps", lambda t: t[:, :-1].contiguous()),
    "perm one row short": ("perm", lambda t: t[:-1].contiguous()),
    "wn one column short": ("wn", lambda t: t[:, :-1].contiguous()),
    "freqs one short": ("freqs", lambda t: t[:-1].contiguous()),
    "digits one row short": ("digits", lambda t: t[:-1].contiguous()),
    "ps 3-D": ("ps", lambda t: t[None]),
    "freqs 2-D": ("freqs", lambda t: t[None]),
    "no items": ("wn", lambda t: t[:0]),
    "k past the kernel's": ("digits", lambda t: torch.zeros(t.shape[0], MAX_K + 1,
                                                            dtype=t.dtype)),
    "wn on another device": ("wn", lambda t: t.to("meta")),
    "perm on another device": ("perm", lambda t: t.to("meta")),
    "digits on another device": ("digits", lambda t: t.to("meta")),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_refuses(case):
    args = _good()
    name, change = BAD[case]
    args[name] = change(args[name])
    with pytest.raises(ValueError):
        refresh_planes(**args)


def test_wrapper_refuses_a_vocab_past_the_shared_route():
    c, v = 2, MAX_VOCAB + 1
    args = {"ps": torch.empty(c, v, device="meta"),
            "perm": torch.empty(c, v, dtype=torch.int32, device="meta"),
            "wn": torch.empty(1, v, device="meta"), "freqs": torch.empty(c, device="meta"),
            "digits": torch.empty(v, 9, dtype=torch.int64, device="meta")}
    with pytest.raises(ValueError, match="V <="):
        refresh_planes(**args)


def test_wrapper_refuses_a_device_other_than_cuda_or_cpu():
    with pytest.raises(ValueError, match="cuda or cpu"):
        refresh_planes(**_good("meta"))


def test_wrapper_checks_before_loading_the_kernel(monkeypatch):
    """A refused input never reaches the library (none is built here)."""
    monkeypatch.setattr(refresh, "_lib", lambda: pytest.fail("the library was loaded"))
    args = _good()
    args["ps"] = args["ps"].double()
    with pytest.raises(ValueError):
        refresh_planes(**args)
    refresh_planes(**_good())  # the CPU runs the plain version


# (G, C, N, k, real points an item): padding past the real points, k = 1,
# 10 and 31, a heavy item and an all-padding item at G = 3
PERGENOME_CASES = [(1, 16, 300, 10, 230), (3, 8, 500, 1, 400), (3, 16, 200, 31, 200),
                   (2, 4, 5000, 10, 4000)]


@pytest.mark.parametrize("g,c,n,k,real", PERGENOME_CASES)
def test_pergenome_plain_version_equals_float64_reference(g, c, n, k, real):
    inputs = pergenome_inputs(g, c, n, k, 10 * n + k, "cpu", real)
    launches = pergenome_planes.launches
    s, g2 = pergenome_planes(*inputs)
    s64, g64 = pergenome_planes_float64(*inputs)
    assert s.shape == (g, c, k, 4) and g2.shape == (g, c)
    assert s.dtype == g2.dtype == torch.float32
    for i in range(g - 1 if g > 1 else g):
        assert rel_err(s[i], s64[i]) <= plane_tolerance(c), i
        assert rel_err(g2[i], g64[i]) <= plane_tolerance(c), i
    if g > 1:  # the all-padding item
        assert torch.equal(s[-1], torch.zeros_like(s[-1]))
        assert torch.equal(g2[-1], torch.zeros_like(g2[-1]))
    assert pergenome_planes.launches == launches


@pytest.mark.parametrize("k", [1, 10, 31])
def test_packed_codes_round_trip(k):
    digits = torch.randint(0, 4, (3, 257, k), generator=torch.Generator().manual_seed(k))
    digits[0, 0] = 3  # every bit: the largest code, 4^k - 1 (2^62 - 1 at k = 31)
    codes = pack_codes(digits)
    assert codes.dtype == torch.int64 and codes.shape == (3, 257)
    assert int(codes[0, 0]) == 4**k - 1 and int(codes.min()) >= 0
    assert torch.equal((codes[..., None] >> (2 * torch.arange(k))) & 3, digits)


def test_pergenome_limits():
    assert PERGENOME_MAX_K == MAX_K_LEN
    assert [pergenome_tiles(n) for n in (1, 4095, 4096, 4097, 646_000)] == [1, 1, 1, 2, 158]
    assert PERGENOME_TILE == 4096
    # the cell's group: 5.2 MB of codes, 512 x 158 tiles of a double and 32 floats
    assert pergenome_scratch_bytes(1, 512, 646_000, 10) == 8 * 646_000 + 512 * 158 * (8 + 4 * 32)


def _good_pergenome(device="cpu"):
    g, c, n, k = 2, 3, 40, 5
    return {"ps": torch.zeros(g * c, n, device=device), "ws": torch.zeros(g * c, n, device=device),
            "perm": torch.zeros(g * c, n, dtype=torch.int32, device=device),
            "digits": torch.zeros(g, n, k, dtype=torch.int64, device=device),
            "freqs": torch.zeros(c, device=device)}


BAD_PERGENOME = {
    "ps float64": ("ps", lambda t: t.double()),
    "ws float64": ("ws", lambda t: t.double()),
    "perm int64": ("perm", lambda t: t.long()),
    "digits int32": ("digits", lambda t: t.int()),
    "freqs float64": ("freqs", lambda t: t.double()),
    "ws strided": ("ws", lambda t: torch.zeros(t.shape[0], 2 * t.shape[1])[:, ::2]),
    "digits strided": ("digits", lambda t: torch.zeros(t.shape[0], 2 * t.shape[1], t.shape[2],
                                                       dtype=t.dtype)[:, ::2]),
    "ws one column short": ("ws", lambda t: t[:, :-1].contiguous()),
    "perm one row short": ("perm", lambda t: t[:-1].contiguous()),
    "digits one point short": ("digits", lambda t: t[:, :-1].contiguous()),
    "digits one item short": ("digits", lambda t: t[:-1].contiguous()),
    "freqs one short": ("freqs", lambda t: t[:-1].contiguous()),
    "ps 3-D": ("ps", lambda t: t[None]),
    "digits 2-D": ("digits", lambda t: t[0]),
    "k of 0": ("digits", lambda t: t[..., :0].contiguous()),
    "k past 31": ("digits", lambda t: torch.zeros(*t.shape[:2], PERGENOME_MAX_K + 1,
                                                   dtype=t.dtype)),
    "ws on another device": ("ws", lambda t: t.to("meta")),
    "perm on another device": ("perm", lambda t: t.to("meta")),
    "digits on another device": ("digits", lambda t: t.to("meta")),
    "freqs on another device": ("freqs", lambda t: t.to("meta")),
}


@pytest.mark.parametrize("case", sorted(BAD_PERGENOME))
def test_pergenome_wrapper_refuses(case):
    args = _good_pergenome()
    name, change = BAD_PERGENOME[case]
    args[name] = change(args[name])
    with pytest.raises(ValueError):
        pergenome_planes(**args)


def test_pergenome_wrapper_refuses_a_device_other_than_cuda_or_cpu():
    with pytest.raises(ValueError, match="cuda or cpu"):
        pergenome_planes(**_good_pergenome("meta"))


def test_pergenome_wrapper_checks_before_loading_the_kernel(monkeypatch):
    """A refused input never reaches the library (none is built here)."""
    monkeypatch.setattr(refresh, "_lib", lambda: pytest.fail("the library was loaded"))
    for case in ("ps float64", "k past 31", "digits on another device"):
        args = _good_pergenome()
        name, change = BAD_PERGENOME[case]
        args[name] = change(args[name])
        with pytest.raises(ValueError):
            pergenome_planes(**args)
    pergenome_planes(**_good_pergenome())  # the CPU runs the plain version
