"""The shared lazy refresh's planes (``kernels.refresh.refresh_planes``) on the
CPU, where the wrapper runs its plain version.

- The plain version against a float64 reference written from the formulas
  (``tests/torch_refresh_cases.py``) at k in {3, 7} and C in {16, 128}, n
  not a multiple of the group, with a heavy item (u = xi w / 2 past the
  sinc's series) and an all-zero item, which gives S = 0 and g2 = 0.
- The wrapper refusing a wrong dtype, a wrong shape, a non-contiguous input,
  mixed devices and a device other than cuda or cpu, and counting no launch
  on the CPU.
The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``)."""

import pytest
import torch

from kf2vecfsw_tpu_torch.kernels import refresh
from kf2vecfsw_tpu_torch.kernels.refresh import (
    MAX_K,
    MAX_VOCAB,
    record_len,
    refresh_planes,
    scratch_bytes,
)
from kf2vecfsw_tpu_torch.models import fsw

from .torch_refresh_cases import plane_tolerance, planes_float64, refresh_inputs, rel_err


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
