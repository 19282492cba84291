"""The exact forwards' coefficients (``kernels.refresh.exact_coefficients``
and its shared and backward entry points) on the CPU, where no kernel runs.

- The plain version of the kernels' formulas (forward E = sum_p ps delta;
  backward d_ps = gE delta, summed over the items where ps is shared, and
  d_xi = sum_b gE sum_p ps d delta / d xi) against autograd of
  ``quantile_coefficients`` in float64, per genome with zero-weight padding
  runs and an all-padding item, and shared with absent k-mers and an
  all-zero item; in float32 within the planes' tolerance of float64.
- ``models.fsw``'s autograd Functions over those formulas in place of the
  kernels: gradcheck in float64, the span ``fsw.exact.coefficients`` and
  the counters ``fsw.exact.coefficients.forward`` and ``.backward`` under
  autograd only, ps and xi taking gradients and the weights none.
- The wrappers refusing a CPU tensor, a wrong dtype, a wrong shape, a
  non-contiguous input and mixed devices before they load the library; the
  CPU's exact forwards launching nothing.
The kernels themselves run only on the card (``tests/test_torch_kernels_cuda.py``)."""

import pytest
import torch

from kf2vecfsw_tpu_torch.kernels import refresh
from kf2vecfsw_tpu_torch.kernels.refresh import (
    EXACT_SHARED_TILE,
    PERGENOME_TILE,
    exact_coefficients,
    exact_coefficients_grad,
    exact_coefficients_grad_reference,
    exact_coefficients_reference,
    exact_coefficients_shared,
    exact_coefficients_shared_grad,
    exact_rows_scratch_bytes,
    quantile_coefficients,
)
from kf2vecfsw_tpu_torch.models import fsw
from kf2vecfsw_tpu_torch.utils import phases

from .torch_refresh_cases import pergenome_inputs, plane_tolerance, refresh_inputs, rel_err


def _autograd(ps, ws, freqs, grad):
    """(E, d_ps, d_xi) by autograd of the plain chain: the sum of ps times
    ``quantile_coefficients``, ps (B, C, N) or (C, N) shared."""
    ps = ps.detach().clone().requires_grad_()
    xi = freqs.detach().clone().requires_grad_()
    e = torch.sum((ps if ps.dim() == 3 else ps[None])
                  * quantile_coefficients(ws, xi[None, :, None]), dim=-1)
    e.backward(grad)
    return e.detach(), ps.grad, xi.grad


def _pergenome(g, c, n, real, seed):
    ps, ws, _, _, freqs = pergenome_inputs(g, c, n, 1, seed, "cpu", real=real)
    grad = torch.randn(g, c, generator=torch.Generator().manual_seed(seed))
    return ps.view(g, c, n), ws.view(g, c, n), freqs, grad


def _shared(k, c, n, seed):
    ps, perm, wn, freqs, _ = refresh_inputs(k, c, n, seed, "cpu")
    grad = torch.randn(n, c, generator=torch.Generator().manual_seed(seed))
    return ps, wn[:, perm.long()], freqs, grad


# (G, C, N, real points an item): padding past the real points (one run:
# the padding rows are one point), a heavy item and an all-padding item at G = 3
PERGENOME_CASES = [(1, 8, 300, 230), (3, 16, 500, 400), (3, 4, PERGENOME_TILE + 1, 3000)]
SHARED_CASES = [(3, 16, 5), (5, 8, 3), (3, 4, 2)]


def _cases():
    for g, c, n, real in PERGENOME_CASES:
        yield f"pergenome-{g}x{c}x{n}", lambda g=g, c=c, n=n, real=real: _pergenome(
            g, c, n, real, 7 * n + g)
    for k, c, n in SHARED_CASES:
        yield f"shared-k{k}-{c}x{n}", lambda k=k, c=c, n=n: _shared(k, c, n, 100 * k + c)


CASES = dict(_cases())


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_formulas_equal_autograd_in_float64(case):
    """E, d_ps and d_xi of the formulas the kernels implement equal autograd
    of the plain chain in float64, to float64 rounding."""
    ps, ws, freqs, grad = (t.double() for t in CASES[case]())
    e, d_ps, d_xi = _autograd(ps, ws, freqs, grad)
    assert torch.allclose(exact_coefficients_reference(ps, ws, freqs), e, rtol=1e-12, atol=1e-14)
    got_ps, got_xi = exact_coefficients_grad_reference(ps, ws, freqs, grad)
    assert got_ps.shape == ps.shape and got_xi.shape == freqs.shape
    assert torch.allclose(got_ps, d_ps, rtol=1e-12, atol=1e-14)
    assert torch.allclose(got_xi, d_xi, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_formulas_in_float32_within_the_planes_tolerance(case):
    """In float32 (the card's precision) each item's E and d_ps, and d_xi,
    within ``plane_tolerance`` of float64; an all-zero item's E and d_ps are
    exactly zero."""
    ps, ws, freqs, grad = CASES[case]()
    c = freqs.shape[0]
    e, (d_ps, d_xi) = (exact_coefficients_reference(ps, ws, freqs),
                       exact_coefficients_grad_reference(ps, ws, freqs, grad))
    e64 = exact_coefficients_reference(ps.double(), ws.double(), freqs.double())
    d_ps64, d_xi64 = exact_coefficients_grad_reference(ps.double(), ws.double(),
                                                       freqs.double(), grad.double())
    items = ws.shape[0]
    last_zero = bool(items > 1 and not ws[-1].any())
    for i in range(items - last_zero):
        assert rel_err(e[i], e64[i]) <= plane_tolerance(c), i
        if ps.dim() == 3:
            assert rel_err(d_ps[i], d_ps64[i]) <= plane_tolerance(c), i
    if ps.dim() == 2:
        assert rel_err(d_ps, d_ps64) <= plane_tolerance(c)
    assert rel_err(d_xi, d_xi64) <= plane_tolerance(c)
    if last_zero:
        assert torch.equal(e[-1], torch.zeros_like(e[-1]))
        if ps.dim() == 3:
            assert torch.equal(d_ps[-1], torch.zeros_like(d_ps[-1]))


def _fake_kernels(monkeypatch, calls):
    """``models.fsw``'s kernel entry points replaced by the plain formulas on
    the CPU (the per-genome rows viewed as (B, C, N)), counting calls."""

    def rows(ps, ws, xi):
        calls.append("rows")
        v = (-1, xi.shape[0], ps.shape[1])
        return exact_coefficients_reference(ps.view(v), ws.view(v), xi), torch.zeros(1)

    def rows_grad(ps, ws, xi, tile_sums, g):
        calls.append("rows_grad")
        v = (-1, xi.shape[0], ps.shape[1])
        d_ps, d_xi = exact_coefficients_grad_reference(ps.view(v), ws.view(v), xi, g)
        return d_ps.reshape(ps.shape), d_xi

    def shared(ps, perm, wn, xi):
        calls.append("shared")
        return exact_coefficients_reference(ps, wn[:, perm.long()], xi)

    def shared_grad(ps, perm, wn, xi, g):
        calls.append("shared_grad")
        return exact_coefficients_grad_reference(ps, wn[:, perm.long()], xi, g)

    for name, fn in (("exact_coefficients", rows), ("exact_coefficients_grad", rows_grad),
                     ("exact_coefficients_shared", shared),
                     ("exact_coefficients_shared_grad", shared_grad)):
        monkeypatch.setattr(fsw, name, fn)


@pytest.mark.parametrize("shared", [False, True])
def test_autograd_functions_pass_gradcheck(monkeypatch, shared):
    """``CoefficientsPW`` and ``CoefficientsShared`` over the plain formulas:
    their backward is the derivative of their forward in ps and xi (float64
    gradcheck), the weights and perm taking none."""
    calls = []
    _fake_kernels(monkeypatch, calls)
    gen = torch.Generator().manual_seed(3)
    c, n, b = 3, 7, 2
    xi = torch.tensor([0.0, 2.0, 5.0], dtype=torch.float64, requires_grad=True)
    w = torch.rand(b, n, generator=gen, dtype=torch.float64)
    w[0, -2:] = 0.0  # padding
    wn = w / w.sum(-1, keepdim=True)
    if shared:
        ps = torch.sort(torch.randn(c, n, generator=gen, dtype=torch.float64), -1).values
        perm = torch.stack([torch.randperm(n, generator=gen) for _ in range(c)]).int()
        ps.requires_grad_()
        assert torch.autograd.gradcheck(
            lambda p, x: fsw.CoefficientsShared.apply(p, perm, wn, x), (ps, xi))
        assert {"shared", "shared_grad"} == set(calls)
    else:
        ps = torch.randn(b * c, n, generator=gen, dtype=torch.float64).requires_grad_()
        ws = wn.repeat_interleave(c, 0)
        assert torch.autograd.gradcheck(lambda p, x: fsw.CoefficientsPW.apply(p, ws, x), (ps, xi))
        assert {"rows", "rows_grad"} == set(calls)


@pytest.mark.parametrize("shared", [False, True])
def test_autograd_functions_mark_the_span_under_autograd_only(monkeypatch, shared):
    calls = []
    _fake_kernels(monkeypatch, calls)
    c, n, b = 4, 9, 2
    ps = torch.randn(c if shared else b * c, n)
    wn = torch.rand(b, n)
    wn /= wn.sum(-1, keepdim=True)
    xi = torch.arange(c, dtype=torch.float32)
    perm = torch.stack([torch.randperm(n) for _ in range(c)]).int()

    def run(p, x):
        return (fsw.CoefficientsShared.apply(p, perm, wn, x) if shared
                else fsw.CoefficientsPW.apply(p, wn.repeat_interleave(c, 0), x))

    with phases.collect() as stats, torch.no_grad():
        assert run(ps, xi).shape == (b, c)
    assert stats == {}
    p, x = ps.clone().requires_grad_(), xi.clone().requires_grad_()
    with phases.collect() as stats:
        run(p, x).sum().backward()
    assert "fsw.exact.coefficients" in stats and len(calls) == 3
    assert p.grad is not None and x.grad is not None
    # B x C x N coefficients each way: every item's weights over the shared
    # order, or the B*C rows of the per-genome sort
    assert stats[fsw.COEFFICIENTS_FORWARD] == stats[fsw.COEFFICIENTS_BACKWARD] == b * c * n


def test_cpu_exact_forwards_launch_nothing():
    """On the CPU both exact forwards run the plain chain under autograd: no
    kernel entry point is called and no coefficient span marked."""
    gen = torch.Generator().manual_seed(4)
    launches = exact_coefficients.launches
    for k, x in ((3, torch.rand(3, fsw.canonical_vocab_size(3), generator=gen)),
                 (5, torch.cat([torch.randint(0, 4, (3, 40, 5), generator=gen).float(),
                                torch.rand(3, 40, 1, generator=gen)], -1))):
        model = fsw.init_fsw_dist_embed_(fsw.FSWDistEmbed(k, 2, 8, 16, 4), gen)
        with phases.collect() as stats:
            model(x, 4).sum().backward()
        assert "fsw.exact.sort" in stats and "fsw.exact.coefficients" not in stats
    assert exact_coefficients.launches == launches


def test_scratch_and_tile():
    assert EXACT_SHARED_TILE == 512 and PERGENOME_TILE == 4096
    # fsw_k10.train_exact's chunk: 512 rows of 158 tiles, a double and a float each
    assert exact_rows_scratch_bytes(512, 646_000) == 12 * 512 * 158


def _good_rows(device="cpu"):
    b, c, n = 2, 3, 40
    return {"ps": torch.zeros(b * c, n, device=device), "ws": torch.zeros(b * c, n, device=device),
            "freqs": torch.zeros(c, device=device)}


def _good_shared(device="cpu"):
    c, v, n = 3, 40, 2
    return {"ps": torch.zeros(c, v, device=device),
            "perm": torch.zeros(c, v, dtype=torch.int32, device=device),
            "wn": torch.zeros(n, v, device=device), "freqs": torch.zeros(c, device=device)}


BAD_ROWS = {
    "ps float64": ("ps", lambda t: t.double()),
    "ws float64": ("ws", lambda t: t.double()),
    "freqs float64": ("freqs", lambda t: t.double()),
    "ws strided": ("ws", lambda t: torch.zeros(t.shape[0], 2 * t.shape[1])[:, ::2]),
    "ws one column short": ("ws", lambda t: t[:, :-1].contiguous()),
    "rows not a multiple of C": ("freqs", lambda t: torch.zeros(4)),
    "ps 3-D": ("ps", lambda t: t[None]),
    "freqs 2-D": ("freqs", lambda t: t[None]),
    "ws on another device": ("ws", lambda t: t.to("meta")),
}
BAD_SHARED = {
    "ps float64": ("ps", lambda t: t.double()),
    "perm int64": ("perm", lambda t: t.long()),
    "wn float64": ("wn", lambda t: t.double()),
    "perm strided": ("perm", lambda t: torch.zeros(t.shape[0], 2 * t.shape[1],
                                                   dtype=t.dtype)[:, ::2]),
    "perm one row short": ("perm", lambda t: t[:-1].contiguous()),
    "wn one column short": ("wn", lambda t: t[:, :-1].contiguous()),
    "freqs one short": ("freqs", lambda t: t[:-1].contiguous()),
    "no items": ("wn", lambda t: t[:0]),
    "wn on another device": ("wn", lambda t: t.to("meta")),
}


@pytest.mark.parametrize("case", sorted(BAD_ROWS))
def test_rows_wrappers_refuse(monkeypatch, case):
    """Each refusal before the library loads (none is built here); forward
    and backward."""
    monkeypatch.setattr(refresh, "_lib", lambda: pytest.fail("the library was loaded"))
    args = _good_rows()
    name, change = BAD_ROWS[case]
    args[name] = change(args[name])
    with pytest.raises(ValueError):
        exact_coefficients(**args)
    with pytest.raises(ValueError):
        exact_coefficients_grad(**args, tile_sums=torch.zeros(6, 1, dtype=torch.float64),
                                grad=torch.zeros(2, 3))


@pytest.mark.parametrize("case", sorted(BAD_SHARED))
def test_shared_wrappers_refuse(monkeypatch, case):
    monkeypatch.setattr(refresh, "_lib", lambda: pytest.fail("the library was loaded"))
    args = _good_shared()
    name, change = BAD_SHARED[case]
    args[name] = change(args[name])
    with pytest.raises(ValueError):
        exact_coefficients_shared(**args)
    with pytest.raises(ValueError):
        exact_coefficients_shared_grad(**args, grad=torch.zeros(2, 3))


def test_wrappers_refuse_a_cpu_tensor_and_a_wrong_cotangent(monkeypatch):
    """The kernels run on the card alone: a CPU input raises rather than
    falling back to the plain version; so do a cotangent or tile sums of the
    wrong shape."""
    monkeypatch.setattr(refresh, "_lib", lambda: pytest.fail("the library was loaded"))
    with pytest.raises(ValueError, match="cuda"):
        exact_coefficients(**_good_rows())
    with pytest.raises(ValueError, match="cuda"):
        exact_coefficients_shared(**_good_shared())
    rows = {name: t.to("meta") for name, t in _good_rows().items()}
    with pytest.raises(ValueError, match="grad"):
        exact_coefficients_grad(**rows, tile_sums=torch.zeros(6, 1, dtype=torch.float64,
                                                              device="meta"),
                                grad=torch.zeros(3, 3, device="meta"))
    with pytest.raises(ValueError, match="grad"):
        exact_coefficients_grad(**rows, tile_sums=torch.zeros(6, 2, dtype=torch.float64,
                                                              device="meta"),
                                grad=torch.zeros(2, 3, device="meta"))
    shared = {name: t.to("meta") for name, t in _good_shared().items()}
    with pytest.raises(ValueError, match="grad"):
        exact_coefficients_shared_grad(**shared, grad=torch.zeros(3, 3, device="meta"))
