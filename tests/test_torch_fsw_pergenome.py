"""The per-genome lazy FSW route at k = 10 against the benchmark's plain
float64 reference (``bench_port/reference/pergenome.py``) and against
the torch route its refresh replaced, and the refresh's counters
(``utils.phases.count``).

Small widths on the CPU: k = 10 (the canonical vocabulary past the shared
route), base_dim 2, 16 slices, hidden 32, embedding 16, point sets of a few
hundred k-mers drawn from the k = 10 vocabulary and padded as the trainer
pads them."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from bench_port.reference import kmers as ref_kmers
from bench_port.reference import models as ref_models
from bench_port.reference.pergenome import PerGenomeLazy
from kf2vecfsw_tpu_torch.kernels.refresh import (
    delta_and_gdelta,
    pergenome_planes,
    refresh_groups,
)
from kf2vecfsw_tpu_torch.kernels.sort import sort_rows, unsort
from kf2vecfsw_tpu_torch.kmer.vocab import canonical_vocab_size
from kf2vecfsw_tpu_torch.models import fsw as fsw_model
from kf2vecfsw_tpu_torch.models.fsw import (
    FSWDistEmbed,
    fsw_lazy_refresh_pergenome,
    init_fsw_dist_embed_,
    lookup_points,
    shared_vocab_applicable,
)
from kf2vecfsw_tpu_torch.train import step
from kf2vecfsw_tpu_torch.train.distance import pad_point_sets
from kf2vecfsw_tpu_torch.train.fsw_lazy import LazyPlanes, lazy_distance_epoch
from kf2vecfsw_tpu_torch.train.step import make_adam
from kf2vecfsw_tpu_torch.utils import phases

K, BASE_DIM, C, HIDDEN, EMBED = 10, 2, 16, 32, 16


def point_sets(seed: int, sizes: list[int]) -> list[np.ndarray]:
    """get_kmers-layout (N_i, k+1) float32 matrices: distinct k = 10 k-mers in
    vocab order, frequencies normalised."""
    rng = np.random.default_rng(seed)
    digits = ref_kmers.vocab_digits(K)
    out = []
    for n in sizes:
        rows = np.sort(rng.choice(len(digits), n, replace=False))
        counts = rng.integers(1, 50, n).astype(np.float64)
        out.append(np.column_stack([digits[rows], counts / counts.sum()]).astype(np.float32))
    return out


LAYOUT = (("lookup", "lookup", False), ("fsw/slices", "slices", False),
          ("fsw/freqs", "freqs", False), ("fc1/w", "fc1.weight", True),
          ("fc1/b", "fc1.bias", False), ("fc2/w", "fc2.weight", True),
          ("fc2/b", "fc2.bias", False))  # (reference leaf, parameter, stored transposed)


def layout(model, get=lambda p: p) -> dict[str, torch.Tensor]:
    """``get(parameter)`` of every parameter in the reference's layout."""
    out = {}
    for name, attr, transposed in LAYOUT:
        v = get(model.get_parameter(attr)).detach()
        out[name] = (v.T if transposed else v).clone().contiguous()
    return out


def model_and_params(seed: int):
    model = init_fsw_dist_embed_(FSWDistEmbed(K, BASE_DIM, C, HIDDEN, EMBED),
                                 torch.Generator().manual_seed(seed))
    return model, layout(model)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_k10_takes_the_per_genome_route():
    mats = point_sets(0, [300, 120])
    assert not shared_vocab_applicable(K, pad_point_sets(mats).shape[1], 16)


@pytest.mark.parametrize("group", [1, 3])
def test_refresh_planes_match_the_reference(group):
    """S and g2 of ``fsw_lazy_refresh_pergenome`` on padded point sets
    against the reference on the unpadded ones."""
    mats = point_sets(1, [300, 57, 211, 128, 9])
    x = torch.from_numpy(pad_point_sets(mats))
    assert x.shape[1] > 300  # every item carries padding rows
    model, p = model_and_params(2)
    s, g2 = fsw_lazy_refresh_pergenome(model.slices, model.freqs, model.lookup, x, group)
    ref = PerGenomeLazy([torch.from_numpy(m) for m in mats], torch.device("cpu"))
    ref.refresh({k: v.double() for k, v in p.items()})
    for i in range(len(mats)):
        s_ref, g2_ref = ref.plane(i)
        # float32 projections, prefix sums and cos/sinc over at most 300 points
        # against float64: about 1e-6 relative; 2e-5 leaves room for a near-tie
        # of two projections that float32 orders the other way
        assert rel(s[i], s_ref) < 2e-5, i
        assert rel(g2[i], g2_ref) < 2e-5, i


def _parent_refresh(slices, freqs, lookup, x, group):
    """The per-genome refresh as its torch ops ran before its planes moved to
    ``kernels.refresh.pergenome_planes``: per group the sort, the jvp, the
    row sum, the unsort and the one-hot product."""
    n, npts, kp1 = x.shape
    k, c = kp1 - 1, slices.shape[0]
    s_out, g2_out = [], []
    for rows in refresh_groups(n, group):
        km = x[rows, :, :k].long()
        g = km.shape[0]
        keys = torch.einsum("cd,gnd->gcn", slices, lookup_points(lookup, km)).reshape(g * c, npts)
        ps, ws, perm = sort_rows(keys.contiguous(), fsw_model._normalized(x[rows, :, -1]))
        ps, ws, perm = ps.view(g, c, npts), ws.view(g, c, npts), perm.view(g, c, npts)
        delta, gdelta = delta_and_gdelta(ws, freqs, (1, -1, 1))
        g2_out.append(torch.sum(ps * gdelta, dim=-1))
        onehot = F.one_hot(km, 4).reshape(g, npts, 4 * k).to(torch.float32)
        s_out.append(torch.bmm(unsort(delta, perm), onehot))
    return torch.cat(s_out).reshape(n, c, k, 4), torch.cat(g2_out)


@pytest.mark.parametrize("group", [1, 3])
def test_refresh_equals_the_plain_route_it_replaced(group):
    """On the CPU the refresh through ``pergenome_planes`` is the torch route
    it replaced, bit for bit, on ``test_refresh_planes_match_the_reference``'s
    point sets, and launches no kernel."""
    x = torch.from_numpy(pad_point_sets(point_sets(1, [300, 57, 211, 128, 9])))
    model, _ = model_and_params(2)
    args = (model.slices.detach(), model.freqs.detach(), model.lookup.detach(), x, group)
    launches = pergenome_planes.launches
    s, g2 = fsw_lazy_refresh_pergenome(*args)
    with torch.no_grad():
        s_ref, g2_ref = _parent_refresh(*args)
    assert torch.equal(s, s_ref) and torch.equal(g2, g2_ref)
    assert pergenome_planes.launches == launches


def test_padding_adds_nothing_to_the_reference():
    mats = point_sets(3, [40, 17])
    padded = pad_point_sets(mats)
    _, p = model_and_params(4)
    p = {k: v.double() for k, v in p.items()}
    planes = []
    for sets in ([torch.from_numpy(m) for m in mats], [torch.from_numpy(m) for m in padded]):
        ref = PerGenomeLazy(sets, torch.device("cpu"))
        ref.refresh(p)
        planes.append([ref.plane(i) for i in range(2)])
    for (s_a, g_a), (s_b, g_b) in zip(*planes):
        # padding rows sort among the real ones with weight 0: only the
        # summation order of the real rows' products may move
        assert torch.allclose(s_a, s_b, rtol=1e-12, atol=1e-15)
        assert torch.allclose(g_a, g_b, rtol=1e-12, atol=1e-15)


def program_steps(mats, dist, batches, lr, refresh_steps):
    """The port's lazy per-genome steps, one batch a call: the parameters
    before each step, each step's loss and embeddings, and the first
    gradient (Adam's first moment after one step over 1 - beta1)."""
    model, _ = model_and_params(5)
    opt = make_adam(model, lr)
    planes = LazyPlanes(torch.from_numpy(pad_point_sets(mats)), False, refresh_steps, 4, group=2)
    params, embs, losses = [], [], []
    batch_loss = step._distance_batch_loss

    def recorded(emb, *args):
        embs.append(emb.detach().double())
        return batch_loss(emb, *args)

    step._distance_batch_loss = recorded
    try:
        for i, idx in enumerate(batches):
            params.append(layout(model))
            losses.append(float(lazy_distance_epoch(model, opt, planes, dist, idx, len(idx))))
            if i == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                grad1 = layout(model, lambda p: opt.state[p]["exp_avg"] / (1 - beta1))
    finally:
        step._distance_batch_loss = batch_loss
    assert planes.refreshes == 2  # before step 0 and before step 2
    return params, losses, embs, grad1


def test_three_lazy_steps_across_a_refresh_match_the_reference():
    """Steps 0 and 2 follow a refresh (an interval of 2 steps); step 1 runs
    on the order frozen at step 0's parameters. The reference takes each
    step at the parameters the program held before it, so that each step's
    gap is the lazy route's own: from the same start, Adam's first steps
    move every entry whose gradient is rounding noise (a bias that the loss
    of differences cancels) by a whole learning rate on the program's side
    and not at all on the reference's."""
    mats = point_sets(6, [150, 90, 230, 60, 120, 200, 75, 180, 40, 260, 110, 95])
    rng = np.random.default_rng(7)
    d = rng.uniform(0.05, 0.6, (12, 12))
    dist = torch.from_numpy(((d + d.T) / 2 * (1 - np.eye(12))).astype(np.float32))
    batches = [torch.tensor(b) for b in ([3, 0, 7, 10], [1, 5, 11, 2], [8, 4, 9, 6])]
    lr = 1e-3  # large enough that step 2's refresh sorts by moved parameters
    params, losses, embs, grad1 = program_steps(mats, dist, batches, lr, 2)
    assert rel(params[2]["fsw/slices"], params[0]["fsw/slices"]) > 1e-4
    ref = PerGenomeLazy([torch.from_numpy(m) for m in mats], torch.device("cpu"))
    for s, idx in enumerate(batches):
        p = {k: v.double().requires_grad_(s == 0) for k, v in params[s].items()}
        if s in (0, 2):
            ref.refresh(p)
        emb = ref.embed(p, idx)
        loss = ref_models.distance_loss(emb, dist.double()[idx][:, idx])
        # float32 planes, MLP and pairwise distances against float64: about
        # 1e-7 relative
        assert abs(losses[s] - loss.item()) / loss.item() < 1e-5, s
        assert rel(embs[s], emb.detach()) < 1e-5, s
        if s == 0:
            want = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        # float32 backward against float64; an entry that the loss cancels
        # (fc2's bias under a loss of differences) is rounding around 0, so
        # the absolute part is a share of the largest entry of any leaf
        torch.testing.assert_close(grad1[name].double(), g, rtol=1e-4, atol=1e-6 * scale,
                                   msg=name)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_count_under_collect_and_without():
    assert phases._active is None
    phases.count("x", 3)  # no collector: nothing to add to, nothing raised
    with phases.collect() as stats:
        phases.count("x", 2)
        phases.count("x", 5)
        phases.count("y")
    assert stats == {"x": 7, "y": 1}
    phases.count("x", 1)
    assert stats == {"x": 7, "y": 1} and phases._active is None


def test_count_adds_no_device_op(monkeypatch):
    """A count is host arithmetic: no op, no fetch, no synchronise."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: pytest.fail("synchronised"))
    with phases.collect(), _Ops() as mode:
        phases.count("x", 4)
    assert mode.ops == []


@pytest.mark.parametrize("shared", [False, True])
def test_refresh_counters_match_the_point_sets(shared):
    mats = point_sets(8, [120, 33, 77])
    x = torch.from_numpy(pad_point_sets(mats))
    feats = x
    if shared:  # (n, V) weights over the k = 3 vocabulary
        feats = torch.rand(3, canonical_vocab_size(3), generator=torch.Generator().manual_seed(9))
    model = init_fsw_dist_embed_(FSWDistEmbed(3 if shared else K, BASE_DIM, C, HIDDEN, EMBED),
                                 torch.Generator().manual_seed(10))
    planes = LazyPlanes(feats, shared, 4, 1, group=2)
    planes.refresh(model)  # one-time work (the shared route's cached vocab digits)
    with _Ops() as quiet:
        planes.refresh(model)  # no collector: the refresh's own ops
    with phases.collect() as stats, _Ops() as counted:
        planes.refresh(model)
        planes.refresh(model)
    assert counted.ops == quiet.ops * 2  # the counters add no op, no fetch
    assert stats["fsw.refresh.items"] == 2 * 3
    if shared:
        assert "fsw.refresh.points" not in stats and "fsw.refresh.slots" not in stats
    else:
        assert stats["fsw.refresh.points"] == 2 * sum(len(m) for m in mats)
        assert stats["fsw.refresh.slots"] == 2 * 3 * x.shape[1]
