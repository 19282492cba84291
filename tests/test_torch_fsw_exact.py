"""The exact FSW training routes (``-fsw_lazy_refresh 0``, a sort at every
step, as kf2vecFSW trains NeuralNetFSW) against the benchmark's plain
float64 reference (``bench_port/reference/exact.py``), the checkpointed
slice chunks against the unchunked forward, the exact forwards' counters
(``utils.phases.count``: slots and coefficients) and the training chunk's
memory count.

Small widths on the CPU: the shared-vocab route at k = 3 and at k = 9 (V =
131,072), the per-genome route at k = 10 (past the shared gate), base_dim
2, 16 slices, hidden 32, embedding 16. The card-only tests at the end run
the per-genome layer at ``fsw_k10.train_exact``'s shape and the shared one
at ``fsw_k9.train_exact``'s (skip without a card)."""

import numpy as np
import pytest
import torch

from bench_port.reference import kmers as ref_kmers
from bench_port.reference import models as ref_models
from bench_port.reference.exact import ExactFSW
from kf2vecfsw_tpu_torch.kernels.sort import CLUSTER_ELEMS
from kf2vecfsw_tpu_torch.kmer.vocab import canonical_vocab_size
from kf2vecfsw_tpu_torch.models import fsw as fsw_model
from kf2vecfsw_tpu_torch.models.fsw import FSWDistEmbed, init_fsw_dist_embed_
from kf2vecfsw_tpu_torch.train.distance import pad_point_sets
from kf2vecfsw_tpu_torch.train.step import distance_epoch, make_adam
from kf2vecfsw_tpu_torch.utils import phases

from .test_torch_fsw_pergenome import _Ops, layout, point_sets, rel

K_SHARED, K, BASE_DIM, C, HIDDEN, EMBED = 3, 10, 2, 16, 32, 16
GIB = 1 << 30


def vocab_weights(seed: int, n: int) -> torch.Tensor:
    """(n, V) k = 3 vocab weights, a few k-mers absent from each genome."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.rand(n, canonical_vocab_size(K_SHARED), generator=gen)
    return torch.where(torch.rand(w.shape, generator=gen) < 0.2, 0.0, w)


def true_dist(seed: int, n: int) -> torch.Tensor:
    d = np.random.default_rng(seed).uniform(0.05, 0.6, (n, n))
    return torch.from_numpy(((d + d.T) / 2 * (1 - np.eye(n))).astype(np.float32))


def program_steps(k: int, feats: torch.Tensor, dist, batches, lr: float):
    """The port's exact steps, one batch a ``distance_epoch`` call: the
    parameters before the first, each step's loss, the first gradient
    (Adam's first moment over 1 - beta1) and the change after the last."""
    model = init_fsw_dist_embed_(FSWDistEmbed(k, BASE_DIM, C, HIDDEN, EMBED),
                                 torch.Generator().manual_seed(5))
    params0 = layout(model)
    opt = make_adam(model, lr)
    losses = []
    for i, idx in enumerate(batches):
        losses.append(float(distance_epoch(model, opt, feats, dist, idx, len(idx))))
        if i == 0:
            beta1 = opt.param_groups[0]["betas"][0]
            grad1 = layout(model, lambda p: opt.state[p]["exp_avg"] / (1 - beta1))
    change = {name: v - params0[name] for name, v in layout(model).items()}
    return params0, losses, grad1, change


def assert_steps_match(prog, items, dist, batches, lr):
    params0, losses, grad1, change = prog
    ref = ref_models.train_steps(params0, ExactFSW(items, torch.device("cpu")).embed,
                                 dist.double(), batches, lr)
    for got, want in zip(losses, ref["losses"]):
        # float32 projections, prefix sums and MLP against float64: about 1e-7
        assert abs(got - want) / want < 1e-5
    scale = max(float(g.abs().max()) for g in ref["grad1"].values())
    for name, g in ref["grad1"].items():
        # float32 against float64, cos(pi xi cbar) multiplying the prefix
        # sums' rounding by up to pi xi (xi < 16): about 2e-6 of the largest
        # entry; an entry the loss cancels (fc2's bias under a loss of
        # differences) is rounding around 0, hence the absolute part
        torch.testing.assert_close(grad1[name].double(), g, rtol=1e-4, atol=1e-5 * scale,
                                   msg=name)
    for name in ("lookup", "fsw/slices", "fsw/freqs", "fc1/w"):
        # Adam's steps are about lr a live entry after 3 steps: their norms
        assert rel(change[name], ref["change"][name]) < 1e-3, name


BATCHES = [torch.tensor(b) for b in ([3, 0, 7, 10], [1, 5, 11, 2], [8, 4, 9, 6])]
# the configurations' rate: in 3 steps no entry whose gradient is rounding
# noise moves as far as a live one
LR = 1e-5


def test_exact_shared_steps_match_the_reference():
    """The shared-vocab route's steps on (n, V) weights against the
    reference on each genome's own present k-mers."""
    w = vocab_weights(1, 12)
    dist = true_dist(2, 12)
    prog = program_steps(K_SHARED, w, dist, BATCHES, LR)
    digits = torch.from_numpy(ref_kmers.vocab_digits(K_SHARED))
    items = [(digits[row > 0], row[row > 0]) for row in w]
    assert_steps_match(prog, items, dist, BATCHES, LR)


def test_exact_pergenome_steps_match_the_reference():
    """The per-genome route's steps on padded k = 10 point sets against the
    reference on the unpadded ones."""
    mats = point_sets(6, [150, 90, 230, 60, 120, 200, 75, 180, 40, 260, 110, 95])
    x = torch.from_numpy(pad_point_sets(mats))
    assert x.shape[1] > 260  # every item carries padding rows
    dist = true_dist(7, 12)
    prog = program_steps(K, x, dist, BATCHES, LR)
    items = [(torch.from_numpy(m[:, :-1]).long(), torch.from_numpy(m[:, -1])) for m in mats]
    assert_steps_match(prog, items, dist, BATCHES, LR)


def test_exact_shared_steps_match_the_reference_at_k9():
    """The shared-vocab route at k = 9, upstream's largest canonical
    vocabulary (V = 131,072, ``fsw_k9.train_exact``'s), at small widths:
    the steps on (n, V) weights against the reference on each genome's own
    present k-mers. The genomes are the benchmark's kind (``bench_port``'s
    ``genome_counts``: 200-400 kb, GC content 0.3-0.7, 66k-120k k-mers
    present), whose embeddings differ as real genomes' do: with the same
    uniform weights over 131,072 k-mers (``vocab_weights``) every genome's E
    is nearly the mean one, and the loss's differences of embeddings
    magnify E's float32 rounding into the gradients (4e-4 of their norm,
    against 5e-6 at k = 3). The tolerances are ``assert_steps_match``'s:
    the frequencies stay under 16 (C = 16), so the phase multiplies the
    prefix sums' rounding no more than at k = 3, and the CPU's scan and E's
    sums over V positions add little (here the losses read 2.4e-7 of the
    reference's, the gradients 3.3e-6 of the largest entry, the changes
    1.1e-4 of their norms)."""
    from bench_port import inputs

    k, n = 9, 12
    gen = torch.Generator().manual_seed(12)
    gc = np.random.default_rng(3).permutation(np.linspace(0.3, 0.7, n))
    lengths = np.linspace(200_000, 400_000, n).round().astype(np.int64)
    counts = inputs.genome_counts(gen, k, gc, lengths, torch.device("cpu"))
    w = (counts / counts.sum(dim=1, keepdim=True)).float()
    dist = true_dist(13, n)
    assert fsw_model.shared_vocab_applicable(k, int((w > 0).sum(dim=1).max()), len(BATCHES[0]))
    prog = program_steps(k, w, dist, BATCHES, LR)
    digits = torch.from_numpy(ref_kmers.vocab_digits(k))
    items = [(digits[row > 0], row[row > 0]) for row in w]
    assert_steps_match(prog, items, dist, BATCHES, LR)


def _forward_and_grads(model, x, slice_chunk):
    model.zero_grad(set_to_none=True)
    out = model(x, slice_chunk)
    out.backward(torch.linspace(-1, 1, out.numel()).view_as(out))
    return out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_chunked_forward_equals_the_unchunked_one():
    """The per-genome forward in chunks of 8 of its 16 slices, each
    recomputed under ``checkpoint`` in the backward, against all slices at
    once: the same values and gradients to float32 rounding (each slice's
    sort and sums are its own; only the products' blocking may differ)."""
    x = torch.from_numpy(pad_point_sets(point_sets(3, [300, 57, 211, 128])))
    model = init_fsw_dist_embed_(FSWDistEmbed(K, BASE_DIM, C, HIDDEN, EMBED),
                                 torch.Generator().manual_seed(4))
    out0, grads0 = _forward_and_grads(model, x, 0)
    out8, grads8 = _forward_and_grads(model, x, 8)
    torch.testing.assert_close(out8, out0, rtol=1e-6, atol=1e-7)
    for name, g in grads0.items():
        assert rel(grads8[name], g) < 1e-6, name


@pytest.mark.parametrize("shared,chunk,resorted", [(False, 0, 0), (False, 8, 100),
                                                   (True, 0, 0), (True, 8, 100)])
def test_exact_counters_by_hand(shared, chunk, resorted):
    """``fsw.exact.slots`` adds every exact sort's R x N under autograd: a
    forward's B x C x N per genome (padding included) or C x V shared, and as
    much again (``resorted`` %) where the chunks are recomputed in the
    backward. ``fsw.exact.coefficients.forward`` adds every coefficient
    call's B x C x N (per genome, the rows the sort gave) or B x C x V
    (shared: every item's weights over the one order), the recompute's
    included, and ``.backward`` as much once. Inference counts nothing."""
    if shared:
        x = vocab_weights(8, 3)
        once = C * x.shape[1]
        coefficients = 3 * once
    else:
        x = torch.from_numpy(pad_point_sets(point_sets(8, [120, 33, 77])))
        once = coefficients = 3 * C * x.shape[1]
    model = init_fsw_dist_embed_(FSWDistEmbed(K_SHARED if shared else K, BASE_DIM, C, HIDDEN,
                                              EMBED), torch.Generator().manual_seed(9))
    with phases.collect() as stats:
        model(x, chunk).sum().backward()
    assert stats["fsw.exact.slots"] == once * (100 + resorted) // 100
    assert stats[fsw_model.COEFFICIENTS_FORWARD] == coefficients * (100 + resorted) // 100
    assert stats[fsw_model.COEFFICIENTS_BACKWARD] == coefficients
    with phases.collect() as stats, torch.no_grad():
        model(x, chunk)  # inference (an export, a query): nothing marked or counted
    assert stats == {}
    for p in model.parameters():
        p.requires_grad_(False)
    with phases.collect() as stats:
        model(x, chunk)  # frozen parameters under autograd: no step, nothing counted
    assert stats == {}


@pytest.mark.parametrize("shared", [False, True])
def test_exact_counters_add_no_device_op(shared):
    """The counts and spans are host work: a step under a collector runs the
    same ops as one without, and nothing synchronises."""
    x = (vocab_weights(10, 3) if shared
         else torch.from_numpy(pad_point_sets(point_sets(10, [80, 41, 60]))))
    model = init_fsw_dist_embed_(FSWDistEmbed(K_SHARED if shared else K, BASE_DIM, C, HIDDEN,
                                              EMBED), torch.Generator().manual_seed(11))
    model(x, 8).sum().backward()  # one-time work (the shared route's cached vocab digits)
    with _Ops() as quiet:
        model(x, 8).sum().backward()
    with phases.collect() as stats, _Ops() as counted:
        model(x, 8).sum().backward()
    assert counted.ops == quiet.ops
    assert "fsw.exact.slots" in stats and "fsw.exact.sort" in stats
    assert "fsw.exact.unsort" in stats


def test_auto_slice_chunk_counts_the_training_backward(monkeypatch):
    """Under autograd a chunk's backward holds TRAIN_SLICE_BUFFERS f32
    buffers of its (B*c, N), 68 B an element, against the sort's 24 (16
    below the radix path), in 3/8 of the card rather than 1/8: on a card of
    80 GiB the chunks at the published shapes are those of the sort's count
    but for k = 9's shared vocabulary (3.4x the cluster path's bytes), and
    the training chunk's bytes stay under 3/8 of the card."""
    monkeypatch.setenv("KF2VEC_HBM_BYTES", str(80 * GIB))
    b, n = 16, 646_000
    assert fsw_model.TRAIN_SLICE_BUFFERS == 17
    assert fsw_model.slice_train_bytes(b, n) == 68 * b * n == 702_848_000
    assert fsw_model.slice_sort_bytes(b, n) == 249_751_808
    assert fsw_model.fsw_train_budget_bytes("cpu") == 30 * GIB
    # fsw_k10.train_exact: 45.8 training slices fit, 43.0 of the sort's
    assert fsw_model.auto_slice_chunk(b, n, 512, "cpu") == 32
    assert fsw_model.auto_slice_chunk(b, n, 512, "cpu", training=True) == 32
    # the shared vocabularies at k = 7, 8 and 9 (fsw_k7.train_exact: all slices)
    for v, sort_chunk, train_chunk in ((8192, 0, 0), (32_896, 0, 0), (131_072, 256, 128)):
        assert fsw_model.auto_slice_chunk(b, v, 512, "cpu") == sort_chunk
        assert fsw_model.auto_slice_chunk(b, v, 512, "cpu", training=True) == train_chunk
    for bb, nn_ in ((16, 131_072), (16, 646_000), (16, 1_100_000), (64, 32_896), (1, 646_000)):
        chunk = fsw_model.auto_slice_chunk(bb, nn_, 512, "cpu", training=True) or 512
        assert chunk * fsw_model.slice_train_bytes(bb, nn_) <= 30 * GIB or chunk == 8
    # below the radix path the sort's 16 B an element never pass the backward's
    assert fsw_model.slice_train_bytes(b, 131_072) == 68 * b * 131_072


def test_training_chunk_peaks_at_its_count(monkeypatch):
    """The live tensors of a sliced forward and its backward (the sort as
    the card's launch allocates it) peak at the chunks' count: the chunk's
    ``slice_train_bytes``, beside the weight rows and the points' gradient
    (B x N x d_in f32)."""
    # imported here: that module imports the JAX package, which the card's
    # machine lacks, and this file's card test runs there
    from .test_torch_fsw_budget import SMALL, LiveBytes, _card_like_sort

    monkeypatch.setattr(fsw_model, "sort_rows", _card_like_sort)
    b, c, n, chunk, d_in = 2, 16, 131_073, 8, K * 4
    gen = torch.Generator().manual_seed(n)
    points = torch.randn(b, n, d_in, generator=gen).requires_grad_(True)
    w = torch.rand(b, n, generator=gen)
    slices = torch.randn(c, d_in, generator=gen).requires_grad_(True)
    freqs = torch.arange(c).float().requires_grad_(True)
    g = torch.randn(b, c, generator=gen)
    with LiveBytes(points, w, slices, freqs, g) as live:
        fsw_model.fsw_embed(slices, freqs, points, w, chunk).backward(g)
    counted = chunk * fsw_model.slice_train_bytes(b, n) + 4 * b * n + 4 * b * n * d_in
    assert counted - SMALL <= live.peak <= counted + SMALL


# -- on the card ----------------------------------------------------------------

CARD_B, CARD_N, CARD_C = 16, 646_000, 512  # fsw_k10.train_exact's batch
ALLOC_SLACK = 64 << 20  # the caching allocator rounds each block up to 2 MiB


@pytest.mark.cuda
def test_training_chunk_fits_its_count_on_the_card():
    """At fsw_k10.train_exact's shape (16 point sets padded to 646,000, 512
    slices, k = 10) the FSW layer's forward and backward, in the training
    chunks ``auto_slice_chunk`` picks, allocate no more than the chunk's
    ``slice_train_bytes`` beside the weight rows and the points' gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sort kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    d_in = K * 4
    chunk = fsw_model.auto_slice_chunk(CARD_B, CARD_N, CARD_C, dev, training=True)
    assert chunk >= 8

    def layer(n):
        points = torch.randn(CARD_B, n, d_in, generator=gen, device=dev).requires_grad_(True)
        w = torch.rand(CARD_B, n, generator=gen, device=dev)
        slices = torch.randn(CARD_C, d_in, generator=gen, device=dev).requires_grad_(True)
        freqs = torch.arange(CARD_C, device=dev, dtype=torch.float32).requires_grad_(True)
        g = torch.randn(CARD_B, CARD_C, generator=gen, device=dev)
        return points, w, slices, freqs, g

    # a small step first: the products' first use allocates cuBLAS's
    # workspace, which stays allocated and is no part of the chunk
    points, w, slices, freqs, g = layer(CLUSTER_ELEMS + 1)
    fsw_model.fsw_embed(slices, freqs, points, w, chunk).backward(g)
    points, w, slices, freqs, g = layer(CARD_N)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fsw_model.fsw_embed(slices, freqs, points, w, chunk).backward(g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counted = (chunk * fsw_model.slice_train_bytes(CARD_B, CARD_N) + 4 * CARD_B * CARD_N
               + 4 * CARD_B * CARD_N * d_in)
    assert peak <= counted + ALLOC_SLACK, (chunk, peak, counted)


K9_V = 131_072  # fsw_k9.train_exact: 16 items over k = 9's vocabulary, 512 slices


@pytest.mark.cuda
def test_shared_training_chunk_at_k9_fits_its_count_on_the_card():
    """At ``fsw_k9.train_exact``'s shape (16 weight rows over V = 131,072,
    512 slices, k = 9) the shared FSW layer's forward and backward, in the
    training chunks ``auto_slice_chunk`` picks (128 on an 80 GB card),
    allocate no more than the chunk's ``slice_train_bytes`` beside the
    weights and the points' gradient. The count is the CPU chain's (17 f32
    buffers of (B*c, V)); the card's kernels hold no (B, c, V) buffer, so
    the peak sits far below it (PERF.md, Open questions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sort kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    assert canonical_vocab_size(9) == K9_V
    d_in = 9 * 4
    chunk = fsw_model.auto_slice_chunk(CARD_B, K9_V, CARD_C, dev, training=True)
    assert 8 <= chunk < CARD_C

    def layer():
        points = torch.randn(K9_V, d_in, generator=gen, device=dev).requires_grad_(True)
        w = torch.rand(CARD_B, K9_V, generator=gen, device=dev)
        slices = torch.randn(CARD_C, d_in, generator=gen, device=dev).requires_grad_(True)
        freqs = torch.arange(CARD_C, device=dev, dtype=torch.float32).requires_grad_(True)
        g = torch.randn(CARD_B, CARD_C, generator=gen, device=dev)
        return points, w, slices, freqs, g

    # a first step: cuBLAS's workspace and the kernels' first launch
    points, w, slices, freqs, g = layer()
    fsw_model.fsw_embed_shared(slices, freqs, points, w, chunk).backward(g)
    points, w, slices, freqs, g = layer()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fsw_model.fsw_embed_shared(slices, freqs, points, w, chunk).backward(g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counted = (chunk * fsw_model.slice_train_bytes(CARD_B, K9_V) + 4 * CARD_B * K9_V
               + 4 * K9_V * d_in)
    assert peak <= counted + ALLOC_SLACK, (chunk, peak, counted)
