"""Training window on the exact FSW route, shared vocab, with the exact
coefficient counters: ``train_exact``'s shared-vocab run (``SharedExact``),
whose window also keeps the program's counters
``fsw.exact.coefficients.forward`` and ``.backward`` (``models/fsw.py``:
every coefficient call's B x C x V under autograd, a chunk's recompute in
the backward included in the forward's) in ``records["counters"]`` beside
``fsw.exact.slots``; each is absent from a program that does not count it.

The traffic mix states ``train_exact``'s parameters. The run is the shared
route's alone: it raises where the trainer's gate
(``models/fsw.py`` ``shared_vocab_applicable``) takes the clade per genome.
The reference (``reference/exact.py``) reads each checked item's present
k-mers, made here when it reads them: all 850 at once would hold 8 GB of
int64 digits on the host at k = 9.
"""

from __future__ import annotations

import torch

from ..reference import kmers as ref_kmers
from . import train_exact, train_window

COUNTERS = train_exact.COUNTERS + ("fsw.exact.coefficients.forward",
                                   "fsw.exact.coefficients.backward")  # models/fsw.py


def Run(cfg: dict, mix: dict, seed: int, device: torch.device, tracer):
    from kf2vecfsw_tpu_torch.kmer.vocab import canonical_vocab_size
    from kf2vecfsw_tpu_torch.models.fsw import shared_vocab_applicable

    k, b = cfg["k"], cfg["batch_size"]
    if not shared_vocab_applicable(k, canonical_vocab_size(k), b):
        raise NotImplementedError("train_exact_counted runs the shared-vocab route only; the "
                                  "trainer's gate takes this clade per genome")
    return SharedExactCounted(cfg, mix, seed, device, tracer)


class PresentKmers:
    """Each genome's present k-mers as the reference reads them: item i is
    (digits (N_i, k) int64, counts (N_i,)) of the k-mers whose count is
    positive, ``SharedExact.items``' pairs made one at a time."""

    def __init__(self, digits: torch.Tensor, counts: torch.Tensor):
        self.digits, self.counts = digits, counts

    def __len__(self) -> int:
        return len(self.counts)

    def __getitem__(self, i: int):
        c = self.counts[i]
        present = c > 0
        return self.digits[present], c[present]


class SharedExactCounted(train_exact.SharedExact):
    def window(self, seconds: float) -> None:
        from kf2vecfsw_tpu_torch.utils import phases

        with phases.collect() as counters:
            train_window.Run.window(self, seconds)
        self.records["counters"] = {k: int(counters[k]) for k in COUNTERS if k in counters}

    def items(self):
        return PresentKmers(torch.from_numpy(ref_kmers.vocab_digits(self.cfg["k"])),
                            self.counts.cpu())
