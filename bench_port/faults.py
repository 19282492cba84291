"""Faults planted under the timed path, for the checks that ``correct``
catches them (``tests/test_bench_port_faults.py`` on the CPU, ``control.py --fault``
on the card). Each is a context manager that patches the port for its
duration.

- ``stale_step``: the optimizer's step returns the parameters unchanged;
- ``half_batch``: a batch's loss leaves out its second half and takes the
  mean over the rest.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, attr: str, value):
    old = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, old)


def stale_step():
    return _patched(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch():
    from kf2vecfsw_tpu_torch.train import step

    loss = step._distance_batch_loss

    def half(emb, dist, idx, weight_offset):
        h = max(emb.shape[0] // 2, 1)
        return loss(emb[:h], dist, idx[:h], weight_offset)

    return _patched(step, "_distance_batch_loss", half)


FAULTS = {"stale_step": stale_step, "half_batch": half_batch}
