"""Profiling hook (the JAX package's ``utils/profiling.py``) on
``torch.profiler``.

With ``KF2VEC_PROFILE_DIR`` set, ``maybe_trace(tag, device)`` records the
region and writes a trace into ``<dir>/<tag>/`` through
``torch.profiler.tensorboard_trace_handler``: a Chrome trace JSON,
``<host>_<pid>.<ms>.pt.trace.json``, which Perfetto, chrome://tracing and
TensorBoard's profiler plugin open. Unset, the context does nothing and
imports nothing.

Activities: the host's ops, and on a CUDA device the card's too. Those come
from CUPTI, so they hold every kernel launched on the card's streams: the
library kernels behind torch ops and the port's own kernels
(``kernels/csrc``), which its wrappers launch through ``ctypes`` on torch's
current stream, each under its own ``__global__`` name.

The trace changes no result: the profiler records the ops as they run,
adds no synchronisation inside the region and reads no value; it
synchronises the card once, on leaving the region, to collect the events.
The distance trainer wraps its second epoch of each clade (the first pays
for first-call set-up), as the JAX trainer wraps its second epoch or span.
"""

from __future__ import annotations

import contextlib
import os

import torch

PROFILE_DIR_ENV = "KF2VEC_PROFILE_DIR"


@contextlib.contextmanager
def maybe_trace(tag: str, device: str | torch.device):
    profile_dir = os.environ.get(PROFILE_DIR_ENV)
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    target = os.path.join(profile_dir, tag)
    os.makedirs(target, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(target)):
        yield
