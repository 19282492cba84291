"""Device memory budgets (the port's copy of the JAX package's
``utils/membudget.py``).

Consumers take a fraction of the device's memory, so a ratio tuned on one
part scales with the part. The size is resolved in this order:

1. the ``KF2VEC_HBM_BYTES`` environment override (also how tests fake a
   device size),
2. on a CUDA device, its total memory (``torch.cuda.mem_get_info``),
3. on the CPU, the JAX package's 16 GiB fallback, so that CPU runs gate
   exactly as the JAX package's CPU runs do.
"""

from __future__ import annotations

import os

import torch

_FALLBACK_BYTES = 16 << 30


def device_hbm_bytes(device: str | torch.device) -> int:
    """Memory of ``device`` in bytes (see the module docstring)."""
    env = os.environ.get("KF2VEC_HBM_BYTES")
    if env:
        return int(env)
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return _FALLBACK_BYTES


def hbm_fraction(num: int, den: int, device: str | torch.device) -> int:
    """num/den of the device's memory, in bytes."""
    return device_hbm_bytes(device) * num // den
