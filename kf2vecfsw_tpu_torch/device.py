"""Device resolution shared by every entry point of the port.

The default is the card. The CPU is used only when the caller asks for it
(``device="cpu"``, the tests and the ``-device cpu`` flag); asking for the
card on a machine without one raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch

# Full fp32 everywhere: the tolerances the tests and chip_smoke.py state
# (rtol 1e-4 on classify/query outputs) assume fp32 products, and TF32
# keeps only ~3 decimal digits. Matmuls already default to fp32; cuDNN
# convolutions do not, so both flags are pinned.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``"cuda"`` (default) or ``"cpu"`` -> torch.device; raises when the card
    is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was requested but no CUDA device is available; "
                "pass device='cpu' (CLI: -device cpu) to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def device_line(dev: torch.device) -> str:
    """The ``Backend:`` line of a trainer's run log."""
    if dev.type == "cuda":
        return f"Backend: {dev.type} ({torch.cuda.get_device_name(dev)})"
    return f"Backend: {dev.type}"
